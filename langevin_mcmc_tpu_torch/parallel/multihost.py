"""Multi-process rendering on torch.distributed: the distributed bootstrap
and the sharded render (port of parallel/multihost.py).

The reference is one machine whose threads share three things: the film
(atomic splats), the bootstrap reduction (one mutex) and the PSS cache
(one mutex a dimension). Across processes:

* chains are data-parallel over every shard of every process
  (parallel/mesh.py, parallel/shardmap_step.py);
* the film is one partial per shard, reduced ONCE at the end of the run;
  the caches are per group of shards, merged every MERGE_EVERY calls;
* the bootstrap normalization b and the path-length histogram are sums
  over every process (global_sum, in float64, in rank order) of its
  sample-count-weighted b and normalised histogram, as in the JAX
  package; chain seeds are resampled per process from its own samples.

Collectives: gloo for CPU ranks; NCCL for CUDA ranks when no two ranks
share a card (found after the rendezvous from every rank's host name and
card); gloo when ranks share a card, since NCCL refuses two ranks on one
card. Gloo's collectives run on host copies of CUDA tensors.

Run one process per rank with:
  python -m langevin_mcmc_tpu_torch scene.xml --coordinator host0:1234 \\
      --num-processes N --process-id i
"""

import dataclasses
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from ..integrators import mlt
from ..integrators.pathtrace import render_direct
from ..utils.distribution import Distribution1D
from ..utils.tree import tree_leaves, tree_map
from .mesh import make_chain_mesh, shard_chains
from .shardmap_step import (fold_seed, make_sharded_multi_step,
                            merge_caches, shard_generators)

MERGE_EVERY = 4     # outer calls between cache merges

_group = None       # the collectives' process group (None: the default)
_device = None      # this rank's device, set by init_distributed


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     device='cuda'):
    """Join the process group of num_processes ranks at coordinator
    (host:port). A no-op at one process (returns None); otherwise returns
    this rank's device: cuda:{process_id % cards} for device 'cuda', else
    device. Prints the backend the collectives take (module docstring)."""
    global _group, _device
    if num_processes is None or num_processes <= 1:
        return None
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for CPU "
                               "ranks")
        device = torch.device('cuda',
                              process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group('gloo', init_method=f'tcp://{coordinator}',
                            world_size=num_processes, rank=process_id)
    backend, why = 'gloo', 'CPU ranks'
    if device.type == 'cuda':
        seats = [None] * num_processes
        dist.all_gather_object(seats, (socket.gethostname(), device.index))
        if len(set(seats)) == num_processes:
            backend, why = 'nccl', 'one card a rank'
            _group = dist.new_group(backend='nccl')
        else:
            why = 'ranks share a card'
    _device = device
    print(f'distributed: rank {process_id} of {num_processes} on {device}; '
          f'collectives over {backend} ({why})', flush=True)
    return device


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device():
    """This rank's device (init_distributed's), else the card."""
    return _device if _device is not None else torch.device('cuda')


def backend():
    """The collectives' backend ('gloo' or 'nccl'), None without a
    process group."""
    return dist.get_backend(_group) if dist.is_initialized() else None


def _staged(t):
    """t as a collective takes it: gloo runs on a host copy of a CUDA
    tensor."""
    return t.cpu() if t.is_cuda and backend() == 'gloo' else t


def _all_gather(t):
    """[world, *t.shape] on t's device: every rank's t, in rank order."""
    src = _staged(t)
    out = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(out, src, group=_group)
    return torch.stack(out).to(t.device)


def all_reduce_sum(t):
    """Sum t over every rank, in place; returns t."""
    if not dist.is_initialized():
        return t
    src = _staged(t)
    dist.all_reduce(src, group=_group)
    if src is not t:
        t.copy_(src)
    return t


def all_reduce_min(t):
    """The least t over every rank, in place; returns t."""
    if not dist.is_initialized():
        return t
    src = _staged(t)
    dist.all_reduce(src, op=dist.ReduceOp.MIN, group=_group)
    if src is not t:
        t.copy_(src)
    return t


def all_gather_tree(tree):
    """Every rank's tree of [S, ...] tensors, concatenated along the first
    axis in rank order ([world * S, ...]). The leaves travel as one byte
    buffer: one collective a call."""
    if not dist.is_initialized():
        return tree
    leaves = tree_leaves(tree)
    buf = torch.cat([x.contiguous().reshape(-1).view(torch.uint8)
                     for x in leaves])
    got = _all_gather(buf)                       # [world, bytes]
    out, off = [], 0
    for x in leaves:
        nb = x.numel() * x.element_size()
        part = got[:, off:off + nb].contiguous().view(x.dtype)
        out.append(part.reshape((got.shape[0] * x.shape[0],)
                                + tuple(x.shape[1:])))
        off += nb
    it = iter(out)
    return tree_map(lambda x: next(it), tree)


def global_sum(x):
    """Sum a host-local numpy value over every rank, exactly: float64,
    added in rank order."""
    if not dist.is_initialized():
        return x
    dev = rank_device() if backend() == 'nccl' else torch.device('cpu')
    rows = _all_gather(torch.as_tensor(np.asarray(x, np.float64),
                                       device=dev)).cpu().numpy()
    out = rows[0].copy()
    for r in rows[1:]:
        out += r
    return out


def bootstrap_multihost(scene, opts, seed, chunk=4096):
    """The bootstrap over every process: each takes num_init_samples //
    processes samples and num_chains // processes chain seeds with its own
    generator (seeded from seed and its rank). b is the sample-weighted
    mean of the processes' b, and the length histogram the sum of their
    normalised histograms weighted by sample count, both exact (float64,
    rank order), as the JAX package reduces them. Returns (b,
    length_dist, this process's BankedState)."""
    nproc, pid = process_count(), process_index()
    local_opts = opts.replace(
        num_init_samples=max(opts.num_init_samples // nproc, 1),
        num_chains=max(opts.num_chains // nproc, 1))
    gen = torch.Generator(device=scene.device).manual_seed(
        fold_seed(seed, pid))
    b_local, length_dist_local, banked = mlt.bootstrap(
        scene, local_opts, gen, chunk=chunk)

    n_local = local_opts.num_init_samples
    sum_b = global_sum(np.asarray(b_local * n_local, np.float64))
    n_total = global_sum(np.asarray(n_local, np.float64))
    hist = global_sum(length_dist_local.func.cpu().numpy()
                      .astype(np.float64) * n_local)
    length_dist = Distribution1D(hist / max(hist.sum(), 1e-30),
                                 device=scene.device)
    return float(sum_b / n_total), length_dist, banked


def _nbytes(tree):
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def render_mlt_multihost(scene, opts, seed, num_steps=None, chunk=4096,
                         progress=False, timings=None, mesh=None,
                         parts=None):
    """MCMC render with the chains sharded over every shard of every
    process. Returns (film [H, W, 3], b); every rank holds the same film
    up to the direct pass, which each rank computes with the same seed.

    mesh: this process's shards (default: one, on scene.device). seed: the
    run's seed (the CLI's seed offset); the bootstrap, the direct pass and
    the chain loop take seeds folded from it. num_steps: chain iterations
    (default spp * pixels / global chains), run as the JAX package's loop
    runs them: whole calls of n_inner = min(16, num_steps) iterations
    (make_sharded_multi_step) while fewer than num_steps are done, so the
    run may pass num_steps and the film is divided by the iterations
    done; the large-step probability switched after the call that passes
    int(num_steps * ls_ratio); the caches merged every MERGE_EVERY calls.
    A call whose n_done falls short of n_inner (a non-finite chain state)
    raises RuntimeError. timings: optional dict, filled with
    'bootstrap_s', 'loop_s', 'direct_s', 'steps' and 'n_done' (the
    iterations done: the calls' n_done summed), 'calls', 'n_inner',
    this process's step counts and 'cache_rows_ready' as render_mlt fills
    them, the captured graphs of its first group's steps (render_mlt's
    'graphs', 'eager_calls', 'branches', 'branch_runs', 'branch_skips',
    'graph_nodes', 'capture_s', 'instantiate_s'), and
    'merges', 'merge_s' (inside loop_s), 'merge_bytes' (the gathered
    caches a merge brings to each rank), 'reduce_s' (the film reduce),
    'world' and 'shards'.
    parts: optional dict that receives the reduced chain film
    ('chain_film', [H, W, 3], already divided by the effective spp)."""
    dev = scene.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == 'cuda' \
        else (lambda: None)
    timings = {} if timings is None else timings
    mesh = make_chain_mesh([dev]) if mesh is None else mesh
    seed_boot, seed_direct, seed_loop = (fold_seed(seed, k)
                                         for k in range(3))
    t0 = time.time()
    b, length_dist, banked = bootstrap_multihost(scene, opts, seed_boot,
                                                 chunk=chunk)
    sync()
    timings['bootstrap_s'] = time.time() - t0
    C_global = banked.state.ls_score.shape[0] * mesh.world
    npix = scene.width * scene.height
    if num_steps is None:
        num_steps = max(opts.spp * npix // C_global, 1)
    run_opts = opts.replace(num_chains=C_global)

    init = shard_chains(mesh, banked)
    banks = [mlt.attach_cache(s, run_opts) for s in init]
    has_cache = banks[0].cache is not None
    if has_cache:
        prev_count = torch.zeros_like(banks[0].cache.count)
        timings['merge_bytes'] = (_nbytes(banks[0].cache) * mesh.world
                                  * len(banks))
    films = [torch.zeros((g, scene.height, scene.width, 3), device=d)
             for d, _, g in mesh.groups]
    ls_prob1 = opts.large_step_probability
    scale = 1.0 if opts.h2mc else opts.large_step_prob_scale
    ls_prob2 = min(ls_prob1 * scale, 1.0)
    n_inner = max(1, min(16, num_steps))
    pools = [torch.cuda.graph_pool_handle() if d.type == 'cuda' else None
             for d, _, _ in mesh.groups]
    step1 = make_sharded_multi_step(mesh, scene, run_opts, b, ls_prob1,
                                    n_inner, length_dist=length_dist,
                                    pools=pools)
    step2 = step1 if ls_prob2 == ls_prob1 else make_sharded_multi_step(
        mesh, scene, run_opts, b, ls_prob2, n_inner, length_dist=length_dist,
        pools=pools)
    gens = shard_generators(mesh, seed_loop)
    phase_switch = int(num_steps * opts.ls_ratio)
    done = outer = merges = 0
    merge_s = 0.0
    t0 = time.time()
    while done < num_steps:
        step = step1 if done <= phase_switch else step2
        banks, films, n_done = step(gens, banks, films, init)
        if n_done < n_inner:
            # the device counter grows only while the chain state stays
            # finite: looping on would never end
            raise RuntimeError(f'multihost step ran {n_done}/{n_inner} '
                               f'iterations: non-finite chain state')
        done += n_done
        outer += 1
        if has_cache and outer % MERGE_EVERY == 0:
            sync()
            t_m = time.time()
            caches, prev_count = merge_caches([s.cache for s in banks],
                                              prev_count)
            banks = [dataclasses.replace(s, cache=c)
                     for s, c in zip(banks, caches)]
            sync()
            merge_s += time.time() - t_m
            merges += 1
        if progress:
            print(f'mlt step {done}/{num_steps}', flush=True)
    sync()
    timings['loop_s'] = time.time() - t0
    # the one film reduce: this process's shards in order, then the ranks
    t0 = time.time()
    film = films[0].sum(0)
    for f in films[1:]:
        film = film + f.to(dev).sum(0)
    all_reduce_sum(film)
    sync()
    timings['reduce_s'] = time.time() - t0
    indirect = film / (done * C_global / npix)
    if parts is not None:
        parts['chain_film'] = indirect

    t0 = time.time()
    if opts.direct_spp > 0:
        gen = torch.Generator(device=dev).manual_seed(seed_direct)
        direct = render_direct(scene, run_opts, gen, chunk=chunk)
    else:
        direct = torch.zeros_like(indirect)
    sync()
    timings['direct_s'] = time.time() - t0
    timings.update(steps=done, n_done=done, n_inner=n_inner, calls=outer,
                   merges=merges, merge_s=merge_s, world=mesh.world,
                   shards=mesh.num_shards)
    for st in {step1, step2}:
        for k, v in st.counts().items():
            timings[k] = timings.get(k, 0) + v
    timings.update(mlt.graph_stats([step1.multis[0], step2.multis[0]]))
    if has_cache:
        timings['cache_rows_ready'] = int(
            (banks[0].cache.count >= banks[0].cache.size).sum())
    return direct + indirect, b
