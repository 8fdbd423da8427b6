"""The sharded MCMC step and the cache merge (port of
parallel/shardmap_step.py).

Each group of shards (parallel/mesh.py: a run of shards on one device)
runs the single-device multi-step (integrators/mlt.make_mlt_multi_step:
n_inner iterations a call, CUDA graphs on the card) on its shards'
chains, with one film partition per shard and its own global PSS cache:

* chains: data-parallel, C/S lanes a shard, each group with its own
  torch.Generator seeded from the run's seed and the global index of its
  first shard (the JAX package folds the shard's mesh index into the
  step's key; with one shard a device the two agree);
* film: one [g, H, W, 3] stack of per-shard partials a group
  (make_mlt_step's film_shards), summed once at the end of the run
  (parallel/multihost.py);
* cache: one per group, merged every few calls (merge_stacked). The
  reference pushes under one mutex per dimension in arbitrary thread
  order, so a merge that appends the groups' new entries in order only
  reorders arrivals, as another thread schedule would.

A call's n_done is the least over the groups of every process, as the
JAX package's pmin over the mesh: every rank sees the same count.
"""

import numpy as np
import torch

from ..integrators import mlt
from ..mcmc.cache import GlobalCache
from ..utils.tree import tree_map
from .mesh import replicate


def fold_seed(seed, *ints):
    """A 63-bit seed derived from seed and ints (the analogue of
    jax.random.fold_in): the same arguments give the same seed on every
    process."""
    ss = np.random.SeedSequence([int(x) & 0xFFFFFFFFFFFFFFFF
                                 for x in (seed, *ints)])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def shard_generators(mesh, seed):
    """One torch.Generator per group, on its device, seeded from seed and
    the global index of the group's first shard."""
    return [torch.Generator(device=dev).manual_seed(
        fold_seed(seed, mesh.first_shard + first))
        for dev, first, _ in mesh.groups]


def stack_cache(caches, device):
    """The caches as one GlobalCache of [S, ...] tensors on device."""
    return tree_map(lambda *xs: torch.stack([x.to(device) for x in xs]),
                    *caches)


def _pairwise_sum(x):
    """Sum over the last axis as a fixed tree of elementwise adds (padded
    to a power of two), so every device rounds it alike."""
    n = 1 << max(x.shape[-1] - 1, 0).bit_length()
    x = torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def merge_stacked(stacked, prev_count):
    """Merge S caches (stacked: a GlobalCache of [S, ...] tensors) that
    share a common prefix of prev_count [NDIM] entries a dimension row
    (the state at the last merge): the merged row is [common prefix |
    shard 0's tail | shard 1's tail | ...], capped at SIZE. score_sum is
    recomputed as the sum of the surviving weights (its invariant: pushes
    stop when a row is full). Returns the merged GlobalCache."""
    counts = stacked.count.long()                  # [S, NDIM]
    S, ndim = counts.shape
    size = stacked.weight.shape[2]
    dev = counts.device
    prev = prev_count.to(dev).long()               # [NDIM]
    tails = torch.clamp(counts - prev[None], min=0)
    offs = prev[None] + torch.cumsum(tails, 0) - tails
    new_count = torch.clamp(prev + tails.sum(0), max=size)

    p = torch.arange(size, device=dev)
    # the source shard of each merged position: the last s with offs <= p
    dev_sel = torch.clamp(
        (offs[:, :, None] <= p[None, None, :]).sum(0) - 1, 0, S - 1)
    off_sel = torch.gather(offs.t(), 1, dev_sel)   # [NDIM, SIZE]
    src_pos = torch.clamp(prev[:, None] + p[None, :] - off_sel, 0, size - 1)
    cnt_sel = torch.gather(counts.t(), 1, dev_sel)
    is_new = ((p[None, :] >= prev[:, None])
              & (p[None, :] < new_count[:, None])
              & (prev[:, None] + p[None, :] - off_sel < cnt_sel))
    dim_ix = torch.arange(ndim, device=dev)[:, None]

    def gather(leaf):
        # leaf [S, NDIM, SIZE, ...]; the prefix (p < prev) is shard 0's
        new_vals = leaf[dev_sel, dim_ix, src_pos]
        m = is_new.reshape(is_new.shape + (1,) * (leaf.ndim - 3))
        return torch.where(m, new_vals, leaf[0])

    new_w = gather(stacked.weight)
    valid = p[None, :] < new_count[:, None]
    return GlobalCache(
        pss=gather(stacked.pss), v1=gather(stacked.v1),
        v2=gather(stacked.v2), weight=new_w, s_tag=gather(stacked.s_tag),
        t_tag=gather(stacked.t_tag),
        count=new_count.to(stacked.count.dtype),
        score_sum=_pairwise_sum(torch.where(valid, new_w,
                                            torch.zeros_like(new_w))),
        rec=(tree_map(gather, stacked.rec)
             if stacked.rec is not None else None))


def make_sharded_multi_step(mesh, scene, opts, normalization, ls_prob,
                            n_inner, length_dist=None, pools=None):
    """The sharded multi-step over mesh's local groups. opts.num_chains is
    the GLOBAL chain count; each shard steps num_chains / mesh.num_shards
    chains. Call as step(gens, banked, films, init_banked) with one
    generator, BankedState (its cache that group's own), [g, H, W, 3]
    film and seed state per group: every group runs n_inner iterations
    (one make_mlt_multi_step call; pools: each group's graph memory pool,
    or None). Returns (banked, films, n_done): the groups' new
    BankedStates and films (the multi-steps' buffers, overwritten by the
    next call) and the least n_done over every group of every process,
    an int. step.counts() sums the groups' step counts (make_mlt_step) as
    ints; step.multis are the groups' multi-steps."""
    S = mesh.num_shards
    C = opts.num_chains
    if C % S:
        raise ValueError(f'{C} chains do not split into {S} shards')
    pools = pools or [None] * len(mesh.groups)
    multis = [mlt.make_mlt_multi_step(
        sc, opts.replace(num_chains=C // S * g), normalization, ls_prob,
        n_inner, length_dist=(length_dist.to(dev) if length_dist is not None
                              else None), film_shards=g, pool=pool)
        for (dev, _, g), sc, pool in zip(mesh.groups, replicate(mesh, scene),
                                         pools)]

    def step(gens, banked, films, init_banked):
        out = [m(gens[i], banked[i], films[i], init_banked[i])
               for i, m in enumerate(multis)]
        first = out[0][2].device
        n_done = torch.stack([o[2].to(first) for o in out]).min()
        from .multihost import all_reduce_min
        return ([o[0] for o in out], [o[1] for o in out],
                int(all_reduce_min(n_done)))

    def counts():
        out = {}
        for m in multis:
            for k, v in m.step.counts.items():
                out[k] = out.get(k, 0) + int(v)
        return out

    step.counts = counts
    step.multis = multis
    return step


def merge_caches(caches, prev_count):
    """The periodic cache merge (the JAX package's make_cache_merger):
    every rank stacks its groups' caches, all-gathers them (one
    collective; ranks in order, so the stack is in global order), runs
    merge_stacked and gives each cache's device its own copy of the
    merged cache. Returns (caches, new_count)."""
    from .multihost import all_gather_tree
    merged = merge_stacked(
        all_gather_tree(stack_cache(caches, caches[0].count.device)),
        prev_count)
    return ([tree_map(lambda x: x.to(c.count.device, copy=True), merged)
             for c in caches], merged.count)
