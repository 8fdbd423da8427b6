"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. the build of every kernel source in langevin_mcmc_tpu_torch/csrc/ (one
     nvcc per source, in parallel, linked into one library);
  3. on the generated flagship scene (24,576-triangle torus, 65,536 rays:
     half camera rays, half from surface points in random directions with
     30% of those dead), with CUDA-event timings:
     - the time of the torch stages that the kernels no longer need: the
       chunk lists (_block_chunk_lists, K1-K3) and the sweep's visit mask
       (_chunk_mask, K4); and the chunk ranges per ray block S and grid
       each form of the walk kernel uses at 65,536 rays and at the large
       step's 4,261;
     - each form's S swept at both ray counts, each S first checked equal
       to the default;
     - the staged chunk walk (K1 closest hit, K2 any hit) and its resident
       form (K3, both variants) against their plain torch version
       (_block_chunk_lists + walk_reference), the culled sweep (K4, both
       variants) against its own (_chunk_mask + sweep_reference), each
       with its time, its plain version's and its bound, at 65,536 rays
       and again at the large step's; and the sweep's t against the chunk
       walk's on every hit (the ids may differ only on exact ties of t,
       which are counted);
  4. on the generated open scene (the same torus, now a rough dielectric,
     on a textured floor beside a textured Phong sphere, lit by an env map
     with a sun, a point light and the quad area light; no walls, so rays
     miss): K1/K2 on 65,536 rays (kernel_rays' camera and surface rays,
     plus rays from the x1000 bounding sphere: the env map's emission rays
     and rays aimed at the scene) against their plain version, with time,
     plain time, bound and the share of live rays that miss;
  5. the BVH (ops/bvh.py, csrc/bvh.cu) on the box, the open scene and the
     moving open scene: ptxas's registers, stack frame, spills and shared
     memory of each kernel instantiation; attach_bvh (build_bvh in numpy
     and pack_bvh), pack_bvh alone and build_bvh_native seconds; the
     kernel, closest and any hit, against its plain version
     (traverse_reference) bit for bit on the rays of phases 3 and 4 and
     of path F's brute-force query, at 65,536 rays and the large step's
     4,260, with its time, the plain version's (one run), the inner nodes
     and triangles a live ray (counted by the plain version: mean, 99th
     percentile, max), the divergence (the mean over warps of the most
     loop steps of a lane over the warp's mean) and its bound; beside
     K1/K2 on the same static rays (kernel alone and whole query) and the
     motion brute force on the same moving rays;
  6. a one-rank NCCL process group on the card: global_sum, the cache
     merger (its all-gather of CUDA tensors) against merge_stacked on the
     CPU bit for bit, and the film all-reduce, each timed;
  7. path generation on the card against the CPU plain path on the small
     generated box and open scenes and on the small moving open scene
     (same tape);
  8. path A, the MALA render through the CLI entry point: 1024x768,
     maxdepth 8, 65,536 chains, 300,000 bootstrap samples, directspp 1,
     --spp 1 (12 chain iterations, one call of the multi-step); it runs
     K1/K2. Then the graph phase of path A's configuration
     (graph_parity): from one bootstrapped state and one generator state,
     8 eager iterations (make_mlt_step, with no host sync outside the
     eager calls: torch.cuda.set_sync_debug_mode('error')) and the same 8
     through the multi-step (a warm-up, the capture, replays): the chain
     state bit for bit, step.counts and every kernel's launches equal,
     the film to rtol 1e-5; then eager and captured ms an iteration side
     by side. Every MCMC path but H has such a graph phase after its
     render (PARITY_STEPS iterations);
  9. path B, the same configuration with H2MC small steps and
     LMCMC_ISECT_BACKEND=pallas, so it runs K4, through render_mlt cut to
     4 chain iterations (PATH_B_STEPS; an H2MC iteration takes ~15-21 s);
     the ratio of the two chain loops' proposals/s is the H2MC/MALA cost
     ratio at the same tuning; its graph phase holds the step split into
     graphs around the eigh calls (ops/graphs.eager_call) against the
     eager step;
 10. path C, the MC integrator on the flagship scene (--spp 1) with
     LMC_CW_VMEM_BYTES=6291456, so it runs K3;
 11. path D, path A's configuration on the open scene; it runs K1/K2;
 12. path E, path A's configuration with multiplexed and cache-seeded large
     steps and light-coordinate sampling (largestepmultiplexed, samplecache,
     uselightcoordinatesampling): generate_subpath and the cache branch's
     perturb replay send their ray queries through K1/K2. It prints the
     large-step lanes of each branch, the cache rows that filled and the
     generated lanes that carried light-coordinate parameters;
 13. the graph phase of path E's configuration: graph_parity (below,
     after path A) on path E's state bootstrapped at full width with the
     seed states (paths included) pushed twice into the cache, so that
     every row they reach is full: the cache branch runs (it must, on some
     lanes) and no lane starts in the gradient phase, so the captured
     step's gradient branches (ops/graphs.cond_call) are skipped; their
     runs and skips are printed, and the replays are timed again with the
     branches computed and selected (as before cond_call) in this call;
 14. path H, path E's configuration with --spp 6 rendered by two ranks of
     the CLI (--coordinator 127.0.0.1:<free port> --num-processes 2
     --process-id 0/1; each rank is `python3 chip_smoke.py --rank OUT
     CLI-ARGS...`) that share the card, so their collectives take gloo:
     32,768 chains and 150,000 bootstrap samples a rank, 72 iterations
     asked for and 80 run (whole calls of 16, as the JAX package's
     multihost loop runs them), one cache merge. The ranks' reduced chain
     films must be
     bit-identical and their b equal, their final films equal to rtol
     1e-5, each film checked, K1/K2 launched on both; per rank its phase
     seconds, ms an iteration, proposals/s, acceptance, peak memory, the
     merge's ms and bytes and the film reduce's ms, and the two ranks'
     summed proposals/s over path E's;
 15. path F, path D's configuration with --motion (the torus and the quad
     light turn and move between two keyframes, the camera pans, the env
     map turns), through the CLI (--spp 1, 12 iterations): every ray
     query is the motion brute force in torch (no kernel), which gathers
     its live rays on the host, so a captured step runs each query
     between two graphs (ops/graphs.eager_call); the frozen replay and
     path_grad run without a bake. Its graph phase bootstraps 65,536
     samples (PATH_F_PARITY_INIT_SAMPLES). Before
     it, one brute-force closest-hit and one any-hit query at 65,536 rays
     on that scene, timed by CUDA events (the closest hit also at blocks
     of 2^20, 2^22 and 2^24 ray-triangle pairs, each checked equal); after
     it, their share of path F's iteration and the brute force's
     host-clock share of the render; no walk kernel may launch;
 16. path G, path A's configuration with neither mala nor h2mc: the
     isotropic-only chain through K1/K2;
 17. path I, path F's configuration with a BVH attached, through the API
     (parse_scene, attach_bvh, render_mlt; neither package's CLI attaches
     one): every query must take the BVH kernel (no brute-force query, no
     walk kernel); its proposals/s over path F's and path D's.
Phase 7 also holds generate_subpath with light-coordinate sampling (mixed
(s, t) per lane) on the card against the CPU.
Every MCMC path (A, B, D, E, F, G, H, I) runs its chain loop through
make_mlt_multi_step (integrators/mlt.py): CUDA graphs of the chain step
on the card, n_inner iterations a call on the JAX package's schedule. Per
path it prints the graphs a step and the eager calls between them (named:
H2MC's torch.linalg.eigh reads its error flags on the host, so path B's
step is split around two eigh calls; path F's around every brute-force
query), the cond_call branches (MALA's two gradients) and how often they
ran, their nodes, the capture and instantiate seconds, and n_done
against the iterations scheduled, which must be equal. The render's
first iteration (eager, lazy set-up included) is printed beside its
replays; eager against captured ms an iteration comes from the graph
phases, summed up in one line. Each render's film must be finite, non-negative, non-zero
and 768x1024x3 (path D's and path F's top rows, the sky, lit too), and
each kernel must have been launched by the path that runs it (the launch
counts are reset just before each path and read just after; a captured
kernel counts once per execution: ops/graphs.py). Each MCMC path prints
its chain-loop ms per iteration (the warm-up and the capture included),
proposals/s, acceptance rate, bootstrap and direct-pass seconds and peak
device memory (the graphs' pool included).
The line before the last two is {"kernels": [...]}: per kernel its
launches on its path (K1/K2 also on path E: launches_path_e), max |error|
against the plain version, its time and
the plain version's (ms; ms is one call of the wrapper on an idle card,
ms_launches one of 20 calls back to back, the host's time to enqueue a
call hidden behind the card's work), and its bound: the larger of the f32 operations
this run's data needs (40 per ray-triangle test, 25 per ray-AABB slab
test: 256 rays x all chunks per block) over the 67 TFLOP/s f32 peak and
its bytes (each input read once, each output written once) over 3.35 TB/s
(H100 SXM data sheet). No PyTorch call
computes a closest-hit ray query, so library_ms is null. The open scene's
K1/K2 rows (names ending in _open) also carry miss_share. The BVH rows
(bvh_{closest,any}_hit_{box,open,motion}, "pallas": false: the JAX
traversal is an XLA loop, not a Pallas kernel) carry their launches on
path I, and a bound from the work the plain version counts: 25 f32
operations per ray-box test (two per inner node), 61 per Moller-Trumbore
test (28 more for a moving triangle's lerp); also the work's spread and
divergence, ptxas's report, pack_bvh's seconds and the large step's
numbers (large_step).
The last line is {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, 'smoke_out', 'chip_smoke')
INIT_SAMPLES = 300000   # numinitsamples of the flagship render
CHUNK = 32768           # wavefront of the bootstrap and direct passes
RESIDENT_BYTES = 6291456  # LMC_CW_VMEM_BYTES of path C
PATH_B_STEPS = 4        # path B's chain iterations (H2MC: ~15-21 s each)
# graph phases' iterations: 8 on paths A and E; 3 on H2MC (path B) and the
# moving brute force (path F), whose eager iterations take seconds; 4 on
# the others. From the third on, an iteration is a replay.
PARITY_STEPS = dict(A=8, B=3, D=4, E=8, F=3, G=4, I=4)
# bootstrap samples of path F's graph phase (its render keeps 300,000)
PATH_F_PARITY_INIT_SAMPLES = 65536
OPS_PER_TEST = 40       # f32 operations of one ray-triangle test
OPS_PER_SLAB = 25       # f32 operations of one ray-AABB slab test
OPS_PER_MT = 61         # f32 operations of one Moller-Trumbore test
OPS_PER_LERP = 28       # f32 operations of one triangle's vertex lerp
PEAK_F32 = 67e12        # H100 SXM f32 peak, FLOP/s
PEAK_BYTES = 3.35e12    # H100 SXM HBM3, bytes/s


def log(msg):
    print(msg, flush=True)


def write_flagship(out_dir, num_init_samples=INIT_SAMPLES, **kw):
    """Write the generated flagship scene (24,576-triangle torus, 1024x768,
    maxdepth 8, 65,536 chains) into out_dir; returns the XML path. kw:
    write_scene's kernel / integrator / scene ('box' or 'open')."""
    sys.path.insert(0, HERE)
    from langevin_mcmc_tpu_torch import testscenes
    return testscenes.write_scene(out_dir, num_init_samples=num_init_samples,
                                  **kw)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats=5):
    """Median milliseconds of fn() over repeats, timed with CUDA events
    after one warm-up call."""
    fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cuda_ms_launches(fn, launches=20, repeats=5):
    """Median milliseconds of one fn() over repeats, each timing `launches`
    calls back to back with CUDA events (after one warm-up call), so that
    the host's time to enqueue a call overlaps the device's work: the
    kernel's time, where cuda_ms's one call also counts the host's time
    before the launch reaches an idle device."""
    fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def kernel_rays(scene, n, seed):
    """n rays on the card: n/2 camera rays, n/2 leaving surface points of
    random triangles in random directions, 30% of those dead."""
    from langevin_mcmc_tpu_torch.scene.camera import sample_primary
    dev = scene.device
    g = torch.Generator(device=dev).manual_seed(seed)
    h = n // 2
    sp = torch.rand((h, 2), generator=g, device=dev)
    org0, d0, mn0, mx0 = sample_primary(scene.camera, sp,
                                        torch.zeros(h, device=dev))
    tri = torch.randint(0, scene.num_tris, (n - h,), generator=g, device=dev)
    b = torch.rand((n - h, 2), generator=g, device=dev)
    flip = b.sum(1) > 1
    b = torch.where(flip[:, None], 1 - b, b)
    p = scene.tri_p[0][tri]
    org1 = (p[:, 0] * (1 - b.sum(1))[:, None] + p[:, 1] * b[:, :1]
            + p[:, 2] * b[:, 1:])
    d1 = torch.randn((n - h, 3), generator=g, device=dev)
    d1 = d1 / d1.norm(dim=1, keepdim=True)
    alive = torch.rand(n - h, generator=g, device=dev) >= 0.3
    mx1 = torch.where(alive, torch.full_like(alive, float('inf'),
                                             dtype=torch.float32),
                      torch.zeros(n - h, device=dev))
    return (torch.cat([org0, org1]), torch.cat([d0, d1]),
            torch.cat([mn0, torch.full((n - h,), 1e-4, device=dev)]),
            torch.cat([mx0, mx1]))


def nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def bound(tests, in_bytes, out_bytes, slab_tests=0):
    """(bound_ms, bound_by): the larger of the operations' (ray-triangle
    and ray-AABB slab tests) and the bytes' least times on the card."""
    ops_ms = (OPS_PER_TEST * tests + OPS_PER_SLAB * slab_tests) \
        / PEAK_F32 * 1e3
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms \
        else (bytes_ms, 'bytes')


def blocks_until_occluded(pack, chunk_idx, counts, org, d, rng):
    """Chunks each ray block visits before every one of its rays is
    occluded or dead (or its list ends): the work the any-hit variants
    need, since a dead ray can hit nothing."""
    from langevin_mcmc_tpu_torch.ops.chunkwalk import RAY_BLOCK, _tile
    nb = counts.shape[0]
    o = org.reshape(nb, RAY_BLOCK, 3)
    dd = d.reshape(nb, RAY_BLOCK, 3)
    r = rng.reshape(nb, RAY_BLOCK, 2)
    cols = [x[..., None] for x in (o[..., 0], o[..., 1], o[..., 2],
                                   dd[..., 0], dd[..., 1], dd[..., 2],
                                   r[..., 0], r[..., 1])]
    occ = ~(r[..., 1] >= r[..., 0])
    visited = torch.zeros(nb, dtype=torch.int64, device=org.device)
    for j in range(int(counts.max())):
        live = (j < counts) & ~occ.all(1)
        blk = torch.nonzero(live).squeeze(1)
        if blk.numel() == 0:
            break
        visited[blk] += 1
        ok = _tile(pack[chunk_idx[blk, j].long()], *(c[blk] for c in cols))[0]
        occ[blk] |= ok.any(-1)
    return visited


def compare(name, got, want, any_hit):
    """Exact agreement of a kernel with its plain version; returns the
    max |error| (0.0)."""
    from langevin_mcmc_tpu_torch.ops.chunkwalk import BIG
    if any_hit:
        if not torch.equal(got, want):
            raise AssertionError(f'{name}: occlusion differs on '
                                 f'{(got != want).sum().item()} rays')
        return float((got.int() - want.int()).abs().max())
    t_k, id_k, u_k, v_k = got
    t_p, id_p, u_p, v_p = want
    hit_k, hit_p = t_k < BIG, t_p < BIG
    if not torch.equal(hit_k, hit_p):
        raise AssertionError(f'{name}: hit sets differ on '
                             f'{(hit_k != hit_p).sum().item()} rays')
    if not torch.equal(id_k[hit_k], id_p[hit_p]):
        raise AssertionError(f'{name}: ids differ on '
                             f'{(id_k != id_p)[hit_k].sum().item()} hits')
    err = max(float((t_k - t_p)[hit_k].abs().max()),
              float((u_k - u_p)[hit_k].abs().max()),
              float((v_k - v_p)[hit_k].abs().max()))
    if err != 0.0:
        raise AssertionError(f'{name}: t/u/v differ by up to {err} (the '
                             f'kernel is built with --fmad=false and must '
                             f'round as the plain version does)')
    return err


def kernel_row(name, source, replaces, kernel, plain, any_hit, tests,
               in_bytes, rays, slab_tests=0):
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    err = compare(name, got, want, any_hit)
    ms = cuda_ms(kernel)
    ms_launches = cuda_ms_launches(kernel)
    plain_ms = cuda_ms(plain)
    bound_ms, bound_by = bound(tests, in_bytes, rays * (1 if any_hit else 16),
                               slab_tests)
    log(f'{name}: equal to the plain version (max |err| {err}); kernel '
        f'{ms:.3f} ms (back to back {ms_launches:.3f} ms), plain '
        f'{plain_ms:.3f} ms, {tests:.4g} ray-triangle '
        f'tests + {slab_tests:.4g} slab tests, bound {bound_ms:.3f} ms '
        f'({bound_by})')
    return dict(name=name, route='cuda', source=source, replaces=replaces,
                max_abs_err=err, ms=ms, ms_launches=ms_launches,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def split_table(label, walk, tabs, o, d, rng):
    """A form of the walk kernel timed on these rays at several chunk
    ranges per block S (the default marked), each first checked equal to
    the default."""
    from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
    nb, K = o.shape[0] // cw.RAY_BLOCK, tabs[0].shape[0]
    S0 = cw.split_count(nb, K)
    ref = [walk(*tabs, o, d, rng, a) for a in (False, True)]
    for S in sorted({1, 2, 4, 8, 16, 32, 64, S0, K}):
        if S > K:
            continue
        row = []
        for a in (False, True):
            fn = lambda: walk(*tabs, o, d, rng, a, splits=S)
            compare(f'{label} S={S}', fn(), ref[a], a)
            row.append(cuda_ms(fn))
        log(f'  {label}, {o.shape[0]} rays, S={S}'
            f'{" (default)" if S == S0 else ""}, {nb * S} CTAs: closest '
            f'{row[0]:.3f} ms, any {row[1]:.3f} ms')


def variant_rows(scene, o, dd, rng, so, sd, srng, tag):
    """The six kernel variants on these sorted, padded rays (the chunk
    walk's o, dd, rng; the sweep's so, sd, srng), each at its default S
    against its plain version, timed, with its bound. Returns the rows of
    the kernels JSON line, keyed by the launch-count name; tag is appended
    to each printed name."""
    from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
    from langevin_mcmc_tpu_torch.ops import sweep_isect as sw
    tabs = (scene.cw.pack, scene.cw.ids, scene.cw.chunk_lo, scene.cw.chunk_hi)
    stabs = (scene.sweep.pack, scene.sweep.ids, scene.sweep.chunk_lo,
             scene.sweep.chunk_hi)
    lists = lambda: cw._block_chunk_lists(o, dd, rng[:, 0], rng[:, 1],
                                          scene.cw.chunk_lo, scene.cw.chunk_hi)
    mask_fn = lambda: sw._chunk_mask(so, sd, srng[:, 0], srng[:, 1],
                                     scene.sweep.chunk_lo,
                                     scene.sweep.chunk_hi)
    chunk_idx, counts = lists()
    mask = mask_fn()
    n = o.shape[0]
    nb, K = counts.shape[0], scene.cw.pack.shape[0]
    cw_src = 'langevin_mcmc_tpu_torch/csrc/chunkwalk.cu'
    tests_c = int(counts.sum()) * cw.RAY_BLOCK * cw.TRI_CHUNK
    tests_a = int(blocks_until_occluded(scene.cw.pack, chunk_idx, counts, o,
                                        dd, rng).sum()) \
        * cw.RAY_BLOCK * cw.TRI_CHUNK
    cw_in = nbytes(*tabs, o, dd, rng)
    rows = {}
    for walk, a, key, name, rep in (
            (cw.walk_staged, False, 'split_closest_hit',
             'chunkwalk_split_closest_hit',
             'langevin_mcmc_tpu/ops/chunkwalk.py:157'),
            (cw.walk_staged, True, 'split_any_hit', 'chunkwalk_split_any_hit',
             'langevin_mcmc_tpu/ops/chunkwalk.py:180'),
            (cw.walk_resident, False, 'closest_hit_resident',
             'chunkwalk_resident_closest_hit',
             'langevin_mcmc_tpu/ops/chunkwalk.py:280'),
            (cw.walk_resident, True, 'any_hit_resident',
             'chunkwalk_resident_any_hit',
             'langevin_mcmc_tpu/ops/chunkwalk.py:315')):
        rows[key] = kernel_row(
            name + tag, cw_src, rep,
            lambda: walk(*tabs, o, dd, rng, a),
            lambda: cw.walk_reference(scene.cw.pack, scene.cw.ids, *lists(),
                                      o, dd, rng, a), a,
            tests_a if a else tests_c, cw_in, n,
            slab_tests=nb * cw.RAY_BLOCK * K)

    # the chunks each block visits, as lists, to count the any hit's tests
    s_lists = torch.argsort((mask == 0).to(torch.int32), dim=1, stable=True)
    tests_sa = int(blocks_until_occluded(
        scene.sweep.pack, s_lists.to(torch.int32), mask.sum(1), so, sd,
        srng).sum()) * sw.RAY_BLOCK * sw.TRI_CHUNK
    sw_src = 'langevin_mcmc_tpu_torch/csrc/sweep.cu'
    sw_in = nbytes(*stabs, so, sd, srng)
    for a, key, rep, tests in (
            (False, 'sweep_closest_hit',
             'langevin_mcmc_tpu/ops/pallas_isect.py:129',
             int(mask.sum()) * sw.RAY_BLOCK * sw.TRI_CHUNK),
            (True, 'sweep_any_hit', 'langevin_mcmc_tpu/ops/pallas_isect.py:193',
             tests_sa)):
        rows[key] = kernel_row(
            key + tag, sw_src, rep, lambda: sw.walk(*stabs, so, sd, srng, a),
            lambda: sw.sweep_reference(scene.sweep.pack, scene.sweep.ids,
                                       mask_fn(), so, sd, srng, a), a,
            tests, sw_in, n,
            slab_tests=so.shape[0] * scene.sweep.pack.shape[0])
    return rows


def check_kernels(scene):
    """Every kernel variant against its plain version on the flagship
    scene. Returns the rows of the kernels JSON line (launches filled
    later), keyed by the launch-count name."""
    from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
    from langevin_mcmc_tpu_torch.ops import sweep_isect as sw
    org, d, mn, mx = kernel_rays(scene, 65536, seed=7)
    R = org.shape[0]
    large = int(0.05 * 65536 * 1.3) + 1   # the large step's lanes
    forms = (('staged', cw.walk_staged, scene.cw, cw.sort_rays),
             ('resident', cw.walk_resident, scene.cw, cw.sort_rays),
             ('sweep', sw.walk, scene.sweep, sw.prepare_rays))
    rays = {}   # (form, rays) -> sorted, padded (o, d, rng)
    for form, _, tab, sort in forms:
        for n in (R, large):
            rays[form, n] = sort(tab, org[:n], d[:n], mn[:n], mx[:n])[0]
    o, dd, rng = rays['staged', R]
    so, sd, srng = rays['sweep', R]
    lists = lambda: cw._block_chunk_lists(o, dd, rng[:, 0], rng[:, 1],
                                          scene.cw.chunk_lo, scene.cw.chunk_hi)
    mask_fn = lambda: sw._chunk_mask(so, sd, srng[:, 0], srng[:, 1],
                                     scene.sweep.chunk_lo,
                                     scene.sweep.chunk_hi)
    chunk_idx, counts = lists()
    mask = mask_fn()
    torch.cuda.synchronize()
    nb, K = counts.shape[0], scene.cw.pack.shape[0]
    Ks = scene.sweep.pack.shape[0]
    log(f'kernel inputs: {R} rays, {nb} blocks, {K} chunks of '
        f'{cw.TRI_CHUNK} (mean list length {counts.float().mean().item():.2f})'
        f', {Ks} of {sw.TRI_CHUNK} ({int(mask.sum())} (block, chunk) pairs '
        f'visited)')
    log(f'torch stages the kernels no longer need, at {R} rays: chunk lists '
        f'(_block_chunk_lists, K1-K3) {cuda_ms(lists):.3f} ms, visit mask '
        f'(_chunk_mask, K4) {cuda_ms(mask_fn):.3f} ms')
    for form, _, tab, _ in forms:
        for n in (R, large):
            nbn = rays[form, n][0].shape[0] // cw.RAY_BLOCK
            S = cw.split_count(nbn, tab.pack.shape[0])
            log(f'split: {form}, {n} rays = {nbn} blocks, S = {S} chunk '
                f'ranges per block, grid {nbn * S} CTAs')
    log('chunk ranges per block S (CUDA-event ms):')
    for form, walk, tab, _ in forms:
        for n in (R, large):
            split_table(form, walk, (tab.pack, tab.ids, tab.chunk_lo,
                                     tab.chunk_hi), *rays[form, n])

    rows = variant_rows(scene, *rays['staged', R], *rays['sweep', R], '')
    # the large step's rays: the same rows, printed only
    variant_rows(scene, *rays['staged', large], *rays['sweep', large],
                 f' at {rays["staged", large][0].shape[0]} rays')

    # the sweep against the chunk walk, through the whole queries
    z = torch.zeros(R, device=org.device)
    h1, i1, t1, _, _ = cw.intersect_chunkwalk(scene, org, d, z, mn, mx)
    h4, i4, t4, _, _ = sw.intersect_sweep(scene, org, d, z, mn, mx)
    if not torch.equal(h1, h4):
        raise AssertionError(f'sweep vs chunk walk: hit sets differ on '
                             f'{(h1 != h4).sum().item()} rays')
    if not torch.equal(t1[h1], t4[h4]):
        raise AssertionError(f'sweep vs chunk walk: t differs on '
                             f'{(t1 != t4)[h1].sum().item()} hits')
    ties = int((i1 != i4)[h1].sum())
    log(f'sweep vs chunk walk: {int(h1.sum())} hits, t equal bit for bit on '
        f'every hit, ids differ on {ties} exact ties of t')
    return rows


def far_rays(scene, n, seed):
    """n rays from the x1000 bounding sphere on the card: half the env
    map's emission rays, half aimed at random triangles' vertices."""
    from langevin_mcmc_tpu_torch.ops import lights
    dev = scene.device
    g = torch.Generator(device=dev).manual_seed(seed)
    h = n // 2
    em = lights.emit(scene,
                     torch.full((h,), scene.env_light_id, dtype=torch.int32,
                                device=dev),
                     torch.zeros(h, dtype=torch.int32, device=dev),
                     torch.rand((h, 2), generator=g, device=dev),
                     torch.rand((h, 2), generator=g, device=dev),
                     torch.zeros(h, device=dev))
    tri = torch.randint(0, scene.num_tris, (n - h,), generator=g, device=dev)
    aim = scene.tri_p[0][tri, 0]
    d = torch.randn((n - h, 3), generator=g, device=dev)
    d = d / d.norm(dim=1, keepdim=True)
    org = torch.cat([em['org'], aim - d * scene.bsphere_radius])
    return (org, torch.cat([em['dir'], d]),
            torch.full((n,), 1e-4, device=dev),
            torch.full((n,), float('inf'), device=dev))


def open_rows(scene):
    """K1/K2 on the open scene: 65,536 rays, three quarters as kernel_rays
    makes them, a quarter from the x1000 bounding sphere (far_rays),
    against their plain version. Returns the two rows (names ending in
    _open), keyed by the launch-count name, each with its miss share: the
    share of live rays the closest hit finds nothing for."""
    from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
    n = 65536
    near = kernel_rays(scene, n - n // 4, seed=17)
    far = far_rays(scene, n // 4, seed=18)
    org, d, mn, mx = (torch.cat([a, b]) for a, b in zip(near, far))
    (o, dd, rng), _ = cw.sort_rays(scene.cw, org, d, mn, mx)
    tabs = (scene.cw.pack, scene.cw.ids, scene.cw.chunk_lo, scene.cw.chunk_hi)
    chunk_idx, counts = cw._block_chunk_lists(o, dd, rng[:, 0], rng[:, 1],
                                              scene.cw.chunk_lo,
                                              scene.cw.chunk_hi)
    t = cw.walk_reference(scene.cw.pack, scene.cw.ids, chunk_idx, counts, o,
                          dd, rng, False)[0]
    live = rng[:, 1] >= rng[:, 0]
    miss = float(((t >= cw.BIG) & live).sum() / live.sum())
    nb, K = counts.shape[0], scene.cw.pack.shape[0]
    blocks_empty = int((counts == 0).sum())
    log(f'open scene kernel inputs: {o.shape[0]} rays ({n // 4} from the '
        f'bounding sphere, radius {scene.bsphere_radius:.6g}), {nb} blocks '
        f'({blocks_empty} with an empty chunk list), {K} chunks of '
        f'{cw.TRI_CHUNK} (mean list length {counts.float().mean().item():.2f}'
        f'); miss share of live rays {miss:.4f}')
    tests_c = int(counts.sum()) * cw.RAY_BLOCK * cw.TRI_CHUNK
    tests_a = int(blocks_until_occluded(scene.cw.pack, chunk_idx, counts, o,
                                        dd, rng).sum()) \
        * cw.RAY_BLOCK * cw.TRI_CHUNK
    rows = {}
    for a, key, rep in ((False, 'split_closest_hit',
                         'langevin_mcmc_tpu/ops/chunkwalk.py:157'),
                        (True, 'split_any_hit',
                         'langevin_mcmc_tpu/ops/chunkwalk.py:180')):
        name = ('chunkwalk_split_any_hit_open' if a
                else 'chunkwalk_split_closest_hit_open')
        rows[key] = kernel_row(
            name, 'langevin_mcmc_tpu_torch/csrc/chunkwalk.cu', rep,
            lambda: cw.walk_staged(*tabs, o, dd, rng, a),
            lambda: cw.walk_reference(
                scene.cw.pack, scene.cw.ids,
                *cw._block_chunk_lists(o, dd, rng[:, 0], rng[:, 1],
                                       scene.cw.chunk_lo, scene.cw.chunk_hi),
                o, dd, rng, a), a,
            tests_a if a else tests_c, nbytes(*tabs, o, dd, rng), n,
            slab_tests=nb * cw.RAY_BLOCK * K)
        rows[key]['miss_share'] = miss
    return rows


def check_generation(small_xml):
    """Bidirectional generation on the card (kernel) against the CPU (plain
    version) from the same tape: contributions agree lane by lane, up to
    a bounded number of lanes on a discrete threshold."""
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    from langevin_mcmc_tpu_torch.path import trace
    out = {}
    for dev in ('cuda', 'cpu'):
        scene, opts, _ = parse_scene(small_xml, device=dev)
        u = torch.as_tensor(np.random.default_rng(3).random(
            (2048, trace.Tape.size(opts.max_depth)), dtype=np.float32),
            device=dev)
        with torch.no_grad():
            _, con, _, _ = trace.generate_path_bidir(
                scene, opts, trace.Tape(u, opts.max_depth), min_depth=-1,
                max_depth=opts.max_depth)
        out[dev] = con.flatten()[0]['ls_score'].cpu().numpy().astype(
            np.float64)
    a, b = out['cuda'], out['cpu']
    if not np.isfinite(a).all():
        raise AssertionError('non-finite contributions on the card')
    rel = (np.abs(a - b) / np.maximum(np.abs(b), 1e-9)).max(1)
    bad = int((rel > 1e-3).sum())
    name = os.path.basename(os.path.dirname(small_xml))
    log(f'generation card vs CPU ({name}): {a.shape[0]} lanes, {bad} beyond '
        f'rtol 1e-3 (max rel {rel.max():.3g}), mean ls {a.mean():.6g} vs '
        f'{b.mean():.6g}')
    if bad > a.shape[0] // 100:
        raise AssertionError(f'{bad} lanes of card generation diverge from '
                             f'the CPU plain path')


def check_subpath_generation(small_xml):
    """generate_subpath (light coordinates on, a mix of (s, t) slots across
    lanes) on the card against the CPU from the same tape, as
    check_generation."""
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    from langevin_mcmc_tpu_torch.path import trace
    slots = [(2, 0), (3, 0), (4, 0), (5, 0), (2, 1), (3, 1), (2, 2), (1, 2),
             (1, 3), (4, 1), (1, 4)]
    n = 2048
    s = torch.as_tensor([slots[i % len(slots)][0] for i in range(n)],
                        dtype=torch.int32)
    t = torch.as_tensor([slots[i % len(slots)][1] for i in range(n)],
                        dtype=torch.int32)
    out = {}
    for dev in ('cuda', 'cpu'):
        scene, opts, _ = parse_scene(small_xml, device=dev)
        assert opts.use_light_coordinate_sampling
        u = torch.as_tensor(np.random.default_rng(4).random(
            (n, trace.Tape.size(opts.max_depth)), dtype=np.float32),
            device=dev)
        with torch.no_grad():
            rec, res = trace.generate_subpath(
                scene, opts, trace.Tape(u, opts.max_depth), s.to(dev),
                t.to(dev))
        out[dev] = (res['ls'].cpu().numpy().astype(np.float64),
                    rec.cam_bsdf_rnd.cpu().numpy())
    (a, ra), (b, rb) = out['cuda'], out['cpu']
    if not np.isfinite(a).all():
        raise AssertionError('non-finite subpath contributions on the card')
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-9)
    bad = int((rel > 1e-3).sum())
    rbad = int((np.abs(ra - rb).reshape(n, -1).max(1) > 1e-3).sum())
    log(f'generate_subpath card vs CPU (light coordinates, '
        f'{len(slots)} (s, t) slots): {n} lanes, {int((b > 0).sum())} '
        f'valid, {bad} beyond rtol 1e-3 (max rel {rel.max():.3g}), stored '
        f'parameters differ beyond 1e-3 on {rbad}, mean ls {a.mean():.6g} '
        f'vs {b.mean():.6g}')
    if bad > n // 100 or rbad > n // 100:
        raise AssertionError(f'{max(bad, rbad)} lanes of card subpath '
                             f'generation diverge from the CPU plain path')


def count_light_coords():
    """Count, from now on, the generated lanes that carry light-coordinate
    parameters (trace._shift_light_coords sees every generation's lc_ok).
    Returns the counter: a dict whose 'lanes' is a device tensor, summed
    in place (so a captured step adds at every replay)."""
    from langevin_mcmc_tpu_torch.path import trace
    shift = trace._shift_light_coords
    counter = {'lanes': torch.zeros((), dtype=torch.int64, device='cuda')}

    def counting(opts, cam_bsdf_rnd, lc_ok, lc_param):
        counter['lanes'].add_(lc_ok.any(1).sum())
        return shift(opts, cam_bsdf_rnd, lc_ok, lc_param)
    trace._shift_light_coords = counting
    return counter


def motion_rays(scene, n, seed):
    """n rays on the card at random shutter times: n/2 camera rays, n/2
    leaving points of random triangles at the ray's time in random
    directions, 30% of those dead."""
    from langevin_mcmc_tpu_torch.ops.intersect import tri_vertices_at_time
    from langevin_mcmc_tpu_torch.scene.camera import sample_primary
    dev = scene.device
    g = torch.Generator(device=dev).manual_seed(seed)
    h = n // 2
    time_ = torch.rand(n, generator=g, device=dev)
    org0, d0, mn0, mx0 = sample_primary(
        scene.camera, torch.rand((h, 2), generator=g, device=dev),
        time_[:h])
    tri = torch.randint(0, scene.num_tris, (n - h,), generator=g, device=dev)
    b = torch.rand((n - h, 2), generator=g, device=dev)
    b = torch.where((b.sum(1) > 1)[:, None], 1 - b, b)
    p = tri_vertices_at_time(scene, tri, time_[h:])
    org1 = (p[:, 0] * (1 - b.sum(1))[:, None] + p[:, 1] * b[:, :1]
            + p[:, 2] * b[:, 1:])
    d1 = torch.randn((n - h, 3), generator=g, device=dev)
    d1 = d1 / d1.norm(dim=1, keepdim=True)
    alive = torch.rand(n - h, generator=g, device=dev) >= 0.3
    mx1 = torch.where(alive, torch.full((n - h,), float('inf'), device=dev),
                      torch.zeros(n - h, device=dev))
    return (torch.cat([org0, org1]), torch.cat([d0, d1]), time_,
            torch.cat([mn0, torch.full((n - h,), 1e-4, device=dev)]),
            torch.cat([mx0, mx1]))


def motion_queries(scene):
    """One brute-force closest-hit and one any-hit query at 65,536 rays on
    the moving scene (motion_rays), CUDA-event ms, then the closest hit at
    three block sizes. Returns (closest ms, any ms) at the default."""
    from langevin_mcmc_tpu_torch.ops import intersect
    rays = motion_rays(scene, 65536, seed=23)
    live = int((rays[4] >= rays[3]).sum())
    hit = intersect.intersect_bruteforce(scene, *rays)[0]
    ms_c = cuda_ms(lambda: intersect.intersect_bruteforce(scene, *rays), 3)
    ms_a = cuda_ms(lambda: intersect.occluded_bruteforce(scene, *rays), 3)
    pairs = live * scene.num_tris
    log(f'motion brute force, 65,536 rays ({live} live, {int(hit.sum())} '
        f'hit) x {scene.num_tris} triangles: closest hit {ms_c:.1f} ms, any '
        f'hit {ms_a:.1f} ms (CUDA events); {pairs:.4g} ray-triangle pairs, '
        f'{pairs / ms_c / 1e6:.3f} Gpairs/s')
    if not hit.any():
        raise AssertionError('motion brute force: no ray hit')
    # the block of ray-triangle pairs, each size first checked equal to
    # the default
    want = intersect.intersect_bruteforce(scene, *rays)
    default = intersect.PAIR_BLOCK
    try:
        for pairs in (1 << 20, 1 << 22, 1 << 24):
            intersect.PAIR_BLOCK = pairs
            got = intersect.intersect_bruteforce(scene, *rays)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f'motion brute force: blocks of '
                                     f'{pairs} pairs change the answer')
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: intersect.intersect_bruteforce(scene, *rays),
                         3)
            log(f'  blocks of {pairs} pairs'
                f'{" (default)" if pairs == default else ""}: closest hit '
                f'{ms:.1f} ms, peak device memory '
                f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    finally:
        intersect.PAIR_BLOCK = default
    return ms_c, ms_a


class BruteForceCounter:
    """Counts the brute-force queries issued from the host while it is
    active (occluded queries call intersect_bruteforce too): queries and
    rays; outside a CUDA graph capture also live rays and host-clock
    seconds, each such query ending in a device sync. A captured step's
    queries are issued once, at its capture, as eager calls between its
    graphs, and rerun by every replay."""

    def __init__(self):
        self.calls = self.rays = self.live = 0
        self.seconds = 0.0

    def __enter__(self):
        from langevin_mcmc_tpu_torch.ops import intersect
        self.orig = orig = intersect.intersect_bruteforce

        def counting(scene, org, d, time_, min_t, max_t):
            self.calls += 1
            self.rays += org.shape[0]
            if torch.cuda.is_current_stream_capturing():
                return orig(scene, org, d, time_, min_t, max_t)
            t0 = time.time()
            out = orig(scene, org, d, time_, min_t, max_t)
            torch.cuda.synchronize()
            self.seconds += time.time() - t0
            self.live += int((max_t >= min_t).sum())
            return out
        intersect.intersect_bruteforce = counting
        return self

    def __exit__(self, *exc):
        from langevin_mcmc_tpu_torch.ops import intersect
        intersect.intersect_bruteforce = self.orig


def render(label, xml, env, sky=False, num_steps=None):
    """One render through the CLI with env set around it (with num_steps,
    through render_mlt, cut to that many chain iterations). Checks the
    film (sky: its top rows must be lit too); returns (the CLI's result,
    launch counts of this render by row key)."""
    from langevin_mcmc_tpu_torch.__main__ import main as cli_main
    from langevin_mcmc_tpu_torch.integrators.mlt import render_mlt
    from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
    from langevin_mcmc_tpu_torch.ops import sweep_isect as sw
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    torch.cuda.reset_peak_memory_stats()
    cw.reset_launch_counts()
    sw.reset_launch_counts()
    try:
        if num_steps is None:
            res = cli_main([xml, '--spp', '1', '--chunk', str(CHUNK),
                            '--output-dir', os.path.join(OUT, label),
                            '--device', 'cuda'])[0]
        else:
            t0 = time.time()
            scene, opts, _ = parse_scene(xml, device='cuda')
            gen = torch.Generator(device='cuda').manual_seed(
                opts.seed_offset)
            res = dict(opts=opts, timings={})
            with torch.no_grad():
                film, res['b'] = render_mlt(scene, opts, gen,
                                            num_steps=num_steps, chunk=CHUNK,
                                            timings=res['timings'])
            res['film'] = film.cpu().numpy()
            res['seconds'] = time.time() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = dict(cw.launch_counts)
    launches.update({'sweep_' + k: v for k, v in sw.launch_counts.items()})
    log(f'{label}: {env or "default backends"}; total {res["seconds"]:.2f} '
        f's, peak device memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    log(f'{label}: kernel launches {launches}')
    check_film(label, res['film'], sky)
    return res, launches


def check_film(label, film, sky=False):
    """The film must be finite, non-negative, non-zero and 768x1024x3 (sky:
    its top rows lit too)."""
    log(f'{label}: film {film.shape}, mean {film.mean():.6g}, min '
        f'{film.min():.6g}, max {film.max():.6g}')
    if film.shape != (768, 1024, 3):
        raise AssertionError(f'{label}: film shape {film.shape}')
    if not np.isfinite(film).all():
        raise AssertionError(f'{label}: non-finite film')
    if film.min() < 0.0:
        raise AssertionError(f'{label}: negative film values')
    if not film.mean() > 0.0:
        raise AssertionError(f'{label}: film is zero')
    if sky:
        top = float(film[:32].mean())
        log(f'{label}: sky (mean of the top 32 rows) {top:.6g}')
        if not top > 0.0:
            raise AssertionError(f'{label}: the sky is dark')


def chain_rate(label, res):
    """Print a render's phase times, proposals/s and acceptance rate;
    returns the chain loop's proposals/s."""
    tm = res['timings']
    graph_line(label, tm)
    proposals = tm['steps'] * res['opts'].num_chains
    props = proposals / tm['loop_s']
    log(f'{label}: b = {res["b"]:.6g}; direct {tm["direct_s"]:.2f} s, '
        f'bootstrap {tm["bootstrap_s"]:.2f} s, chain loop {tm["loop_s"]:.2f} '
        f's ({tm["steps"]} iterations, {tm["loop_s"] / tm["steps"] * 1e3:.1f} '
        f'ms each), {props:.1f} proposals/s, acceptance '
        f'{tm["accepts"] / proposals:.4f} ({tm["accepts"]} of {proposals})')
    return props


def graph_line(label, tm):
    """A render's captured chain loop (render_mlt's timings): graphs a
    step, the eager calls between them (named), the cond_call branches
    and how often they ran and were skipped, their nodes, the capture and
    instantiate seconds, n_done against the iterations scheduled, which
    must be equal; and the ms of the render's first iteration (eager, the
    process's first step of this configuration: lazy set-up included, so
    no eager time to compare: that is the graph phase's) beside its
    replays (the chain loop less the warm-ups, the capturing iterations
    and the cache merges, over the iterations left). Returns the replays'
    ms an iteration, or None."""
    scheduled = tm.get('calls', tm['steps'] // tm['n_inner']) * tm['n_inner']
    replays = tm['steps'] - 2 * tm.get('warmups', 0)
    captured = None
    if tm.get('warmups') and replays > 0:
        first = tm['warmup_s'] / tm['warmups'] * 1e3
        captured = (tm['loop_s'] - tm['warmup_s'] - tm['capture_pass_s']
                    - tm.get('merge_s', 0.0)) / replays * 1e3
        log(f'{label}: first iteration (eager warm-up, lazy set-up '
            f'included) {first:.1f} ms; replays {captured:.1f} ms an '
            f'iteration ({replays} of them); the capturing iteration '
            f'{tm["capture_pass_s"]:.2f} s')
    log(f'{label}: chain loop from CUDA graphs: {tm.get("graphs", 0)} '
        f'graph(s) a step, {tm.get("eager_calls", 0)} eager call(s) between '
        f'them {tm.get("eager_fns", [])}, {tm.get("branches", 0)} '
        f'cond_call branch(es) (ran {tm.get("branch_runs", 0)}, skipped '
        f'{tm.get("branch_skips", 0)}), {tm.get("graph_nodes", 0)} nodes; '
        f'capture {tm.get("capture_s", 0.0):.2f} s, instantiate '
        f'{tm.get("instantiate_s", 0.0):.2f} s; n_done {tm["n_done"]} of '
        f'{scheduled} iterations scheduled (calls of {tm["n_inner"]})')
    if tm.get('graphs', 0) < 1:
        raise AssertionError(f'{label}: the chain loop ran no CUDA graph')
    if tm['n_done'] != scheduled or tm['steps'] != scheduled:
        raise AssertionError(f'{label}: n_done {tm["n_done"]}, steps '
                             f'{tm["steps"]}, scheduled {scheduled}')
    return captured


def large_step_line(label, res, lc_counter):
    """Path E's large-step lanes per branch, cache rows and
    light-coordinate lanes."""
    tm = res['timings']
    log(f'{label}: large-step lanes {tm["large"]} (multiplexed {tm["mmlt"]}, '
        f'cache {tm["cache"]}, cache accepts {tm["cache_accepts"]}); cache '
        f'rows full at the end {tm["cache_rows_ready"]} of '
        f'{res["opts"].pss_max_length + 1}; generated lanes with '
        f'light-coordinate parameters {int(lc_counter["lanes"])} '
        f'(bootstrap and large steps); snapshot writes {tm["report_s"]:.2f} s')
    if tm['large'] <= 0 or tm['mmlt'] <= 0:
        raise AssertionError(f'{label}: no multiplexed large step ran')
    if int(lc_counter['lanes']) <= 0:
        raise AssertionError(f'{label}: no lane took light coordinates')


def cache_bytes(cache):
    """(bytes the global cache holds, bytes of its path store)."""
    def tensors(obj):
        return [x for x in (getattr(obj, f.name)
                            for f in dataclasses.fields(obj))
                if isinstance(x, torch.Tensor)]
    rec = nbytes(*tensors(cache.rec))
    return nbytes(*tensors(cache)) + rec, rec


def prefill_cache(banked, opts, times=2):
    """The banked state with every seed state (path included) pushed into
    the cache `times` times: the rows of the dimensions with at least
    pss_max_size / times seeds fill (on the box, every row a seed state
    reaches, so that each lane starts in the cache phase)."""
    from langevin_mcmc_tpu_torch.mcmc import cache as cache_mod
    from langevin_mcmc_tpu_torch.path.records import get_path_pss, pss_dim
    st = banked.state
    C, Dm = opts.num_chains, 2 * opts.max_depth
    dev = st.ls_score.device
    zero = torch.zeros((C, Dm), device=dev)
    cache = banked.cache
    for _ in range(times):
        cache = cache_mod.push_batch(
            cache, pss_dim(st.rec), get_path_pss(st.rec, Dm), zero, zero,
            st.ls_score, torch.ones(C, dtype=torch.bool, device=dev), opts,
            s_tag=st.rec.cam_depth, t_tag=st.rec.lgt_depth, rec=st.rec)
    return dataclasses.replace(banked, cache=cache)


def sync_free(fn):
    """fn() under torch.cuda.set_sync_debug_mode('error'): any host sync
    raises, but in the calls a captured step makes between its graphs
    (ops/graphs.eager_call: H2MC's eigh, the motion brute force), which
    run with the mode off."""
    from langevin_mcmc_tpu_torch.mcmc import gaussian
    from langevin_mcmc_tpu_torch.ops import graphs, intersect
    users = (gaussian, intersect)

    def off(f, *a):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return graphs.eager_call(f, *a)
        finally:
            torch.cuda.set_sync_debug_mode('error')
    for m in users:
        m.eager_call = off
    torch.cuda.set_sync_debug_mode('error')
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        for m in users:
            m.eager_call = graphs.eager_call


def all_launches():
    """Every kernel wrapper's launch counts, by module."""
    from langevin_mcmc_tpu_torch.ops import bvh, chunkwalk, sweep_isect
    return {m.__name__.rsplit('.', 1)[1]: dict(m.launch_counts)
            for m in (chunkwalk, sweep_isect, bvh)}


def reset_launches():
    from langevin_mcmc_tpu_torch.ops import bvh, chunkwalk, sweep_isect
    for m in (chunkwalk, sweep_isect, bvh):
        m.reset_launch_counts()


def timed(fn):
    """(fn(), host seconds) between two device syncs."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def unconditional(flag, fn, *args):
    """ops/graphs.cond_call as it runs outside a capture: the branch on
    every call, selected on the device (what a captured step ran before
    cond_call captured its branches apart)."""
    out = fn(*args)
    sel = lambda o: torch.where(flag, o, torch.zeros_like(o))
    return tuple(map(sel, out)) if isinstance(out, tuple) else sel(out)


def graph_parity(label, xml, prefill=False, steps=8, env=None, bvh=False):
    """From one bootstrapped state and one generator state at full width:
    `steps` iterations of the eager step (make_mlt_step, under sync_free:
    no host sync outside eager_call), then the same through one call of
    make_mlt_multi_step (the warm-up, the capture, replays). The chain
    state must be equal bit for bit, step.counts and every kernel's
    launches equal; the film is held to rtol 1e-5 (index_add_ splats with
    atomics). Then one more call of the multi-step (all replays) from
    where it stood, timed: eager (the first `steps`, run after the path's
    render in this process, so warm) and captured ms an iteration side by
    side. env: environment variables set around it (path B's backend);
    bvh: attach a BVH (path I). prefill: path E's configuration with the
    seed states (paths included) pushed twice into the cache, so that
    every row they reach is full: the cache-seeded large step and the
    cache phase run from the first iteration (it must take the cache
    branch) and no lane needs a gradient; the same replays are also timed
    with the gradient branches unconditional (computed and selected, as
    before cond_call), in this call. Returns (eager ms, captured ms)."""
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    from langevin_mcmc_tpu_torch.ops import bvh as bvh_mod
    env = env or {}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        scene, opts, _ = parse_scene(xml, device='cuda')
        if bvh:
            scene = bvh_mod.attach_bvh(scene)
        return _graph_parity(label, scene, opts, prefill, steps)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _graph_parity(label, scene, opts, prefill, steps):
    from langevin_mcmc_tpu_torch.integrators import mlt
    from langevin_mcmc_tpu_torch.mcmc import chain
    from langevin_mcmc_tpu_torch.utils.tree import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device='cuda').manual_seed(2)
    C = opts.num_chains
    shape = (scene.height, scene.width, 3)
    with torch.no_grad():
        (b, ld, init), t_boot = timed(lambda: mlt.bootstrap(
            scene, opts, gen, chunk=CHUNK))
        banked0 = mlt.attach_cache(init, opts)
        if prefill:
            banked0 = prefill_cache(banked0, opts)
            cache = banked0.cache
            total, rec_bytes = cache_bytes(cache)
            ready = int((cache.count >= cache.size).sum())
            log(f'{label}: {ready} of {cache.count.shape[0]} cache rows full '
                f'after the pre-fill (counts {cache.count.tolist()}); cache '
                f'{total / 2**20:.1f} MiB, of which stored paths '
                f'{rec_bytes / 2**20:.1f} MiB')
            if ready == 0:
                raise AssertionError(f'{label}: the pre-fill filled no row')
        lsp = opts.large_step_probability
        state0 = gen.get_state()
        step = mlt.make_mlt_step(scene, opts, b, lsp, length_dist=ld)
        film_e = torch.zeros(shape, device='cuda')

        def eager(banked, film, n):
            for _ in range(n):
                banked = step(gen, banked, film, init)
            return banked
        reset_launches()
        want, t_e = timed(lambda: sync_free(
            lambda: eager(banked0, film_e, steps)))
        launches_e = all_launches()
        gen.set_state(state0)
        multi = mlt.make_mlt_multi_step(scene, opts, b, lsp, steps,
                                        length_dist=ld)
        reset_launches()
        (got, film_c, n_done), t_c1 = timed(lambda: multi(
            gen, banked0, torch.zeros(shape, device='cuda'), init))
        launches_c = all_launches()
        differ = [i for i, (a, c) in enumerate(zip(tree_leaves(want.state),
                                                   tree_leaves(got.state)))
                  if not torch.equal(a, c)]
        counts_e = {k: int(v) for k, v in step.counts.items()}
        counts_c = {k: int(v) for k, v in multi.step.counts.items()}
        bit_film = torch.equal(film_e, film_c)
        film_err = float(((film_e - film_c).abs()
                          / film_e.abs().clamp(min=1e-30)).max())
        film_ok = torch.allclose(film_c, film_e, rtol=1e-5, atol=0.0)
        cache_same = (want.cache is None or all(
            torch.equal(a, c) for a, c in zip(tree_leaves(want.cache),
                                              tree_leaves(got.cache))))
        g = multi.graphs
        log(f'{label}: {steps} eager iterations (no host sync outside the '
            f'eager calls) and the same {steps} through the multi-step '
            f'({len(g.graphs)} graph(s), {len(g.calls)} eager call(s), '
            f'{len(g.branches)} cond_call branch(es): ran {g.branch_runs}, '
            f'skipped {g.branch_skips}; {sum(g.nodes)} nodes; capture '
            f'{g.capture_s:.2f} s, instantiate {g.instantiate_s:.2f} s) from '
            f'one state: n_done {int(n_done)}; chain state '
            f'{"bit for bit" if not differ else f"leaves {differ} differ"}; '
            f'cache {"equal" if cache_same else "differs"}; counts '
            f'{counts_e} vs {counts_c}; film '
            f'{"bit for bit" if bit_film else f"max rel diff {film_err:.3g}"}'
            f'; launches {launches_e} vs {launches_c}; bootstrap '
            f'{t_boot:.2f} s')
        if differ or counts_e != counts_c or not film_ok \
                or int(n_done) != steps or launches_e != launches_c:
            raise AssertionError(f'{label}: captured and eager iterations '
                                 f'differ')
        if prefill and counts_e['cache'] <= 0:
            raise AssertionError(f'{label}: no lane took the cache branch')
        (_, _, n2), t_c2 = timed(lambda: multi(gen, got, film_c, init))
        uncond_ms = None
        if prefill:
            orig = chain.cond_call
            chain.cond_call = unconditional
            try:
                m2 = mlt.make_mlt_multi_step(scene, opts, b, lsp, steps,
                                             length_dist=ld)
                m2(gen, banked0, torch.zeros(shape, device='cuda'), init)
                _, t_u = timed(lambda: m2(gen, banked0, torch.zeros(
                    shape, device='cuda'), init))
            finally:
                chain.cond_call = orig
            uncond_ms = t_u / steps * 1e3
    ms_e, ms_c = t_e / steps * 1e3, t_c2 / steps * 1e3
    log(f'{label}: eager {ms_e:.1f} ms an iteration, captured {ms_c:.1f} ms '
        f'an iteration (replays; n_done {int(n2)}), eager / captured '
        f'{ms_e / ms_c:.3f}; {C / ms_e * 1e3:.1f} vs {C / ms_c * 1e3:.1f} '
        f'proposals/s; first call of the multi-step (warm-up, capture, '
        f'replays) {t_c1:.2f} s; peak device memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    if int(n2) != steps:
        raise AssertionError(f'{label}: n_done {int(n2)} of {steps}')
    if uncond_ms is not None:
        log(f'{label}: with the gradient branches skipped (cond_call) '
            f'{ms_c:.1f} ms a replayed iteration; with them computed and '
            f'selected (unconditional) {uncond_ms:.1f} ms; '
            f'{uncond_ms / ms_c:.3f}x')
    return ms_e, ms_c


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def host_ms(fn, repeats=3):
    """Median milliseconds of fn() over repeats on the host clock, each
    ending in a device sync, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    return float(np.median(times))


def push_random(cache, opts, seed):
    """cache with a seeded batch of random entries pushed into its rows
    (about a third of each row's slots)."""
    from langevin_mcmc_tpu_torch.mcmc import cache as cache_mod
    g = torch.Generator(device='cuda').manual_seed(seed)
    Dm = 2 * opts.max_depth
    n = opts.pss_max_size * (opts.pss_max_length + 1) // 3
    u = lambda *sh: torch.rand(sh, generator=g, device='cuda')
    dims = torch.randint(opts.pss_min_length, opts.pss_max_length + 1, (n,),
                         generator=g, device='cuda', dtype=torch.int32)
    return cache_mod.push_batch(
        cache, dims, u(n, Dm), u(n, Dm), u(n, Dm), u(n) + 0.1,
        torch.ones(n, dtype=torch.bool, device='cuda'), opts,
        s_tag=dims // 2, t_tag=dims - dims // 2)


def nccl_phase(xml_e):
    """A one-rank NCCL process group on the card: global_sum, the cache
    merger (its all-gather of CUDA tensors) on two caches of path E's
    cache shape with different tails, twice, each time against
    merge_stacked on the CPU bit for bit, and the film all-reduce. Prints
    the backend and each collective's ms."""
    import torch.distributed as dist
    from langevin_mcmc_tpu_torch.mcmc import cache as cache_mod
    from langevin_mcmc_tpu_torch.parallel import multihost
    from langevin_mcmc_tpu_torch.parallel import shardmap_step as sm
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene_host
    from langevin_mcmc_tpu_torch.utils.tree import tree_leaves
    opts = parse_scene_host(xml_e)[1]
    dist.init_process_group('nccl', init_method=f'tcp://127.0.0.1:'
                            f'{free_port()}', world_size=1, rank=0)
    try:
        x = np.arange(40, dtype=np.float64) * 0.1
        if not np.array_equal(multihost.global_sum(x), x):
            raise AssertionError('NCCL global_sum at one rank changed its '
                                 'input')
        ms_sum = host_ms(lambda: multihost.global_sum(x))
        empty = cache_mod.make_cache(opts, 2 * opts.max_depth, 'cuda')
        caches = [push_random(empty, opts, 11), push_random(empty, opts, 12)]
        prev = torch.zeros_like(empty.count)
        for rnd in range(2):
            want = sm.merge_stacked(sm.stack_cache(caches, 'cpu'), prev.cpu())
            got, count = sm.merge_caches(caches, prev)
            w = tree_leaves(want)
            for c in got:
                if not all(torch.equal(a.cpu(), b)
                           for a, b in zip(tree_leaves(c), w)):
                    raise AssertionError(f'NCCL cache merge, round {rnd}: '
                                         f'differs from merge_stacked on '
                                         f'the CPU')
            ms = host_ms(lambda: sm.merge_caches(caches, prev))
            gathered = sum(a.numel() * a.element_size() for a in w) * 2
            log(f'NCCL phase: cache merge round {rnd}, 2 shards (rows '
                f'{prev.tolist()} -> {count.tolist()}): equal to '
                f'merge_stacked on the CPU bit for bit; {ms:.3f} ms, '
                f'{gathered / 2**20:.1f} MiB gathered')
            prev = count
            caches = [push_random(c, opts, 21 + 2 * rnd + i)
                      for i, c in enumerate(got)]
        film = torch.rand((768, 1024, 3), device='cuda')
        ref = film.clone()
        multihost.all_reduce_sum(film)
        if not torch.equal(film, ref):
            raise AssertionError('NCCL all-reduce at one rank changed the '
                                 'film')
        ms_red = cuda_ms(lambda: multihost.all_reduce_sum(film))
        log(f'NCCL phase: backend {multihost.backend()}, world '
            f'{multihost.process_count()}; global_sum {ms_sum:.3f} ms, film '
            f'all-reduce (768x1024x3 f32) {ms_red:.3f} ms')
    finally:
        dist.destroy_process_group()


def ptxas_lines(source, kernel):
    """(name, registers, stack frame, spill stores, spill loads, shared
    memory) of each instantiation of `kernel` in ptxas's report of
    `source` (the library's build; empty for a cached build)."""
    import re
    from langevin_mcmc_tpu_torch.ops import cuda_build
    text = cuda_build.build_info.get('ptxas', {}).get(source, '')
    out = []
    for block in text.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if kernel not in name:
            continue
        num = lambda pat: int((re.search(pat, block) or [0, 0])[1])
        out.append(dict(
            name=name, registers=num(r'Used (\d+) registers'),
            stack_bytes=num(r'(\d+) bytes stack frame'),
            spill_stores=num(r'(\d+) bytes spill stores'),
            spill_loads=num(r'(\d+) bytes spill loads'),
            smem_bytes=num(r'(\d+) bytes smem')))
    return out


def bvh_work(stats, live):
    """Per-ray work the plain version counted: (inner nodes and triangles
    a live ray: mean, 99th percentile, max), and the divergence: the mean
    over warps (32 rays in launch order) of the most loop steps (inner
    nodes + leaves) of a lane over the warp's mean."""
    out = {}
    for key in ('inner', 'tests'):
        x = stats[key][live].double()
        out[key] = (float(x.mean()), float(torch.quantile(x, 0.99)),
                    int(x.max()))
    steps = (stats['inner'] + stats['leaves']).double()
    pad = -steps.numel() % 32
    w = torch.cat([steps, steps.new_full((pad,), float('nan'))]).view(-1, 32)
    ratio = w.nan_to_num(0).amax(1) / w.nanmean(1)
    out['divergence'] = float(ratio.mean())
    out['max_steps'] = int(steps.max())
    return out


def bvh_row(name, scene, rays, any_hit, static_rows):
    """The BVH kernel on these rays against its plain version (bit for
    bit), timed, with its bound from the nodes and triangles the plain
    version visits, the spread of that work and its divergence within a
    warp; on a static scene beside K1/K2 on the same rays (kernel alone,
    and the whole queries). Returns the row of the kernels JSON line."""
    from langevin_mcmc_tpu_torch.ops import bvh
    from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
    org, d, tm, mn, mx = rays
    tabs = (scene.bvh_nodes, scene.bvh_prim_ids, scene.tri_p)
    kernel = lambda: bvh.traverse(*tabs, *rays, any_hit, scene.has_motion,
                                  scene.bvh_packed)
    stats = {}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    plain_out = bvh.traverse_reference(*tabs, *rays, any_hit,
                                       scene.has_motion, stats=stats)
    ev[1].record()
    got = kernel()
    torch.cuda.synchronize()
    # one plain run, timed by CUDA events: it takes seconds on the moving
    # scene, and its host syncs (a compaction each round) are in the span
    plain_ms = ev[0].elapsed_time(ev[1])
    if any_hit:
        want = torch.isfinite(plain_out)
        if not torch.equal(got, want):
            raise AssertionError(f'{name}: occlusion differs on '
                                 f'{(got != want).sum().item()} rays')
    else:
        for a, b, f in zip(got, plain_out, 'tiuv'):
            if not torch.equal(a, b):
                raise AssertionError(f'{name}: {f} differs on '
                                     f'{(a != b).sum().item()} rays')
    ms = cuda_ms(kernel)
    ms_launches = cuda_ms_launches(kernel)
    live = mx >= mn
    n_live = int(live.sum())
    # the bound counts every ray's work (a dead ray still tests the root's
    # children); the per-ray counts are over the live rays
    ops = 2 * OPS_PER_SLAB * int(stats['inner'].sum()) + int(
        stats['tests'].sum()) * (OPS_PER_MT
                                 + (OPS_PER_LERP if scene.has_motion else 0))
    work = bvh_work(stats, live)
    tri_bytes = nbytes(scene.tri_p) // (1 if scene.has_motion else 2)
    in_bytes = nbytes(scene.bvh_nodes, scene.bvh_prim_ids, *rays) + tri_bytes
    out_bytes = org.shape[0] * (1 if any_hit else 16)
    ops_ms = ops / PEAK_F32 * 1e3
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
    bound_ms, bound_by = (ops_ms, 'operations') if ops_ms >= bytes_ms \
        else (bytes_ms, 'bytes')
    (i_mean, i_p99, i_max), (t_mean, t_p99, t_max) = (work['inner'],
                                                      work['tests'])
    line = (f'{name}, {org.shape[0]} rays ({n_live} live): equal to the '
            f'plain version; kernel {ms:.3f} ms (back to back '
            f'{ms_launches:.3f} ms), plain '
            f'{plain_ms:.1f} ms; '
            f'inner nodes a live ray {i_mean:.2f} (p99 {i_p99:.0f}, max '
            f'{i_max}), triangles {t_mean:.2f} (p99 {t_p99:.0f}, max '
            f'{t_max}); divergence {work["divergence"]:.3f} (mean over '
            f'warps of the most steps of a lane / the warp\'s mean; most '
            f'steps of a ray {work["max_steps"]}); bound {bound_ms:.4f} ms '
            f'({bound_by})')
    row = dict(name=name, route='cuda',
               source='langevin_mcmc_tpu_torch/csrc/bvh.cu',
               replaces='langevin_mcmc_tpu/ops/bvh.py:146', pallas=False,
               max_abs_err=0.0, ms=ms, ms_launches=ms_launches,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=None, inner_per_live_ray=i_mean, inner_p99=i_p99, inner_max=i_max,
               tests_per_live_ray=t_mean, tests_p99=t_p99, tests_max=t_max,
               divergence=work['divergence'], max_steps=work['max_steps'])
    if static_rows:
        (o, dd, rng), order = cw.sort_rays(scene.cw, org, d, mn, mx)
        cw_tabs = (scene.cw.pack, scene.cw.ids, scene.cw.chunk_lo,
                   scene.cw.chunk_hi)
        k1 = cuda_ms(lambda: cw.walk_staged(*cw_tabs, o, dd, rng, any_hit))
        q_fn = bvh.occluded_bvh if any_hit else bvh.intersect_bvh
        c_fn = cw.occluded_chunkwalk if any_hit else cw.intersect_chunkwalk
        q_bvh = cuda_ms(lambda: q_fn(scene, *rays))
        q_cw = cuda_ms(lambda: c_fn(scene, *rays))
        line += (f'; {"K2" if any_hit else "K1"} kernel on the same rays '
                 f'{k1:.3f} ms; whole query: BVH {q_bvh:.3f} ms, chunk walk '
                 f'(sort_rays + kernel) {q_cw:.3f} ms')
        row.update(k_walk_ms=k1, query_ms=q_bvh, query_chunkwalk_ms=q_cw)
    log(line)
    return row


LARGE_RAYS = int(0.05 * 65536 * 1.3) + 1   # the large step's 4,260 rays


def bvh_rays(tag, scene):
    """The BVH phase's 65,536 rays (org, d, time, min_t, max_t) of a scene:
    the box's are check_kernels', the open scene's open_rows', the moving
    scene's motion_queries'."""
    if tag == 'box':
        org, d, mn, mx = kernel_rays(scene, 65536, seed=7)
        return org, d, torch.zeros_like(mn), mn, mx
    if tag == 'open':
        near = kernel_rays(scene, 65536 - 16384, seed=17)
        far = far_rays(scene, 16384, seed=18)
        org, d, mn, mx = (torch.cat([a, b]) for a, b in zip(near, far))
        return org, d, torch.zeros_like(mn), mn, mx
    return motion_rays(scene, 65536, seed=23)


def bvh_phase(xml, xml_open, xml_f):
    """The BVH on the box, the open scene and the moving open scene: its
    numpy and native builds and pack_bvh timed; ptxas's registers, stack
    and spills of each kernel instantiation; the kernel against its plain
    version (closest and any hit, at 65,536 and 4,260 rays; the rays of
    check_kernels, open_rows and motion_queries); on the moving scene the
    whole BVH query beside the motion brute force. Returns the rows of
    the kernels JSON line (65,536 rays), keyed by (variant, scene)."""
    from langevin_mcmc_tpu_torch.native import build_bvh_native
    from langevin_mcmc_tpu_torch.native import load_library as load_native
    from langevin_mcmc_tpu_torch.ops import bvh, intersect
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    ptxas = ptxas_lines('bvh.cu', 'bvh_kernel')
    for k in ptxas:
        log(f'BVH kernel ptxas: {k["name"]}: {k["registers"]} registers, '
            f'{k["stack_bytes"]} bytes stack frame, {k["spill_stores"]} / '
            f'{k["spill_loads"]} bytes spill stores / loads, '
            f'{k["smem_bytes"]} bytes static shared memory')
    if not ptxas:
        log('BVH kernel ptxas: not reported (the library was cached)')
    rows = {}
    for tag, path in (('box', xml), ('open', xml_open), ('motion', xml_f)):
        scene, _, _ = parse_scene(path, device='cuda')
        t0 = time.time()
        scene = bvh.attach_bvh(scene)
        torch.cuda.synchronize()
        t_np = time.time() - t0
        t0 = time.time()
        packed = bvh.pack_bvh(scene.bvh_nodes, scene.bvh_prim_ids,
                              scene.tri_p)
        torch.cuda.synchronize()
        t_pack = time.time() - t0
        tp = scene.tri_p.cpu().numpy()
        load_native()       # the g++ build at first use, not timed here
        t0 = time.time()
        nodes, prims = build_bvh_native(tp.min(axis=(0, 2)),
                                        tp.max(axis=(0, 2)))
        t_nat = time.time() - t0
        same = np.array_equal(nodes, scene.bvh_nodes.cpu().numpy()) and \
            np.array_equal(prims, scene.bvh_prim_ids.cpu().numpy())
        log(f'BVH {tag}: {scene.num_tris} triangles, '
            f'{scene.bvh_nodes.shape[0]} nodes '
            f'({packed.records.shape[0]} records, '
            f'{packed.records.numel() * 4} bytes), '
            f'{bvh.tree_depth(scene.bvh_nodes.cpu().numpy())} levels; '
            f'attach_bvh (build_bvh in numpy + pack_bvh) {t_np:.2f} s, '
            f'pack_bvh alone {t_pack:.4f} s, build_bvh_native {t_nat:.3f} s '
            f'(same nodes: {same})')
        del packed
        org, d, tm, mn, mx = bvh_rays(tag, scene)
        for n in (65536, LARGE_RAYS):
            rays = tuple(x[:n].contiguous() for x in (org, d, tm, mn, mx))
            for any_hit in (False, True):
                key = 'any_hit' if any_hit else 'closest_hit'
                row = bvh_row(f'bvh_{key}_{tag}', scene, rays, any_hit,
                              tag != 'motion')
                row['pack_s'] = t_pack
                row['ptxas'] = [k for k in ptxas
                                if (('Lb1ELb' if tag == 'motion' else
                                     'Lb0ELb') + ('1E' if any_hit else '0E'))
                                in k['name']]
                if n == 65536:
                    rows[key, tag] = row
                else:
                    rows[key, tag]['large_step'] = {
                        k: row[k] for k in ('ms', 'ms_launches', 'bound_ms',
                                            'plain_ms',
                                            'inner_per_live_ray',
                                            'tests_per_live_ray', 'inner_max',
                                            'tests_max', 'divergence')}
        if tag == 'motion':
            rays = (org, d, tm, mn, mx)
            q = {}
            for a, fb, fq in ((False, intersect.intersect_bruteforce,
                               bvh.intersect_bvh),
                              (True, intersect.occluded_bruteforce,
                               bvh.occluded_bvh)):
                q[a] = (cuda_ms(lambda: fq(scene, *rays)),
                        cuda_ms(lambda: fb(scene, *rays), 1))
            log(f'BVH motion, 65,536 rays: whole query closest / any hit '
                f'BVH {q[False][0]:.3f} / {q[True][0]:.3f} ms, motion brute '
                f'force {q[False][1]:.1f} / {q[True][1]:.1f} ms: '
                f'{q[False][1] / q[False][0]:.1f}x / '
                f'{q[True][1] / q[True][0]:.1f}x')
        del scene
    return rows


def rank_main(argv):
    """One rank of path H (chip_smoke.py --rank OUT CLI-ARGS...): the CLI
    with its multi-process flags; saves the film, the reduced chain film,
    b, the timings, the walk launches and the peak device memory under
    OUT.npz / OUT.json."""
    sys.path.insert(0, HERE)
    from langevin_mcmc_tpu_torch.__main__ import main as cli_main
    from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
    out, args = argv[0], argv[1:]
    cw.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res = cli_main(args)[0]
    np.savez(out + '.npz', film=res['film'], chain_film=res['chain_film'],
             b=np.float64(res['b']))
    with open(out + '.json', 'w') as f:
        json.dump(dict(
            timings={k: v for k, v in res['timings'].items()
                     if isinstance(v, (int, float))},
            launches=dict(cw.launch_counts), seconds=res['seconds'],
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            num_chains=res['opts'].num_chains), f)


def path_h(xml_e, rate_e, spp=6):
    """Path H: path E's configuration rendered by two ranks of the CLI
    (--coordinator, --num-processes 2, --process-id 0/1) that share the
    card (so the collectives take gloo), each with half the chains and
    half the bootstrap samples; spp 6 asks for 72 iterations, which the
    loop runs as the JAX package's does, in whole calls of 16: 80
    iterations, with one cache merge after the fourth call, each call's
    chain loop from CUDA graphs. Checks every rank's film, the
    ranks' reduced chain films bit for bit and their b, their final films
    to rtol 1e-5 (each rank's direct pass splats with atomics), the merge
    and K1/K2 on both ranks."""
    coord = f'127.0.0.1:{free_port()}'
    base = os.path.join(OUT, 'path_h')
    os.makedirs(base, exist_ok=True)
    procs, logs = [], []
    for r in range(2):
        logs.append(open(os.path.join(base, f'rank{r}.log'), 'w'))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), '--rank',
             os.path.join(base, f'rank{r}'), xml_e, '--spp', str(spp),
             '--chunk', str(CHUNK), '--device', 'cuda',
             '--output-dir', os.path.join(base, f'out{r}'),
             '--coordinator', coord, '--num-processes', '2',
             '--process-id', str(r)],
            stdout=logs[-1], stderr=subprocess.STDOUT))
    t0 = time.time()
    try:
        codes = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.time() - t0
    for r in range(2):
        with open(os.path.join(base, f'rank{r}.log')) as f:
            text = f.read()
        for line in text.splitlines():
            if line.startswith('distributed:'):
                log(f'path H rank {r}: {line}')
        if codes[r] != 0:
            raise AssertionError(f'path H rank {r} exited {codes[r]}:\n'
                                 f'{text[-3000:]}')
    res = []
    for r in range(2):
        z = np.load(os.path.join(base, f'rank{r}.npz'))
        with open(os.path.join(base, f'rank{r}.json')) as f:
            res.append((z, json.load(f)))
    rates = []
    for r, (z, js) in enumerate(res):
        tm = js['timings']
        local = js['num_chains'] // tm['world']
        props = tm['steps'] * local / tm['loop_s']
        rates.append(props)
        check_film(f'path H rank {r}', z['film'])
        log(f'path H rank {r}: b = {float(z["b"]):.6g}; bootstrap '
            f'{tm["bootstrap_s"]:.2f} s, direct {tm["direct_s"]:.2f} s, chain '
            f'loop {tm["loop_s"]:.2f} s ({tm["steps"]} iterations, '
            f'{tm["loop_s"] / tm["steps"] * 1e3:.1f} ms each), '
            f'{props:.1f} proposals/s, acceptance '
            f'{tm["accepts"] / (tm["steps"] * local):.4f}; peak device '
            f'memory {js["peak_gib"]:.2f} GiB; {tm["merges"]} cache merges, '
            f'{tm["merge_s"] * 1e3 / max(tm["merges"], 1):.1f} ms each, '
            f'{tm["merge_bytes"] / 2**20:.1f} MiB gathered; film reduce '
            f'{tm["reduce_s"] * 1e3:.1f} ms; kernel launches '
            f'{js["launches"]}; CLI total {js["seconds"]:.2f} s')
        graph_line(f'path H rank {r}', tm)
        if tm['merges'] < 1:
            raise AssertionError(f'path H rank {r}: no cache merge ran')
        if tm['steps'] != -(-spp * 1024 * 768 // js['num_chains'] // 16) * 16:
            raise AssertionError(f'path H rank {r}: {tm["steps"]} iterations')
        if min(js['launches']['split_closest_hit'],
               js['launches']['split_any_hit']) <= 0:
            raise AssertionError(f'path H rank {r}: K1/K2 not launched')
    (z0, _), (z1, _) = res
    if not np.array_equal(z0['chain_film'], z1['chain_film']):
        raise AssertionError('path H: the ranks\' reduced chain films differ')
    if float(z0['b']) != float(z1['b']):
        raise AssertionError('path H: the ranks\' b differ')
    np.testing.assert_allclose(z0['film'], z1['film'], rtol=1e-5, atol=1e-6)
    log(f'path H: chain films bit-identical on both ranks, b equal, final '
        f'films within rtol 1e-5 (max |diff| '
        f'{np.abs(z0["film"] - z1["film"]).max():.3g}); both ranks '
        f'{wall:.1f} s wall; summed proposals/s {sum(rates):.1f} / path E '
        f'{rate_e:.1f} = {sum(rates) / rate_e:.3f}')
    return res


def path_i(xml_f, rate_f, rate_d):
    """Path I: path F's configuration (the moving open scene, --spp 1)
    with a BVH attached, through the API (neither package's CLI attaches
    one): parse_scene, attach_bvh, render_mlt. No query may take the
    brute force or a walk kernel; the BVH kernel must launch. Returns the
    BVH launch counts."""
    from langevin_mcmc_tpu_torch.integrators.mlt import render_mlt
    from langevin_mcmc_tpu_torch.ops import bvh
    from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
    from langevin_mcmc_tpu_torch.ops import sweep_isect as sw
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    label = 'path I (MALA, moving open scene, BVH)'
    t0 = time.time()
    scene, opts, _ = parse_scene(xml_f, device='cuda')
    t_parse = time.time() - t0
    scene = bvh.attach_bvh(scene)
    t_build = time.time() - t0 - t_parse
    opts = opts.replace(spp=1)
    for m in (cw, sw, bvh):
        m.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device='cuda').manual_seed(opts.seed_offset)
    tm = {}
    t0 = time.time()
    with BruteForceCounter() as bf, torch.no_grad():
        film, b = render_mlt(scene, opts, gen, chunk=CHUNK, timings=tm)
        film = film.cpu().numpy()
    seconds = time.time() - t0
    launches = dict(bvh.launch_counts)
    walks = dict(cw.launch_counts, **sw.launch_counts)
    log(f'{label}: parse {t_parse:.2f} s, attach_bvh {t_build:.2f} s, render '
        f'{seconds:.2f} s, peak device memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; BVH kernel '
        f'launches {launches}, walk launches {walks}, brute-force queries '
        f'{bf.calls}')
    check_film(label, film, sky=True)
    rate_i = chain_rate(label, dict(timings=tm, opts=opts, b=b))
    log(f'path I / path F chain-loop proposals/s (same call): {rate_i:.1f} / '
        f'{rate_f:.1f} = {rate_i / rate_f:.3f}; path I / path D: {rate_i:.1f}'
        f' / {rate_d:.1f} = {rate_i / rate_d:.3f}')
    if bf.calls or any(walks.values()) or min(launches.values()) <= 0:
        raise AssertionError(f'{label}: brute-force queries {bf.calls}, walk '
                             f'launches {walks}, BVH launches {launches}: '
                             f'every query must take the BVH kernel')
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device (torch.cuda.is_available() '
                         'is false)')
    sys.path.insert(0, HERE)
    import langevin_mcmc_tpu_torch  # noqa: F401  (fails outside the repo)
    from langevin_mcmc_tpu_torch import testscenes
    from langevin_mcmc_tpu_torch.ops import cuda_build
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene

    t_start = time.time()
    card = card_line()
    log(f'card: {card}')
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}')

    t0 = time.time()
    cuda_build.load_library()
    log(f'kernel build: {time.time() - t0:.2f} s '
        f'(cached={cuda_build.build_info["cached"]}, sources '
        f'{cuda_build.build_info["sources"]}, nvcc '
        f'{cuda_build.build_info["seconds"]:.2f} s)')

    xml = write_flagship(os.path.join(OUT, 'flagship'))
    xml_h2mc = write_flagship(os.path.join(OUT, 'flagship_h2mc'),
                              kernel='h2mc')
    xml_mc = write_flagship(os.path.join(OUT, 'flagship_mc'),
                            integrator='mc')
    xml_open = write_flagship(os.path.join(OUT, 'open'), scene='open')
    small_xml = testscenes.write_scene(os.path.join(OUT, 'small'), small=True,
                                       width=64, height=48, max_depth=4)
    small_open = testscenes.write_scene(os.path.join(OUT, 'small_open'),
                                        small=True, width=64, height=48,
                                        max_depth=4, scene='open')
    small_lc = testscenes.write_scene(os.path.join(OUT, 'small_lc'),
                                      small=True, width=64, height=48,
                                      max_depth=4, large_step='cache',
                                      light_coords=True)
    xml_e = write_flagship(os.path.join(OUT, 'flagship_cache'),
                           large_step='cache', light_coords=True)
    xml_f = write_flagship(os.path.join(OUT, 'open_motion'), scene='open',
                           motion=True)
    xml_f_cut = write_flagship(os.path.join(OUT, 'open_motion_cut'),
                               num_init_samples=PATH_F_PARITY_INIT_SAMPLES,
                               scene='open', motion=True)
    xml_g = write_flagship(os.path.join(OUT, 'flagship_iso'), kernel='iso')
    small_motion = testscenes.write_scene(
        os.path.join(OUT, 'small_motion'), small=True, width=64, height=48,
        max_depth=4, scene='open', motion=True)
    scene, opts, _ = parse_scene(xml, device='cuda')
    log(f'flagship scene: {scene.num_tris} triangles, '
        f'{scene.cw.pack.shape[0]} chunks of 128 '
        f'({scene.cw.pack.numel() * 4} bytes), {scene.sweep.pack.shape[0]} '
        f'of 512, {opts.num_chains} chains, maxdepth {opts.max_depth}, '
        f'{opts.num_init_samples} bootstrap samples, '
        f'{scene.width}x{scene.height}')
    rows = check_kernels(scene)
    del scene
    scene, _, _ = parse_scene(xml_open, device='cuda')
    log(f'open scene: {scene.num_tris} triangles, {scene.cw.pack.shape[0]} '
        f'chunks of 128, {scene.num_lights} lights (env map '
        f'{tuple(scene.env_image.shape)}), {scene.textures.count} textures '
        f'({scene.textures.neigh.shape[0]} texels)')
    open_kernel_rows = open_rows(scene)
    del scene
    bvh_rows = bvh_phase(xml, xml_open, xml_f)
    nccl_phase(xml_e)
    check_generation(small_xml)
    check_generation(small_open)
    check_generation(small_motion)
    check_subpath_generation(small_lc)

    ms = {}     # per path: (eager, captured) ms an iteration, graph phases

    def parity(path, xml_p, **kw):
        ms[path] = graph_parity(f'graph phase, path {path} configuration',
                                xml_p, steps=PARITY_STEPS[path], **kw)
        torch.cuda.empty_cache()

    res_a, launch_a = render('path A (MALA)', xml, {})
    rate_a = chain_rate('path A (MALA)', res_a)
    parity('A', xml)
    res_b, launch_b = render('path B (H2MC)', xml_h2mc,
                             {'LMCMC_ISECT_BACKEND': 'pallas'},
                             num_steps=PATH_B_STEPS)
    rate_b = chain_rate('path B (H2MC)', res_b)
    log(f'H2MC/MALA cost ratio (chain-loop proposals/s, same tuning, same '
        f'card): {rate_a / rate_b:.3f}')
    parity('B', xml_h2mc, env={'LMCMC_ISECT_BACKEND': 'pallas'})
    _, launch_c = render('path C (MC)', xml_mc,
                         {'LMC_CW_VMEM_BYTES': str(RESIDENT_BYTES)})
    res_d, launch_d = render('path D (MALA, open scene)', xml_open, {},
                             sky=True)
    rate_d = chain_rate('path D (MALA, open scene)', res_d)
    log(f'path D / path A chain-loop proposals/s (same call): '
        f'{rate_d:.1f} / {rate_a:.1f} = {rate_d / rate_a:.3f}')
    parity('D', xml_open)
    lc_counter = count_light_coords()
    res_e, launch_e = render('path E (MALA, multiplexed + cache + light '
                             'coordinates)', xml_e, {})
    rate_e = chain_rate('path E', res_e)
    large_step_line('path E', res_e, lc_counter)
    log(f'path E / path A chain-loop proposals/s (same call): '
        f'{rate_e:.1f} / {rate_a:.1f} = {rate_e / rate_a:.3f}')
    parity('E', xml_e, prefill=True)
    path_h(xml_e, rate_e)

    scene, _, _ = parse_scene(xml_f, device='cuda')
    log(f'moving open scene: {scene.num_tris} triangles, has_motion '
        f'{scene.has_motion}, '
        f'{int((scene.tri_p[0] != scene.tri_p[1]).any(-1).any(-1).sum())} '
        f'of them move')
    ms_c, ms_a = motion_queries(scene)
    del scene
    with BruteForceCounter() as bf:
        res_f, launch_f = render('path F (MALA, moving open scene)',
                                 xml_f, {}, sky=True)
    rate_f = chain_rate('path F (MALA, moving open scene)', res_f)
    tm = res_f['timings']
    it_ms = tm['loop_s'] / tm['steps'] * 1e3
    log(f'path F: {bf.calls} brute-force queries issued from the host '
        f'({bf.rays} rays; those outside the capture: {bf.live} live rays, '
        f'{bf.seconds:.2f} s host clock, synchronised), each captured one '
        f'an eager call between graphs, rerun by every replay; one '
        f'65,536-ray query = {ms_c / it_ms:.4f} (closest) / '
        f'{ms_a / it_ms:.4f} (any) of an iteration ({it_ms:.1f} ms, warm-up '
        f'and capture included)')
    log(f'path F / path D chain-loop proposals/s (same call): '
        f'{rate_f:.1f} / {rate_d:.1f} = {rate_f / rate_d:.4f}')
    parity('F', xml_f_cut)
    if bf.calls <= 0 or any(launch_f.values()):
        raise AssertionError(f'path F: {bf.calls} brute-force queries, walk '
                             f'kernel launches {launch_f}: a moving scene '
                             f'must take the brute force only')
    res_g, launch_g = render('path G (isotropic-only chain)', xml_g, {})
    rate_g = chain_rate('path G (isotropic-only chain)', res_g)
    log(f'path G / path A chain-loop proposals/s (same call): '
        f'{rate_g:.1f} / {rate_a:.1f} = {rate_g / rate_a:.3f}')
    parity('G', xml_g)
    launch_i = path_i(xml_f, rate_f, rate_d)
    parity('I', xml_f, bvh=True)
    log('eager / captured ms an iteration, graph phases (same call): '
        + '; '.join(f'{k} {e:.1f} / {c:.1f} = {e / c:.3f}'
                    for k, (e, c) in ms.items()))
    for (key, _), row in bvh_rows.items():
        row['launches'] = launch_i[key]
    for key in ('split_closest_hit', 'split_any_hit'):
        rows[key]['launches_path_g'] = launch_g[key]
        if launch_g[key] <= 0:
            raise AssertionError(f'{rows[key]["name"]} was never launched by '
                                 f'path G')
    for key in ('split_closest_hit', 'split_any_hit'):
        rows[key]['launches_path_e'] = launch_e[key]
        if launch_e[key] <= 0:
            raise AssertionError(f'{rows[key]["name"]} was never launched by '
                                 f'path E')
    for key, row in open_kernel_rows.items():
        row['launches'] = launch_d[key]
        if launch_d[key] <= 0:
            raise AssertionError(f'{row["name"]} was never launched by '
                                 f'path D')
    for key, launches in (('split_closest_hit', launch_a),
                          ('split_any_hit', launch_a),
                          ('sweep_closest_hit', launch_b),
                          ('sweep_any_hit', launch_b),
                          ('closest_hit_resident', launch_c),
                          ('any_hit_resident', launch_c)):
        rows[key]['launches'] = launches[key]
        if launches[key] <= 0:
            raise AssertionError(f'{rows[key]["name"]} was never launched by '
                                 f'the path that runs it')
    log(f'total {time.time() - t_start:.1f} s')
    print(json.dumps({'kernels': list(rows.values())
                      + list(open_kernel_rows.values())
                      + list(bvh_rows.values())}))
    print(f'nvidia-smi: {card}')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    if sys.argv[1:2] == ['--rank']:
        rank_main(sys.argv[2:])
    else:
        main()
