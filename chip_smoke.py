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
     - the matmul sweep (LMCMC_ISECT_BACKEND=matmul, intersect_matmul and
       occluded_matmul: torch.matmul, no kernel) on K1's 65,536 rays
       against the chunk walk's whole query: hit sets and ids equal but on
       shared edges and exact ties of t (counted; at most 0.5% of the
       hits), t within rtol 1e-4 / atol 5e-4, each query captured in a
       CUDA graph and replayed equal to its eager call; its ms beside
       K1-K4's;
  3b. MALA's kNN moments (mcmc/cache.py query_knn, csrc/knn.cu) at the
     flagship's shapes (knn_case: 16,384 lanes, 13 full rows of 3,000
     entries, Dm 16, k 5, exact copies planted): the kernel against its
     plain version (knn_reference) on the card, found bit for bit and v1,
     v2 within rtol 1e-6; the whole query's time (the wrapper's lane
     order and the kernel, one call and back to back), the order's alone,
     the plain version's and the bound;
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
     and pack_bvh) and pack_bvh alone seconds; the kernel, closest and any
     hit, against its plain version (traverse_reference) bit for bit on
     the rays of phases 3 and 4 and of path F's brute-force query, at
     65,536 rays and the large step's 4,260, with its time, the plain
     version's (one run), the inner nodes and triangles a live ray
     (counted by the plain version: mean, 99th percentile, max), the
     divergence (the mean over warps of the most loop steps of a lane over
     the warp's mean) and its bound; beside K1/K2 on the same static rays
     (kernel alone and whole query) and the brute-force kernel on the same
     moving rays;
  5b. the brute-force kernel (ops/intersect.py brute_force, csrc/brute.cu):
     ptxas's registers, stack, spills and shared memory of each
     instantiation; closest and any hit against the plain version
     (_bruteforce_block over the live rays) bit for bit on path F's moving
     scene at 65,536 rays (motion_rays: half camera rays, half from
     surface points at the ray's time, 30% of those dead) and the large
     step's 4,260, with its time, the plain version's (one run), the
     tiles on a block's list (mean, p99) and the pairs its rays test
     beside live rays x triangles (brute_tiles.query_stats), and its
     bound (as the first design's: every live ray against every triangle
     for the closest hit, up to each ray's first hit in id order for the
     any hit); the tile ranges S swept at both ray counts, each checked
     equal; the plain version's PAIR_BLOCK at three sizes, each equal;
     and the static box with LMCMC_ISECT_BACKEND=brute on K1's rays;
  6. a one-rank NCCL process group on the card: global_sum, the cache
     merger (its all-gather of CUDA tensors) against merge_stacked on the
     CPU bit for bit, and the film all-reduce, each timed;
  7. path generation on the card against the CPU plain path on the small
     generated box and open scenes and on the small moving open scene
     (same tape);
  8. path A, the MALA render through the CLI entry point: 1024x768,
     maxdepth 8, 65,536 chains, 300,000 bootstrap samples, directspp 1,
     --spp 1 (12 chain iterations, one call of the multi-step); its chain
     loop must run from CUDA graphs (graphs a step, the eager calls
     between them, the cond_call branches and their runs, nodes, and
     n_done equal to the iterations scheduled);
  9. path C, the MC integrator on the flagship scene (--spp 1) with
     LMC_CW_VMEM_BYTES=6291456: the launches of K3 (the resident walk);
 10. the graph phases (graph_parity), one a configuration, each from one
     bootstrapped state and one generator state: PARITY_STEPS eager
     iterations (make_mlt_step, with no host sync outside the eager calls:
     torch.cuda.set_sync_debug_mode('error')) and the same through the
     multi-step (a warm-up, the capture, replays): the chain state bit for
     bit, step.counts and every kernel's launches equal, the film to rtol
     1e-5 and checked (below); then eager and captured ms an iteration.
     The configurations:
     A  path A's (K1/K2, the kNN query);
     B  path A's with H2MC small steps and LMCMC_ISECT_BACKEND=pallas
        (K4): the step split into graphs around the eigh calls
        (ops/graphs.eager_call);
     D  path A's on the open scene (K1/K2 on its rows; sky);
     E  path A's with multiplexed and cache-seeded large steps and
        light-coordinate sampling (largestepmultiplexed, samplecache,
        uselightcoordinatesampling), the seed states (paths included)
        pushed twice into the cache first, so that every row they reach
        is full: the cache branch must run, a multiplexed large step too,
        and some generated lane must carry light-coordinate parameters;
     F  D's with --motion (the torus and the quad light turn and move
        between two keyframes, the camera pans, the env map turns): every
        ray query is the brute-force kernel, inside the graphs: both of its
        variants launch, no walk kernel does, the step makes no eager call
        and has as many graphs as D's (sky);
     G  path A's with neither mala nor h2mc: the isotropic-only chain
        through K1/K2;
     I  F's with a BVH attached (neither package's CLI attaches one): every
        query takes the BVH kernel, no brute-force or walk kernel (sky);
 11. path H, E's configuration with --spp 6 rendered by two ranks of the
     CLI (--coordinator 127.0.0.1:<free port> --num-processes 2
     --process-id 0/1; each rank is `python3 chip_smoke.py --rank OUT
     CLI-ARGS...`) that share the card, so their collectives take gloo:
     32,768 chains and 150,000 bootstrap samples a rank, 72 iterations
     asked for and 80 run (whole calls of 16, as the JAX package's
     multihost loop runs them), one cache merge. The ranks' reduced chain
     films must be bit-identical and their b equal, their final films
     equal to rtol 1e-5, each film checked, K1/K2 launched on both; each
     rank's full log is under smoke_out/chip_smoke/path_h/.
Phase 7 also holds generate_subpath with light-coordinate sampling (mixed
(s, t) per lane) on the card against the CPU.
A checked film is finite, non-negative, non-zero and 768x1024x3 (sky: a
graph phase adds a direct pass, and the top rows must be lit too). Each
kernel must have been launched by the configuration that runs it (the
launch counts are reset before and read after; a captured kernel counts
once per execution: ops/graphs.py).
The line before the last two is {"kernels": [...]}: per kernel its
launches (in the captured iterations of its configuration's graph phase;
K3's in path C's render; K1/K2 also launches_path_e and launches_path_g,
the kNN query launches_path_a and launches_path_e), max |error| against
the plain version, its time and the plain version's (ms; ms is one call
of the wrapper on an idle card, ms_launches one of 20 calls back to back,
the host's time to enqueue a call hidden behind the card's work), and its
bound: the larger of the f32 operations this run's data needs (40 per
ray-triangle test, 25 per ray-AABB slab test: 256 rays x all chunks per
block) over the 67 TFLOP/s f32 peak and its bytes (each input read once,
each output written once) over 3.35 TB/s (H100 SXM data sheet). No
PyTorch call computes a closest-hit ray query, so library_ms is null. The
open scene's K1/K2 rows (names ending in _open) also carry miss_share.
The BVH rows (bvh_{closest,any}_hit_{box,open,motion}, "pallas": false:
the JAX traversal is an XLA loop, not a Pallas kernel) carry their
launches in I's graph phase, and a bound from the work the plain version
counts: 25 f32 operations per ray-box test (two per inner node), 61 per
Moller-Trumbore test (28 more for a moving triangle's lerp); also the
work's spread and divergence, ptxas's report, pack_bvh's seconds and the
large step's numbers (large_step). The brute-force rows (brute_{closest,
any}_hit_motion, "pallas": false: the JAX brute force is an XLA scan)
carry their launches in F's graph phase, a bound from the tests the
function needs on this run's rays, as the brute force tests them (61 f32
operations a test, + 28 for the moving lerp), the pairs the kernel's rays
test (pairs_tested) and the tiles on a block's list, the tile ranges S,
the large step's numbers (large_step) and the static box's (static_box).
The K1-K4 rows carry matmul_sweep_ms: one matmul-sweep query on their
rays (several torch calls, not one library call).
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
# graph phases' iterations: 8 on paths A and E; 3 on H2MC (path B), whose
# eager iterations take seconds; 4 on the others. From the third on, an
# iteration is a replay.
PARITY_STEPS = dict(A=8, B=3, D=4, E=8, F=4, G=4, I=4)
OPS_PER_TEST = 40       # f32 operations of one ray-triangle test
OPS_PER_SLAB = 25       # f32 operations of one ray-AABB slab test
OPS_PER_MT = 61         # f32 operations of one Moller-Trumbore test
OPS_PER_EDGES = 6       # of them, the edges e1 = p1 - p0, e2 = p2 - p0
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
    matmul_check(scene, (org, d, z, mn, mx), rows)
    return rows


def knn_case(lanes=16384, k=5, Dm=16, seed=11):
    """The flagship's kNN query on the card: every row of the cache full
    (pss_max_size entries of uniform pss, v1 and v2 normal), the lanes'
    dims spread over 2-12 and 14, 16 (clamped to the last row), a third
    of the queries on a stored entry, a third within 1e-3 of one, and
    entries 2,000-2,099 of every row exact copies of entries 0-99.
    Returns (cache, dims, pss, opts)."""
    from langevin_mcmc_tpu_torch import Options
    from langevin_mcmc_tpu_torch.mcmc import cache as cache_mod
    opts = dataclasses.replace(Options(), pss_knn=k)
    g = torch.Generator(device='cuda').manual_seed(seed)
    cache = cache_mod.make_cache(opts, Dm, 'cuda')
    ndim, size = cache.count.shape[0], cache.size
    shape = (ndim, size, Dm)
    pss = torch.rand(shape, generator=g, device='cuda')
    pss[:, 2000:2100] = pss[:, :100]
    cache = dataclasses.replace(
        cache, pss=pss, v1=torch.randn(shape, generator=g, device='cuda'),
        v2=torch.randn(shape, generator=g, device='cuda'),
        count=torch.full((ndim,), size, dtype=torch.int32, device='cuda'))
    choices = torch.tensor([2, 4, 6, 8, 10, 12, 14, 16], dtype=torch.int32,
                           device='cuda')
    dims = choices[torch.randint(0, len(choices), (lanes,), generator=g,
                                 device='cuda')]
    rows = torch.clamp(dims, 0, ndim - 1).long()
    on = pss[rows, torch.randint(0, 100, (lanes,), generator=g,
                                 device='cuda')]
    near = on + 1e-3 * torch.randn(on.shape, generator=g, device='cuda')
    anywhere = torch.rand(on.shape, generator=g, device='cuda')
    third = (torch.arange(lanes, device='cuda') % 3)[:, None]
    q = torch.where(third == 0, on, torch.where(third == 1, near, anywhere))
    return cache, dims, q.contiguous(), opts


def knn_phase():
    """The kNN kernel at the flagship's shapes against its plain version,
    timed. Returns its row of the kernels JSON line."""
    from langevin_mcmc_tpu_torch.mcmc import cache as cache_mod
    cache, dims, q, opts = knn_case()
    query = lambda: cache_mod.query_knn(cache, dims, q, opts)
    plain = lambda: cache_mod.knn_reference(cache, dims, q, opts)
    got, want = query(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f'knn: found differs on '
                             f'{int((got[0] != want[0]).sum())} lanes')
    rel = max(float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
              for a, b in zip(got[1:], want[1:]))
    bits = all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
    if rel > 1e-6:
        raise AssertionError(f'knn: v1/v2 differ by rtol {rel:.3g}')
    ndim = cache.count.shape[0]
    sort = lambda: torch.argsort(dims, descending=True)
    ms, ms_launches = cuda_ms(query), cuda_ms_launches(query)
    sort_ms, plain_ms = cuda_ms(sort), cuda_ms(plain)
    # 3 operations a coordinate of every (lane, live entry) pair; bytes:
    # the cache and the queries read once, the results written once
    Dm = q.shape[1]
    live = cache.count[torch.clamp(dims, 0, ndim - 1).long()].double()
    ops = float((live * torch.clamp(dims, 0, Dm).double()).sum()) * 3
    moved = nbytes(cache.pss, cache.v1, cache.v2, cache.count, dims, q,
                   *got)
    ops_ms, bytes_ms = ops / PEAK_F32 * 1e3, moved / PEAK_BYTES * 1e3
    bound_ms, bound_by = max((ops_ms, 'operations'), (bytes_ms, 'bytes'))
    log(f'knn_query: {q.shape[0]} lanes, {ndim} rows of {cache.size}, '
        f'Dm {Dm}, k {opts.pss_knn}: found bit for bit '
        f'({int(got[0].sum())} found), v1/v2 '
        f'{"bit for bit" if bits else f"max rel diff {rel:.3g}"}; whole '
        f'query {ms:.3f} ms (back to back {ms_launches:.3f} ms), of it the '
        f'lane order {sort_ms:.3f} ms; plain {plain_ms:.3f} ms; {ops:.4g} '
        f'operations, {moved} bytes, bound {bound_ms:.4f} ms ({bound_by})')
    return dict(name='knn_query', route='cuda',
                source='csrc/knn.cu knn_kernel',
                replaces='none (the JAX package query_knn is XLA ops)',
                max_rel_err=rel, ms=ms, ms_launches=ms_launches,
                sort_ms=sort_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def captured(fn):
    """fn() (a tensor or a tuple of them) captured in a CUDA graph after
    an eager warm-up on a side stream, its outputs zeroed, and replayed:
    (the eager result, the replayed one)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want = fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
    for o in as_tuple(out):
        o.zero_()
    g.replay()
    torch.cuda.synchronize()
    return as_tuple(want), as_tuple(out)


def matmul_differences(p, rays, hm, im, tm, h1, i1, t1):
    """Sorts the rays on which the matmul sweep (hm, im, tm) and the chunk
    walk (h1, i1, t1) differ, on triangles p [T, 3, 3], into what two
    f32 arithmetics may rightly disagree on. An id differs on a shared
    edge (or, at an equal t, a tie) if the matmul's triangle also passes
    the test (moller_trumbore: u, v, 1 - u - v >= -1e-4) at the chunk
    walk's t; on a crack if the nearer of the two triangles is hit on its
    own edge (|min(u, v, 1 - u - v)| <= 1e-4: the other backend slipped
    through it to a triangle behind); at an end of the ray if the nearer
    hit's t is min_t or max_t to within rtol 1e-4 / atol 5e-4 (a ray that
    leaves a surface meets it again near min_t, which one rounding keeps
    and the other drops). A hit set differs on an edge or at an end in
    the same way. Returns the counts; 'other' and 'hit_bad' are the
    differences none of these explains."""
    from langevin_mcmc_tpu_torch.ops import intersect
    org, d, _, mn, mx = rays
    eps = 1e-4

    def bary(ids, lanes):
        tp = p[ids[lanes].long()]
        t, u, v, _ = intersect.moller_trumbore(
            org[lanes], d[lanes], tp[:, 0], tp[:, 1] - tp[:, 0],
            tp[:, 2] - tp[:, 0])
        return t, torch.stack([u, v, 1.0 - u - v], 1).amin(1)

    def at_end(t, lanes):
        return (torch.isclose(t, mn[lanes], rtol=1e-4, atol=5e-4)
                | torch.isclose(t, mx[lanes], rtol=1e-4, atol=5e-4))

    lanes = torch.nonzero(hm & h1 & (im != i1))[:, 0]
    t_m, inside = bary(im, lanes)
    on_edge = (inside >= -eps) & torch.isclose(t_m, t1[lanes], rtol=1e-4,
                                               atol=5e-4)
    ties = int((on_edge & (tm[lanes] == t1[lanes])).sum())
    _, inside = bary(torch.where(tm < t1, im, i1), lanes)
    crack = ~on_edge & (inside.abs() <= eps)
    end = ~on_edge & ~crack & at_end(torch.minimum(tm, t1)[lanes], lanes)
    out = dict(ties=ties, edges=int(on_edge.sum()) - ties,
               cracks=int(crack.sum()), ends=int(end.sum()),
               other=int((~on_edge & ~crack & ~end).sum()))
    lanes = torch.nonzero(hm != h1)[:, 0]
    _, inside = bary(torch.where(hm, im, i1), lanes)
    explained = (inside.abs() <= eps) | at_end(
        torch.where(hm, tm, t1)[lanes], lanes)
    out.update(hit_diff=int(lanes.numel()), hit_bad=int((~explained).sum()))
    return out


def matmul_check(scene, rays, rows):
    """One intersect_matmul and one occluded_matmul query (the matmul
    sweep, LMCMC_ISECT_BACKEND=matmul: torch.matmul, no kernel) on K1's
    65,536 rays of the box, against the chunk walk's whole query (K1/K2):
    hit sets and ids equal but where matmul_differences explains the
    difference (each kind counted; together at most 0.5% of the hits, the
    bound of tests/test_torch_intersect.py against the brute force), t
    within rtol 1e-4 / atol 5e-4 where both hit the same triangle (that
    test's tolerance of the Woop arithmetic), occluded equal to the closest
    hit's hit set; each query captured in a CUDA graph and replayed equals
    its eager call (no host read). Times both with CUDA events beside
    K1-K4 and the chunk walk's whole query, and adds matmul_sweep_ms to
    the K1-K4 rows (the closest hit's to closest-hit rows, the any hit's
    to any-hit rows)."""
    from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
    from langevin_mcmc_tpu_torch.ops import intersect
    hm, im, tm, _, _ = intersect.intersect_matmul(scene, *rays)
    om = intersect.occluded_matmul(scene, *rays)
    h1, i1, t1, _, _ = cw.intersect_chunkwalk(scene, *rays)
    torch.cuda.synchronize()
    same = hm & h1 & (im == i1)
    diff = matmul_differences(scene.tri_p[0], rays, hm, im, tm, h1, i1, t1)
    ties, edges, cracks, ends, id_bad, hit_diff, hit_bad = (
        diff[key] for key in ('ties', 'edges', 'cracks', 'ends', 'other',
                              'hit_diff', 'hit_bad'))
    t_ok = torch.isclose(tm[same], t1[same], rtol=1e-4, atol=5e-4)
    t_err = float((tm[same] - t1[same]).abs().max())
    replay_equal = all(torch.equal(a, b) for fn in (
        intersect.intersect_matmul, intersect.occluded_matmul)
        for a, b in zip(*captured(lambda: fn(scene, *rays))))
    torch.cuda.reset_peak_memory_stats()
    ms_c = cuda_ms(lambda: intersect.intersect_matmul(scene, *rays), 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms_a = cuda_ms(lambda: intersect.occluded_matmul(scene, *rays), 3)
    q1 = cuda_ms(lambda: cw.intersect_chunkwalk(scene, *rays))
    q2 = cuda_ms(lambda: cw.occluded_chunkwalk(scene, *rays))
    k = {key: rows[key]['ms'] for key in rows}
    log(f'matmul sweep, {rays[0].shape[0]} rays on the box: '
        f'{int(hm.sum())} hits against the chunk walk\'s {int(h1.sum())}: '
        f'hit sets differ on {hit_diff} rays ({hit_bad} neither on an edge '
        f'nor at an end of the ray), ids on {edges} shared edges, {ties} '
        f'exact ties of t, {cracks} cracks, {ends} ends of the ray and '
        f'{id_bad} other rays; t within rtol 1e-4 / atol 5e-4 on '
        f'{int(t_ok.sum())} of {int(same.sum())} (max |diff| {t_err:.3g}); '
        f'occluded = hit set: {torch.equal(om, hm)}; captured replay = '
        f'eager: {replay_equal}; closest {ms_c:.3f} ms, any {ms_a:.3f} ms '
        f'(peak device memory {peak:.2f} GiB) beside K1 '
        f'{k["split_closest_hit"]:.3f} / K2 {k["split_any_hit"]:.3f}, K3 '
        f'{k["closest_hit_resident"]:.3f} / {k["any_hit_resident"]:.3f}, K4 '
        f'{k["sweep_closest_hit"]:.3f} / {k["sweep_any_hit"]:.3f} ms '
        f'(kernels alone) and the chunk walk\'s whole query {q1:.3f} / '
        f'{q2:.3f} ms')
    if (hit_diff + edges + ties + cracks + ends > 0.005 * int(h1.sum())
            or hit_bad
            or id_bad or not t_ok.all()
            or not torch.equal(om, hm) or not replay_equal):
        raise AssertionError('matmul sweep: disagrees with the chunk walk '
                             'or its captured replay differs')
    for key, row in rows.items():
        row['matmul_sweep_ms'] = ms_a if 'any' in key else ms_c


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


def brute_any_tests(scene, rays):
    """Ray-triangle tests an any-hit query needs on these rays as the
    brute force runs it: each live ray tests up to and including its
    first valid triangle in id order, or every triangle where none is
    (the plain version's arithmetic, chunk by chunk, 4,096 rays at a
    time). The bound of the brute-force rows, kept as the first design's
    so that the rows stay comparable; the culled kernel tests fewer
    (pairs_tested)."""
    from langevin_mcmc_tpu_torch.ops import intersect
    from langevin_mcmc_tpu_torch.utils import vecmath as vm
    org, d, tm, mn, mx = rays
    T = scene.num_tris
    live = torch.nonzero(mx >= mn)[:, 0]
    total = 0
    for r0 in range(0, live.numel(), 4096):
        lanes = live[r0:r0 + 4096]
        o, dd = org[lanes, None], d[lanes, None]
        first = torch.full((lanes.numel(),), T, device=org.device)
        for start in range(0, T, intersect.TRI_CHUNK):
            end = min(start + intersect.TRI_CHUNK, T)
            if scene.has_motion:
                tp = vm.lerp(tm[lanes, None, None, None],
                             scene.tri_p[0, None, start:end],
                             scene.tri_p[1, None, start:end])
            else:
                tp = scene.tri_p[0, None, start:end]
            p0 = tp[..., 0, :]
            t, u, v, div = intersect.tri_test_ordered(
                o, dd, p0, tp[..., 1, :] - p0, tp[..., 2, :] - p0)
            ok = ((div != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                  & (t >= mn[lanes, None]) & (t <= mx[lanes, None])
                  & torch.isfinite(t))
            ids = torch.arange(start, end, device=org.device)
            first = torch.minimum(
                first, torch.where(ok, ids, torch.full_like(ids, T)).amin(1))
        total += int(torch.where(first < T, first + 1, T).sum())
    return total


def brute_row(name, scene, rays, any_hit):
    """The brute-force kernel (csrc/brute.cu) on these rays against its
    plain version (_bruteforce_block over the live rays) bit for bit,
    timed (one call, and back to back), the plain version's
    time (one run between CUDA events: it gathers the live rays on the
    host), the
    culled query's tiles on a block's list and pairs tested
    (brute_tiles.query_stats, the kernel's decisions in torch), and the
    bound: ray-triangle tests (live rays x triangles for the closest hit,
    brute_any_tests for the any hit) x f32 operations a test (55 on a
    static scene, whose edges both versions compute once a tile or chunk;
    61 + 28 on a moving one, which lerps the vertices and takes the edges
    per test) over 67 TFLOP/s, or the bytes (triangles and rays read once,
    outputs written once) over 3.35 TB/s. Returns the row of the kernels
    JSON line."""
    from langevin_mcmc_tpu_torch.ops import brute_tiles, intersect
    org, d, tm, mn, mx = rays
    query = lambda: intersect.brute_force(scene, *rays, any_hit=any_hit)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    want = intersect._bruteforce_live(scene, *rays)
    ev[1].record()
    got = query()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])
    if any_hit:
        if not torch.equal(got, torch.isfinite(want[0])):
            raise AssertionError(f'{name}: occlusion differs on '
                                 f'{(got != torch.isfinite(want[0])).sum()}'
                                 f' rays')
    else:
        for a, b, f in zip(got, want, 'tiuv'):
            if not torch.equal(a, b):
                raise AssertionError(f'{name}: {f} differs on '
                                     f'{(a != b).sum().item()} rays')
    ms = cuda_ms(query)
    ms_launches = cuda_ms_launches(query)
    R, T = org.shape[0], scene.num_tris
    live = int((mx >= mn).sum())
    S = intersect.brute_splits(R, T)
    tests = brute_any_tests(scene, rays) if any_hit else live * T
    ops = tests * (OPS_PER_MT + OPS_PER_LERP if scene.has_motion
                   else OPS_PER_MT - OPS_PER_EDGES)
    in_bytes = nbytes(scene.tri_p) // (1 if scene.has_motion else 2) + \
        nbytes(org, d, mn, mx) + (nbytes(tm) if scene.has_motion else 0)
    ops_ms = ops / PEAK_F32 * 1e3
    bytes_ms = (in_bytes + R * (1 if any_hit else 16)) / PEAK_BYTES * 1e3
    bound_ms, bound_by = (ops_ms, 'operations') if ops_ms >= bytes_ms \
        else (bytes_ms, 'bytes')
    hits = int((got if any_hit else torch.isfinite(got[0])).sum())
    st = brute_tiles.query_stats(scene, *rays)
    log(f'{name}, {R} rays ({live} live, {hits} hit) x {T} triangles, S = '
        f'{S}: equal to the plain version; kernel {ms:.3f} ms (back to back '
        f'{ms_launches:.3f} ms), plain {plain_ms:.1f} ms; the brute force '
        f'runs {tests:.4g} ray-triangle tests, {tests / ms / 1e6:.1f} G of '
        f'them a second; the culled query\'s rays test {st["tested"]:.4g} '
        f'pairs of {live * T:.4g} live rays x triangles '
        f'({st["tested"] / max(live * T, 1):.4f}), '
        f'{st["list_mean"]:.1f} / {st["list_p99"]:.0f} tiles on a block\'s '
        f'list (mean / p99) of {st["tiles"]}; bound '
        f'{bound_ms:.3f} ms ({bound_by}), kernel / bound '
        f'{ms / bound_ms:.2f}')
    return dict(name=name, route='cuda',
                source='langevin_mcmc_tpu_torch/csrc/brute.cu',
                replaces='langevin_mcmc_tpu/ops/intersect.py:'
                + ('109' if any_hit else '59'), pallas=False,
                max_abs_err=0.0, ms=ms, ms_launches=ms_launches,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, rays=R, live=live, tests=tests, splits=S,
                pairs_tested=st['tested'], list_mean=st['list_mean'],
                list_p99=st['list_p99'], tiles=st['tiles'])


def brute_splits_table(label, scene, rays):
    """The brute-force kernel at several tile ranges S (the default
    marked), each first checked equal to the default, timed
    (cuda_ms_launches)."""
    from langevin_mcmc_tpu_torch.ops import intersect
    R, T = rays[0].shape[0], scene.num_tris
    S0 = intersect.brute_splits(R, T)
    tiles = -(-T // intersect.BRUTE_RAYS)
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
    ref = [as_tuple(intersect.brute_force(scene, *rays, any_hit=a))
           for a in (False, True)]
    for S in sorted({1, 2, 4, 8, 16, 32, 64, S0, tiles}):
        row = []
        for a in (False, True):
            fn = lambda: intersect.brute_force(scene, *rays, any_hit=a,
                                               splits=S)
            if not all(torch.equal(x, y)
                       for x, y in zip(as_tuple(fn()), ref[a])):
                raise AssertionError(f'{label}: S={S} changes the answer')
            row.append(cuda_ms_launches(fn))
        log(f'  {label}, {R} rays, S={S}{" (default)" if S == S0 else ""}, '
            f'{-(-R // intersect.BRUTE_RAYS) * S} CTAs: closest '
            f'{row[0]:.3f} ms, any {row[1]:.3f} ms')


# the numbers of a brute-force row kept for the large step and the box
BRUTE_KEYS = ('rays', 'live', 'tests', 'splits', 'ms', 'ms_launches',
              'plain_ms', 'bound_ms', 'bound_by', 'pairs_tested',
              'list_mean', 'list_p99', 'tiles')


def brute_phase(xml, xml_f):
    """The brute-force kernel (csrc/brute.cu): ptxas's registers, stack,
    spills and shared memory of each instantiation; on the moving open
    scene (motion_rays) at 65,536 and the large step's 4,260 rays, closest
    and any hit against the plain version bit for bit, timed, with its
    bound, and S swept at both; the plain version's block of ray-triangle
    pairs (PAIR_BLOCK) at three sizes, each equal to the default; and the
    static box with LMCMC_ISECT_BACKEND=brute (the switch must pick the
    brute force; the kernel runs on the keyframe-0 tables) on K1's rays,
    each variant bit for bit and timed (kept under 'static_box'). Returns
    the rows of the kernels JSON line
    (moving scene, 65,536 rays; 4,260 under 'large_step'), keyed by
    launch-count name; each row also holds the host seconds of one build
    of each scene's tables (tables_build_s)."""
    from langevin_mcmc_tpu_torch.ops import brute_tiles, intersect
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    ptxas = ptxas_lines('brute.cu', 'brute_kernel')
    for k in ptxas:
        log(f'brute-force kernel ptxas: {k["name"]}: {k["registers"]} '
            f'registers, {k["stack_bytes"]} bytes stack frame, '
            f'{k["spill_stores"]} / {k["spill_loads"]} bytes spill stores / '
            f'loads, {k["smem_bytes"]} bytes static shared memory')
    if not ptxas:
        log('brute-force kernel ptxas: not reported (the library was cached)')
    scene, _, _ = parse_scene(xml_f, device='cuda')
    t0 = time.perf_counter()
    brute_tiles.tables_for(scene.tri_p, True)
    build_s = {'motion': time.perf_counter() - t0}
    full = motion_rays(scene, 65536, seed=23)
    rows = {}
    for n in (65536, LARGE_RAYS):
        rays = tuple(x[:n].contiguous() for x in full)
        for any_hit in (False, True):
            key = 'any_hit' if any_hit else 'closest_hit'
            row = brute_row(f'brute_{key}_motion', scene, rays, any_hit)
            if n == 65536:
                # one instantiation a scene kind (any_hit is an argument)
                row['ptxas'] = [k for k in ptxas if 'ILb1E' in k['name']]
                rows[key] = row
            else:
                rows[key]['large_step'] = {k: row[k] for k in BRUTE_KEYS}
        log('brute-force kernel, tile ranges S (CUDA-event ms):')
        brute_splits_table('motion', scene, rays)
    # the plain version's blocks of ray-triangle pairs, each equal to the
    # default
    want = intersect._bruteforce_live(scene, *full)
    default = intersect.PAIR_BLOCK
    try:
        for pairs in (1 << 20, 1 << 22, 1 << 24):
            intersect.PAIR_BLOCK = pairs
            got = intersect._bruteforce_live(scene, *full)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f'brute force plain version: blocks '
                                     f'of {pairs} pairs change the answer')
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: intersect._bruteforce_live(scene, *full), 1)
            log(f'  plain version, blocks of {pairs} pairs'
                f'{" (default)" if pairs == default else ""}: closest hit '
                f'{ms:.1f} ms, peak device memory '
                f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    finally:
        intersect.PAIR_BLOCK = default
    del scene, want
    # the static box's tables come from build_scene under the variable,
    # as a user's render gets them
    saved = os.environ.get('LMCMC_ISECT_BACKEND')
    os.environ['LMCMC_ISECT_BACKEND'] = 'brute'
    try:
        scene, _, _ = parse_scene(xml, device='cuda')
        fi, fo = intersect.make_intersect_fns(scene)
    finally:
        if saved is None:
            os.environ.pop('LMCMC_ISECT_BACKEND')
        else:
            os.environ['LMCMC_ISECT_BACKEND'] = saved
    if fi.func is not intersect.intersect_bruteforce or \
            fo.func is not intersect.occluded_bruteforce:
        raise AssertionError('LMCMC_ISECT_BACKEND=brute did not pick the '
                             'brute force on the box')
    t0 = time.perf_counter()
    brute_tiles.tables_for(scene.tri_p, False)
    build_s['static'] = time.perf_counter() - t0
    log(f'brute-force tables (brute_tiles.tables_for, host): moving open '
        f'scene {build_s["motion"]:.3f} s, static box {build_s["static"]:.3f}'
        f' s')
    org, d, mn, mx = kernel_rays(scene, 65536, seed=7)
    rays = (org, d, torch.zeros_like(mn), mn, mx)
    for any_hit in (False, True):
        key = 'any_hit' if any_hit else 'closest_hit'
        row = brute_row(f'brute_{key}_box', scene, rays, any_hit)
        q = (fo if any_hit else fi)(*rays)
        k = intersect.brute_force(scene, *rays, any_hit=any_hit)
        if not torch.equal(q if any_hit else q[1], k if any_hit else k[1]):
            raise AssertionError(f'brute_{key}_box: the switch\'s query '
                                 f'differs from the kernel')
        rows[key]['static_box'] = {k: row[k] for k in BRUTE_KEYS}
        rows[key]['static_box']['ptxas'] = [k for k in ptxas
                                            if 'ILb0E' in k['name']]
        rows[key]['tables_build_s'] = build_s
    return rows


def render(label, xml, env):
    """One render through the CLI with env set around it. Checks the film;
    returns (the CLI's result, launch counts of this render by row key)."""
    from langevin_mcmc_tpu_torch.__main__ import main as cli_main
    from langevin_mcmc_tpu_torch.ops import tracing
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    torch.cuda.reset_peak_memory_stats()
    tracing.reset_launches()
    try:
        res = cli_main([xml, '--spp', '1', '--chunk', str(CHUNK),
                        '--output-dir', os.path.join(OUT, label),
                        '--device', 'cuda'])[0]
    finally:
        restore(saved)
    launches = all_launches()
    log(f'{label}: {env or "default backends"}; peak device memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    log(f'{label}: kernel launches {launches}')
    check_film(label, res['film'])
    return res, launches


def restore(saved):
    """Set the environment variables back to `saved` (None: unset)."""
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


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


def graph_line(label, tm):
    """A render's captured chain loop (render_mlt's timings): graphs a
    step, the eager calls between them (named), the cond_call branches
    and how often they ran and were skipped, their nodes, and n_done
    against the iterations scheduled, which must be equal."""
    scheduled = tm.get('calls', tm['steps'] // tm['n_inner']) * tm['n_inner']
    log(f'{label}: chain loop from CUDA graphs: {tm.get("graphs", 0)} '
        f'graph(s) a step, {tm.get("eager_calls", 0)} eager call(s) between '
        f'them {tm.get("eager_fns", [])}, {tm.get("branches", 0)} '
        f'cond_call branch(es) (ran {tm.get("branch_runs", 0)}, skipped '
        f'{tm.get("branch_skips", 0)}), {tm.get("graph_nodes", 0)} nodes; '
        f'n_done {tm["n_done"]} of {scheduled} iterations scheduled (calls '
        f'of {tm["n_inner"]})')
    if tm.get('graphs', 0) < 1:
        raise AssertionError(f'{label}: the chain loop ran no CUDA graph')
    if tm['n_done'] != scheduled or tm['steps'] != scheduled:
        raise AssertionError(f'{label}: n_done {tm["n_done"]}, steps '
                             f'{tm["steps"]}, scheduled {scheduled}')


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
    (ops/graphs.eager_call: H2MC's eigh), which run with the mode off."""
    from langevin_mcmc_tpu_torch.mcmc import gaussian
    from langevin_mcmc_tpu_torch.ops import graphs
    users = (gaussian,)

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
    """Every kernel wrapper's launch counts by row key: the chunk walk's
    keys, then the sweep's, the brute force's and the BVH's under their
    prefixes, and the kNN query's."""
    from langevin_mcmc_tpu_torch.mcmc import cache
    from langevin_mcmc_tpu_torch.ops import (bvh, chunkwalk, intersect,
                                             sweep_isect)
    out = dict(chunkwalk.launch_counts)
    for prefix, m in (('sweep_', sweep_isect), ('brute_', intersect),
                      ('bvh_', bvh), ('knn_', cache)):
        out.update({prefix + k: v for k, v in m.launch_counts.items()})
    return out


WALK_KEYS = ('split_closest_hit', 'split_any_hit', 'closest_hit_resident',
             'any_hit_resident', 'sweep_closest_hit', 'sweep_any_hit')


def timed(fn):
    """(fn(), host seconds) between two device syncs."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def graph_parity(label, xml, prefill=False, steps=8, env=None, bvh=False,
                 sky=False):
    """From one bootstrapped state and one generator state at full width:
    `steps` iterations of the eager step (make_mlt_step, under sync_free:
    no host sync outside eager_call), then the same through one call of
    make_mlt_multi_step (the warm-up, the capture, replays). The chain
    state must be equal bit for bit, step.counts and every kernel's
    launches equal; the film is held to rtol 1e-5 (index_add_ splats with
    atomics) and checked (check_film; sky: with a direct pass added, its
    top rows lit too, as in a render). Then one
    more call of the multi-step (all replays) from where it stood, timed:
    eager (the first `steps`, warm) and captured ms an iteration side by
    side. env: environment variables set around it (path B's backend);
    bvh: attach a BVH (path I). prefill: path E's configuration with the
    seed states (paths included) pushed twice into the cache, so that
    every row they reach is full: the cache-seeded large step and the
    cache phase run from the first iteration (it must take the cache
    branch) and no lane needs a gradient. Returns the captured step's
    graph record (tracing.graph_record) with its 'launches' (all_launches
    of the captured iterations) and 'counts' (step.counts)."""
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    from langevin_mcmc_tpu_torch.ops import bvh as bvh_mod
    env = env or {}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        scene, opts, _ = parse_scene(xml, device='cuda')
        if bvh:
            scene = bvh_mod.attach_bvh(scene)
        return _graph_parity(label, scene, opts, prefill, steps, sky)
    finally:
        restore(saved)


def _graph_parity(label, scene, opts, prefill, steps, sky):
    from langevin_mcmc_tpu_torch.integrators import mlt
    from langevin_mcmc_tpu_torch.integrators.pathtrace import render_direct
    from langevin_mcmc_tpu_torch.ops import tracing
    from langevin_mcmc_tpu_torch.utils.tree import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device='cuda').manual_seed(2)
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
        tracing.reset_launches()
        want, t_e = timed(lambda: sync_free(
            lambda: eager(banked0, film_e, steps)))
        launches_e = all_launches()
        # a capture cannot free the eager iterations' cached blocks (H2MC's
        # Hessian takes ~30 GB a step), so free them first
        torch.cuda.empty_cache()
        gen.set_state(state0)
        multi = mlt.make_mlt_multi_step(scene, opts, b, lsp, steps,
                                        length_dist=ld)
        tracing.reset_launches()
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
        rec = tracing.graph_record(multi.graphs)
        log(f'{label}: {steps} eager iterations (no host sync outside the '
            f'eager calls) and the same {steps} through the multi-step '
            f'({rec["graphs"]} graph(s), {rec["eager_calls"]} eager call(s) '
            f'{rec["eager_fns"]}, {rec["branches"]} cond_call branch(es): '
            f'ran {rec["branch_runs"]}, skipped {rec["branch_skips"]}; '
            f'{rec["nodes"]} nodes; capture {rec["capture_s"]:.2f} s, '
            f'instantiate {rec["instantiate_s"]:.2f} s) from one state: '
            f'n_done {int(n_done)}; chain state '
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
        if rec['graphs'] < 1:
            raise AssertionError(f'{label}: the multi-step ran no CUDA graph')
        if prefill and counts_e['cache'] <= 0:
            raise AssertionError(f'{label}: no lane took the cache branch')
        film = film_c
        if sky:     # the sky is lit on the direct pass's paths only
            film = film_c + render_direct(
                scene, opts, torch.Generator(device='cuda').manual_seed(3),
                chunk=CHUNK)
        check_film(label, film.cpu().numpy(), sky)
        (_, _, n2), t_c2 = timed(lambda: multi(gen, got, film_c, init))
    ms_e, ms_c = t_e / steps * 1e3, t_c2 / steps * 1e3
    log(f'{label}: eager {ms_e:.1f} ms an iteration, captured {ms_c:.1f} ms '
        f'an iteration (replays; n_done {int(n2)}); first call of the '
        f'multi-step (warm-up, capture, replays) {t_c1:.2f} s; peak device '
        f'memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    if int(n2) != steps:
        raise AssertionError(f'{label}: n_done {int(n2)} of {steps}')
    return dict(rec, launches=launches_c, counts=counts_c)


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
    scene's brute_phase's."""
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
    build and pack_bvh timed; ptxas's registers, stack
    and spills of each kernel instantiation; the kernel against its plain
    version (closest and any hit, at 65,536 and 4,260 rays; the rays of
    check_kernels, open_rows and brute_phase); on the moving scene the
    whole BVH query beside the brute-force kernel's. Returns the rows of
    the kernels JSON line (65,536 rays), keyed by (variant, scene)."""
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
        log(f'BVH {tag}: {scene.num_tris} triangles, '
            f'{scene.bvh_nodes.shape[0]} nodes '
            f'({packed.records.shape[0]} records, '
            f'{packed.records.numel() * 4} bytes), '
            f'{bvh.tree_depth(scene.bvh_nodes.cpu().numpy())} levels; '
            f'attach_bvh (build_bvh in numpy + pack_bvh) {t_np:.2f} s, '
            f'pack_bvh alone {t_pack:.4f} s')
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
                        cuda_ms(lambda: fb(scene, *rays)))
            log(f'BVH motion, 65,536 rays: whole query closest / any hit '
                f'BVH {q[False][0]:.3f} / {q[True][0]:.3f} ms, brute-force '
                f'kernel {q[False][1]:.3f} / {q[True][1]:.3f} ms: '
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
    from langevin_mcmc_tpu_torch.ops import tracing
    out, args = argv[0], argv[1:]
    tracing.reset_launches()
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


def path_h(xml_e, spp=6):
    """Path H: path E's configuration rendered by two ranks of the CLI
    (--coordinator, --num-processes 2, --process-id 0/1) that share the
    card (so the collectives take gloo), each with half the chains and
    half the bootstrap samples; spp 6 asks for 72 iterations, which the
    loop runs as the JAX package's does, in whole calls of 16: 80
    iterations, with one cache merge after the fourth call, each call's
    chain loop from CUDA graphs. Checks every rank's film, the
    ranks' reduced chain films bit for bit and their b, their final films
    to rtol 1e-5 (each rank's direct pass splats with atomics), the merge,
    the iterations run and K1/K2 on both ranks."""
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
    try:
        codes = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
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
    for r, (z, js) in enumerate(res):
        tm = js['timings']
        check_film(f'path H rank {r}', z['film'])
        log(f'path H rank {r}: b = {float(z["b"]):.6g}; {tm["steps"]} '
            f'iterations; peak device memory {js["peak_gib"]:.2f} GiB; '
            f'{tm["merges"]} cache merge(s), {tm["merge_bytes"] / 2**20:.1f} '
            f'MiB gathered; kernel launches {js["launches"]}')
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
        f'{np.abs(z0["film"] - z1["film"]).max():.3g})')


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
    knn_row = knn_phase()
    scene, _, _ = parse_scene(xml_open, device='cuda')
    log(f'open scene: {scene.num_tris} triangles, {scene.cw.pack.shape[0]} '
        f'chunks of 128, {scene.num_lights} lights (env map '
        f'{tuple(scene.env_image.shape)}), {scene.textures.count} textures '
        f'({scene.textures.neigh.shape[0]} texels)')
    open_kernel_rows = open_rows(scene)
    del scene
    bvh_rows = bvh_phase(xml, xml_open, xml_f)
    brute_rows = brute_phase(xml, xml_f)
    nccl_phase(xml_e)
    check_generation(small_xml)
    check_generation(small_open)
    check_generation(small_motion)
    check_subpath_generation(small_lc)

    def parity(path, xml_p, **kw):
        rec = graph_parity(f'graph phase, path {path} configuration', xml_p,
                           steps=PARITY_STEPS[path], **kw)
        torch.cuda.empty_cache()
        return rec

    res_a, _ = render('path A (MALA)', xml, {})
    graph_line('path A (MALA)', res_a['timings'])
    ph_a = parity('A', xml)
    ph_b = parity('B', xml_h2mc, env={'LMCMC_ISECT_BACKEND': 'pallas'})
    _, launch_c = render('path C (MC)', xml_mc,
                         {'LMC_CW_VMEM_BYTES': str(RESIDENT_BYTES)})
    ph_d = parity('D', xml_open, sky=True)
    lc_counter = count_light_coords()
    ph_e = parity('E', xml_e, prefill=True)
    c = ph_e['counts']
    log(f'path E configuration: large-step lanes {c["large"]} (multiplexed '
        f'{c["mmlt"]}, cache {c["cache"]}, cache accepts '
        f'{c["cache_accepts"]}); generated lanes with light-coordinate '
        f'parameters {int(lc_counter["lanes"])} (bootstrap and large steps)')
    if c['large'] <= 0 or c['mmlt'] <= 0:
        raise AssertionError('path E configuration: no multiplexed large '
                             'step ran')
    if int(lc_counter['lanes']) <= 0:
        raise AssertionError('path E configuration: no lane took light '
                             'coordinates')
    path_h(xml_e)

    scene, _, _ = parse_scene(xml_f, device='cuda')
    log(f'moving open scene: {scene.num_tris} triangles, has_motion '
        f'{scene.has_motion}, '
        f'{int((scene.tri_p[0] != scene.tri_p[1]).any(-1).any(-1).sum())} '
        f'of them move')
    del scene
    ph_f = parity('F', xml_f, sky=True)
    launch_f = ph_f['launches']
    walks_f = {k: launch_f[k] for k in WALK_KEYS}
    log(f'path F configuration: brute-force kernel launches closest / any '
        f'{launch_f["brute_closest_hit"]} / {launch_f["brute_any_hit"]}, '
        f'eager calls a step {ph_f["eager_calls"]}, graphs a step '
        f'{ph_f["graphs"]} (path D configuration {ph_d["graphs"]}); walk '
        f'launches {walks_f}')
    if min(launch_f['brute_closest_hit'], launch_f['brute_any_hit']) <= 0 \
            or ph_f['eager_calls'] or any(walks_f.values()) \
            or ph_f['graphs'] != ph_d['graphs']:
        raise AssertionError('path F configuration: every query of a moving '
                             'scene must be the brute-force kernel, inside '
                             'the graphs')
    ph_g = parity('G', xml_g)
    ph_i = parity('I', xml_f, bvh=True, sky=True)
    launch_i = ph_i['launches']
    brute_i = {k: launch_i[k] for k in ('brute_closest_hit', 'brute_any_hit')}
    walks_i = {k: launch_i[k] for k in WALK_KEYS}
    log(f'path I configuration: BVH kernel launches closest / any '
        f'{launch_i["bvh_closest_hit"]} / {launch_i["bvh_any_hit"]}, '
        f'brute-force launches {brute_i}, walk launches {walks_i}')
    if any(brute_i.values()) or any(walks_i.values()) \
            or min(launch_i['bvh_closest_hit'], launch_i['bvh_any_hit']) <= 0:
        raise AssertionError('path I configuration: every query must take '
                             'the BVH kernel')

    for (key, _), row in bvh_rows.items():
        row['launches'] = launch_i['bvh_' + key]
    for key, row in brute_rows.items():
        row['launches'] = launch_f['brute_' + key]
    knn_row['launches_path_a'] = ph_a['launches']['knn_query']
    knn_row['launches_path_e'] = ph_e['launches']['knn_query']
    for path, ph in (('E', ph_e), ('G', ph_g)):
        for key in ('split_closest_hit', 'split_any_hit'):
            rows[key][f'launches_path_{path.lower()}'] = ph['launches'][key]
            if ph['launches'][key] <= 0:
                raise AssertionError(f'{rows[key]["name"]} was never '
                                     f'launched by path {path}')
    for key, row in open_kernel_rows.items():
        row['launches'] = ph_d['launches'][key]
        if row['launches'] <= 0:
            raise AssertionError(f'{row["name"]} was never launched by '
                                 f'path D')
    for key, launches in (('split_closest_hit', ph_a['launches']),
                          ('split_any_hit', ph_a['launches']),
                          ('sweep_closest_hit', ph_b['launches']),
                          ('sweep_any_hit', ph_b['launches']),
                          ('closest_hit_resident', launch_c),
                          ('any_hit_resident', launch_c)):
        rows[key]['launches'] = launches[key]
        if launches[key] <= 0:
            raise AssertionError(f'{rows[key]["name"]} was never launched by '
                                 f'the path that runs it')
    log(f'total {time.time() - t_start:.1f} s')
    print(json.dumps({'kernels': list(rows.values())
                      + list(open_kernel_rows.values())
                      + list(bvh_rows.values())
                      + list(brute_rows.values()) + [knn_row]}))
    print(f'nvidia-smi: {card}')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    if sys.argv[1:2] == ['--rank']:
        rank_main(sys.argv[2:])
    else:
        main()
