"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. the build of every kernel source in langevin_mcmc_tpu_torch/csrc/ (one
     nvcc per source, in parallel, linked into one library);
  3. the chunk walk (K1 closest hit, K2 any hit) against its plain torch
     version on the generated flagship scene (24,576-triangle torus,
     65,536 rays: half camera rays, half from surface points in random
     directions with 30% of those dead), with CUDA-event timings;
  3b. on the same rays, the chunk walk's resident form (K3, both variants)
     and the culled sweep (K4, both variants) against their plain
     versions, and the sweep's t against the chunk walk's on every hit
     (the ids may differ only on exact ties of t, which are counted);
  4. path generation on the card against the CPU plain path on a small
     generated scene (same tape);
  5. path A, the MALA render through the CLI entry point: 1024x768,
     maxdepth 8, 65,536 chains, 300,000 bootstrap samples, directspp 1,
     --spp 1 (12 chain iterations); it runs K1/K2;
  6. path B, the same configuration with H2MC small steps and
     LMCMC_ISECT_BACKEND=pallas, so it runs K4; the ratio of the two chain
     loops' proposals/s is the H2MC/MALA cost ratio at the same tuning;
  7. path C, the MC integrator on the flagship scene (--spp 1) with
     LMC_CW_VMEM_BYTES=6291456, so it runs K3.
Each render's film must be finite, non-negative, non-zero and 768x1024x3,
and each kernel must have been launched by the path that runs it (the
launch counts are reset just before each path and read just after).
The line before the last two is {"kernels": [...]}: per kernel its
launches on its path, max |error| against the plain version, its time and
the plain version's (ms), and its bound: the larger of the f32 operations
of the ray-triangle tests this run's data needs (40 per test) over the
67 TFLOP/s f32 peak and its bytes (each input read once, each output
written once) over 3.35 TB/s (H100 SXM data sheet). No PyTorch call
computes a closest-hit ray query, so library_ms is null.
The last line is {"ok": true, "device": {...}}.
"""

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
OPS_PER_TEST = 40       # f32 operations of one ray-triangle test
PEAK_F32 = 67e12        # H100 SXM f32 peak, FLOP/s
PEAK_BYTES = 3.35e12    # H100 SXM HBM3, bytes/s


def log(msg):
    print(msg, flush=True)


def write_flagship(out_dir, num_init_samples=INIT_SAMPLES, **kw):
    """Write the generated flagship scene (24,576-triangle torus, 1024x768,
    maxdepth 8, 65,536 chains) into out_dir; returns the XML path. kw:
    write_scene's kernel / integrator."""
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


def bound(tests, in_bytes, out_bytes):
    """(bound_ms, bound_by): the larger of the operations' and the bytes'
    least times on the card."""
    ops_ms = OPS_PER_TEST * tests / PEAK_F32 * 1e3
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms \
        else (bytes_ms, 'bytes')


def blocks_until_occluded(pack, chunk_idx, counts, org, d, rng):
    """Chunks each ray block visits before every one of its rays is
    occluded (or its list ends): the work the any-hit variants need."""
    from langevin_mcmc_tpu_torch.ops.chunkwalk import RAY_BLOCK, _tile
    nb = counts.shape[0]
    o = org.reshape(nb, RAY_BLOCK, 3)
    dd = d.reshape(nb, RAY_BLOCK, 3)
    r = rng.reshape(nb, RAY_BLOCK, 2)
    cols = [x[..., None] for x in (o[..., 0], o[..., 1], o[..., 2],
                                   dd[..., 0], dd[..., 1], dd[..., 2],
                                   r[..., 0], r[..., 1])]
    occ = torch.zeros((nb, RAY_BLOCK), dtype=torch.bool, device=org.device)
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
               in_bytes, rays):
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    err = compare(name, got, want, any_hit)
    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain)
    bound_ms, bound_by = bound(tests, in_bytes, rays * (1 if any_hit else 16))
    log(f'{name}: equal to the plain version (max |err| {err}); kernel '
        f'{ms:.3f} ms, plain {plain_ms:.3f} ms, {tests:.4g} ray-triangle '
        f'tests, bound {bound_ms:.3f} ms ({bound_by})')
    return dict(name=name, route='cuda', source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def check_kernels(scene):
    """Every kernel variant against its plain version on the flagship
    scene. Returns the rows of the kernels JSON line (launches filled
    later), keyed by the launch-count name."""
    from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
    from langevin_mcmc_tpu_torch.ops import sweep_isect as sw
    org, d, mn, mx = kernel_rays(scene, 65536, seed=7)
    R = org.shape[0]
    (chunk_idx, counts, o, dd, rng), _ = cw.prepare_rays(scene.cw, org, d,
                                                         mn, mx)
    args = (scene.cw.pack, scene.cw.ids, chunk_idx, counts, o, dd, rng)
    torch.cuda.synchronize()
    log(f'kernel inputs: {o.shape[0]} rays, {counts.shape[0]} blocks, '
        f'{scene.cw.pack.shape[0]} chunks, mean list length '
        f'{counts.float().mean().item():.2f}')
    cw_src = 'langevin_mcmc_tpu_torch/csrc/chunkwalk.cu'
    cw_in = nbytes(*args)
    tests_c = int(counts.sum()) * cw.RAY_BLOCK * cw.TRI_CHUNK
    tests_a = int(blocks_until_occluded(scene.cw.pack, *args[2:]).sum()) \
        * cw.RAY_BLOCK * cw.TRI_CHUNK
    rows = {}
    for resident, (closest, anyhit, rep_c, rep_a) in (
            (False, ('chunkwalk_closest_hit', 'chunkwalk_any_hit',
                     'langevin_mcmc_tpu/ops/chunkwalk.py:157',
                     'langevin_mcmc_tpu/ops/chunkwalk.py:180')),
            (True, ('chunkwalk_resident_closest_hit',
                    'chunkwalk_resident_any_hit',
                    'langevin_mcmc_tpu/ops/chunkwalk.py:280',
                    'langevin_mcmc_tpu/ops/chunkwalk.py:315'))):
        sfx = '_resident' if resident else ''
        rows['closest_hit' + sfx] = kernel_row(
            closest, cw_src, rep_c,
            lambda: cw.walk(*args, any_hit=False, resident=resident),
            lambda: cw.walk_reference(*args, any_hit=False), False,
            tests_c, cw_in, R)
        rows['any_hit' + sfx] = kernel_row(
            anyhit, cw_src, rep_a,
            lambda: cw.walk(*args, any_hit=True, resident=resident),
            lambda: cw.walk_reference(*args, any_hit=True), True,
            tests_a, cw_in, R)

    (mask, so, sd, srng), _ = sw.prepare_rays(scene.sweep, org, d, mn, mx)
    sargs = (scene.sweep.pack, scene.sweep.ids, mask, so, sd, srng)
    visits = int(mask.sum())
    lists = torch.argsort((mask == 0).to(torch.int32), dim=1, stable=True)
    log(f'sweep inputs: {mask.shape[0]} blocks x {mask.shape[1]} chunks of '
        f'{sw.TRI_CHUNK}, {visits} (block, chunk) pairs visited')
    tests_sa = int(blocks_until_occluded(
        scene.sweep.pack, lists.to(torch.int32), mask.sum(1), so, sd,
        srng).sum()) * sw.RAY_BLOCK * sw.TRI_CHUNK
    sw_src = 'langevin_mcmc_tpu_torch/csrc/sweep.cu'
    sw_in = nbytes(*sargs)
    rows['sweep_closest_hit'] = kernel_row(
        'sweep_closest_hit', sw_src, 'langevin_mcmc_tpu/ops/pallas_isect.py:129',
        lambda: sw.walk(*sargs, any_hit=False),
        lambda: sw.sweep_reference(*sargs, any_hit=False), False,
        visits * sw.RAY_BLOCK * sw.TRI_CHUNK, sw_in, R)
    rows['sweep_any_hit'] = kernel_row(
        'sweep_any_hit', sw_src, 'langevin_mcmc_tpu/ops/pallas_isect.py:193',
        lambda: sw.walk(*sargs, any_hit=True),
        lambda: sw.sweep_reference(*sargs, any_hit=True), True,
        tests_sa, sw_in, R)

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
    log(f'generation card vs CPU: {a.shape[0]} lanes, {bad} beyond rtol '
        f'1e-3 (max rel {rel.max():.3g}), mean ls {a.mean():.6g} vs '
        f'{b.mean():.6g}')
    if bad > a.shape[0] // 100:
        raise AssertionError(f'{bad} lanes of card generation diverge from '
                             f'the CPU plain path')


def render(label, xml, env):
    """One render through the CLI with env set around it. Checks the film;
    returns (CLI result, launch counts of this render by row key)."""
    from langevin_mcmc_tpu_torch.__main__ import main as cli_main
    from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
    from langevin_mcmc_tpu_torch.ops import sweep_isect as sw
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    torch.cuda.reset_peak_memory_stats()
    cw.reset_launch_counts()
    sw.reset_launch_counts()
    try:
        res = cli_main([xml, '--spp', '1', '--chunk', str(CHUNK),
                        '--output-dir', os.path.join(OUT, label),
                        '--device', 'cuda'])[0]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = dict(cw.launch_counts)
    launches.update({'sweep_' + k: v for k, v in sw.launch_counts.items()})
    film = res['film']
    log(f'{label}: {env or "default backends"}; total {res["seconds"]:.2f} '
        f's, peak device memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    log(f'{label}: kernel launches {launches}')
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
    return res, launches


def chain_rate(label, res):
    tm = res['timings']
    props = tm['steps'] * res['opts'].num_chains / tm['loop_s']
    log(f'{label}: b = {res["b"]:.6g}; direct {tm["direct_s"]:.2f} s, '
        f'bootstrap {tm["bootstrap_s"]:.2f} s, chain loop {tm["loop_s"]:.2f} '
        f's ({tm["steps"]} iterations, {tm["loop_s"] / tm["steps"] * 1e3:.1f} '
        f'ms each), {props:.1f} proposals/s')
    return props


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
    small_xml = testscenes.write_scene(os.path.join(OUT, 'small'), small=True,
                                       width=64, height=48, max_depth=4)
    scene, opts, _ = parse_scene(xml, device='cuda')
    log(f'flagship scene: {scene.num_tris} triangles, '
        f'{scene.cw.pack.shape[0]} chunks of 128 '
        f'({scene.cw.pack.numel() * 4} bytes), {scene.sweep.pack.shape[0]} '
        f'of 512, {opts.num_chains} chains, maxdepth {opts.max_depth}, '
        f'{opts.num_init_samples} bootstrap samples, '
        f'{scene.width}x{scene.height}')
    rows = check_kernels(scene)
    check_generation(small_xml)
    del scene

    res_a, launch_a = render('path A (MALA)', xml, {})
    rate_a = chain_rate('path A (MALA)', res_a)
    res_b, launch_b = render('path B (H2MC)', xml_h2mc,
                             {'LMCMC_ISECT_BACKEND': 'pallas'})
    rate_b = chain_rate('path B (H2MC)', res_b)
    log(f'H2MC/MALA cost ratio (chain-loop proposals/s, same tuning, same '
        f'card): {rate_a / rate_b:.3f}')
    _, launch_c = render('path C (MC)', xml_mc,
                         {'LMC_CW_VMEM_BYTES': str(RESIDENT_BYTES)})
    for key, launches in (('closest_hit', launch_a), ('any_hit', launch_a),
                          ('sweep_closest_hit', launch_b),
                          ('sweep_any_hit', launch_b),
                          ('closest_hit_resident', launch_c),
                          ('any_hit_resident', launch_c)):
        rows[key]['launches'] = launches[key]
        if launches[key] <= 0:
            raise AssertionError(f'{rows[key]["name"]} was never launched by '
                                 f'the path that runs it')
    log(f'total {time.time() - t_start:.1f} s')
    print(json.dumps({'kernels': list(rows.values())}))
    print(f'nvidia-smi: {card}')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
