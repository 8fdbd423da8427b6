"""One run of one cell: set-up, the measured window, the traced call, the
check, and the result line's fields."""

import gc
import importlib
import shutil
import sys
import tempfile
import time

import torch

from . import check, devtrace, manifest, scenegen

# what the render's set-up is given where the configuration does not say
CHUNK = 8192            # the CLI's --chunk: the generation passes' width
N_SAMPLE = 1024         # chains the check samples (the longest added)
N_GRAD = 512            # gradient chains the check samples, in the cells
                        # whose limits hold grad_mismatch
B_PATHS = 16384         # the reference's own paths estimating b, in the
                        # cells whose limits hold b_gap
# the CPU-sized form (--small, for the tests): scenegen's small scene
SMALL = dict(width=64, height=48, num_chains=512, num_init_samples=1024,
             chunk=512, n_sample=64, n_grad=32, n_inner=2,
             b_paths=1024)

PROG = 'langevin_mcmc_tpu_torch'     # the system under test
# the port's launch counters of its ray-query wrappers, by module
ISECT_MODULES = ('ops.chunkwalk', 'ops.sweep_isect', 'ops.bvh',
                 'ops.intersect')


def _launches():
    out = {}
    for name in ISECT_MODULES:
        counts = getattr(sys.modules.get(f'{PROG}.{name}'), 'launch_counts',
                         None)
        for k, v in (counts or {}).items():
            out[f'{name}.{k}'] = v
    return out


def _write_scene(cell, small, out_dir):
    c, t = cell.config, cell.traffic
    size = dict(width=c['width'], height=c['height'],
                num_chains=c['num_chains'],
                num_init_samples=c['num_init_samples'])
    if small:
        size = {k: SMALL[k] for k in size}
    return scenegen.write_scene(
        out_dir, small=small, max_depth=c['max_depth'], kernel=t['kernel'],
        integrator='mcmc', scene=c['scene'], large_step=t['large_step'],
        light_coords=t['light_coords'], motion=c['motion'], **size)


def _check_options(cell, opts, small):
    """The parsed <dpt> options are the configuration's and the traffic's."""
    c, t = cell.config, cell.traffic
    want = dict(max_depth=c['max_depth'], bidirectional=c['bidirectional'],
                large_step_probability=c['large_step_probability'],
                direct_spp=c['direct_spp'], mala=t['kernel'] == 'mala',
                h2mc=t['kernel'] == 'h2mc',
                large_step_multiplexed=t['large_step'] != 'plain',
                sample_from_global_cache=t['large_step'] == 'cache',
                use_light_coordinate_sampling=t['light_coords'])
    if not small:
        want.update(num_chains=c['num_chains'],
                    num_init_samples=c['num_init_samples'])
    got = {k: getattr(opts, k) for k in want}
    if got != want:
        raise ValueError(f'the parsed options {got} are not the cell\'s '
                         f'{want}')


def run(cell, seed, seconds, trace, device, small=False, t_start=None,
        control=False):
    """Run the cell once; returns (result dict, compared rows). `device`
    is a torch.device (the card, or the CPU for --small). control: also
    judge the control, the reference in bfloat16 put in the program's
    place on the same sampled records (result['control']); the
    benchmark's own runs never do."""
    t_start = time.perf_counter() if t_start is None else t_start
    tmp = tempfile.mkdtemp(prefix='lmcbench-')
    try:
        return _run(cell, seed, seconds, trace, device, small, t_start,
                    tmp, control)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _run(cell, seed, seconds, trace, device, small, t_start, tmp, control):
    mlt = importlib.import_module(f'{PROG}.integrators.mlt')
    pathtrace = importlib.import_module(f'{PROG}.integrators.pathtrace')
    parse = importlib.import_module(f'{PROG}.scene.parse')
    cuda = device.type == 'cuda'
    xml = _write_scene(cell, small, tmp)
    if cuda:
        # the CUDA context and the port's kernel library (built into the
        # checkout's langevin_mcmc_tpu_torch/_build/ on a first run)
        torch.zeros(1, device=device)
        importlib.import_module(f'{PROG}.ops.cuda_build').load_library()
        torch.cuda.reset_peak_memory_stats(device)
    scene, opts, _ = parse.parse_scene(xml, device=device)
    _check_options(cell, opts, small)
    chunk = SMALL['chunk'] if small else cell.config.get('chunk', CHUNK)
    n_inner = int(cell.traffic['n_inner'])
    limits = cell.traffic['limits']
    if small:
        n_inner = min(n_inner, SMALL['n_inner'])
        # the CPU-sized scene's own readings: its few chains and
        # iterations accept and spread differently
        limits = dict(limits, **cell.traffic.get('small_limits', {}))
    C = opts.num_chains
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    spans = {}
    with torch.no_grad():
        # ---- the render's start, as render_mlt starts it ----
        _sync(device)
        t0 = time.perf_counter()
        b, length_dist, banked = mlt.bootstrap(scene, opts, gen, chunk=chunk)
        _sync(device)
        spans['bootstrap_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if opts.direct_spp > 0:
            pathtrace.render_direct(scene, opts, gen, chunk=chunk)
        _sync(device)
        spans['direct_s'] = time.perf_counter() - t0
        pool = torch.cuda.graph_pool_handle() if cuda else None
        multi = mlt.make_mlt_multi_step(
            scene, opts, b, opts.large_step_probability, n_inner,
            length_dist=length_dist, pool=pool)
        film = torch.zeros((scene.height, scene.width, 3), device=device)
        init_banked = banked
        banked = mlt.attach_cache(banked, opts)
        for step_name in cell.traffic.get('setup', []):
            ctx = dict(scene=scene, opts=opts, banked=banked,
                       init_banked=init_banked, generator=gen, prog=PROG,
                       b=b, length_dist=length_dist)
            manifest.load_setup_step(step_name)(ctx)
            banked = ctx['banked']
        _sync(device)
        t0 = time.perf_counter()
        banked, film, nd = multi(gen, banked, film, init_banked)
        _sync(device)
        spans['first_call_s'] = time.perf_counter() - t0
        render_start_s = (spans['bootstrap_s'] + spans['direct_s']
                          + spans['first_call_s'])
        # the chains settle (on MALA the cache rows fill and the gradient
        # branches stop running) before the window measures the steady
        # chain loop
        settle = int(cell.traffic.get('settle_calls', 0))
        t0 = time.perf_counter()
        for _ in range(settle):
            banked, film, nd = multi(gen, banked, film, init_banked)
        _sync(device)
        spans['settle_s'] = time.perf_counter() - t0
        setup_s = time.perf_counter() - t_start

        # ---- the window ----
        graphs = multi.graphs
        accepts0 = int(multi.step.counts['accepts'])
        launches0 = _launches()
        reads0 = (graphs.branch_runs + graphs.branch_skips) if graphs \
            else None
        n_done = torch.zeros((), dtype=torch.int64, device=device)
        last_call_s = 0.0
        reduce_trace = None
        calls, call_s, profiled_call = 0, [], None
        # no collection of the set-up's objects pauses the window
        gc.collect()
        gc.freeze()
        gc.disable()
        _sync(device)
        t_w0 = time.perf_counter()
        deadline = t_w0 + seconds
        # a traced run profiles the first call that starts in the window's
        # second half (the last call where none does), and reduces the
        # profile once the window has closed
        while calls == 0 or time.perf_counter() < deadline:
            call = lambda: multi(gen, banked, film, init_banked)
            now = time.perf_counter()
            if (trace and cuda and reduce_trace is None
                    and (now >= t_w0 + seconds / 2
                         or now + last_call_s >= deadline)):
                (banked, film, nd), reduce_trace = devtrace.profiled(
                    call, device)
                profiled_call = calls
            else:
                banked, film, nd = call()
            n_done += nd
            calls += 1
            _sync(device)
            last_call_s = time.perf_counter() - now
            call_s.append(last_call_s)
        window_s = time.perf_counter() - t_w0
        gc.enable()
        gc.unfreeze()

        # ---- after the window ----
        prof = reduce_trace() if reduce_trace is not None else None
        iters = calls * n_inner
        attempted = iters * C
        done = int(n_done)
        memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        counts = {k: int(v) for k, v in multi.step.counts.items()}
        launches = {k: v - launches0.get(k, 0)
                    for k, v in _launches().items()}
        reads = (graphs.branch_runs + graphs.branch_skips - reads0) \
            if graphs else None
        sample = check.take(
            seed, banked, init_banked, opts, film, b,
            iters + (1 + settle) * n_inner,
            SMALL['n_sample'] if small else N_SAMPLE,
            0 if 'grad_mismatch' not in limits
            else SMALL['n_grad'] if small else N_GRAD,
            0 if 'b_gap' not in limits
            else SMALL['b_paths'] if small else B_PATHS,
            acceptance=(counts['accepts'] - accepts0) / attempted)
        capture_s = multi.capture_pass_s if graphs else None
    # the program's state goes before the reference runs
    del multi, banked, init_banked, film, scene, graphs, nd, n_done
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = check.Reference(xml, device)
    numbers, info = check.judge(sample, ref)
    info['check_s'] = time.perf_counter() - t0
    control_numbers = check.control(sample, xml, device, ref) if control \
        else None
    del ref
    correct, rows = check.verdict(numbers, limits)

    ctx = dict(spans=spans, iterations=iters, calls=calls, n_inner=n_inner,
               chains=C, attempted=attempted, window_s=window_s,
               accepts=counts['accepts'] - accepts0, launches=launches,
               host_reads=reads, capture_s=capture_s, trace=prof,
               proposals_per_s=attempted / window_s,
               render_start_s=render_start_s, setup_s=setup_s)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = manifest.load_reader(m['name'])(ctx)
            if v is not None:
                metrics[m['name']] = dict(value=float(v), unit=m['unit'])
    else:
        for m in cell.end_to_end:
            metrics[m['name']] = dict(value=float(ctx[m['name']]),
                                      unit=m['unit'])
    if cuda:
        dev_info = dict(platform='gpu',
                        kind=torch.cuda.get_device_name(device),
                        count=1, memory_peak_bytes=int(memory_peak))
    else:
        dev_info = dict(platform='cpu', kind='cpu', count=1,
                        memory_peak_bytes=0)
    result = dict(correct=bool(correct and done == iters),
                  attempted=attempted,
                  failed=(iters - done) * C, metrics=metrics,
                  device=dev_info)
    if prof is not None:
        dev_info.update(busy_s=prof.busy_s, window_s=prof.window_s)
        result['breakdown'] = prof.breakdown()
    if control_numbers is not None:
        result['control'] = control_numbers
    rows.append(('iterations_not_finite', float(iters - done), 0.0))
    result['info'] = dict(info, seed=int(seed), calls=calls,
                          profiled_call=profiled_call,
                          iterations=iters, b=float(b),
                          call_s=[round(x, 4) for x in call_s],
                          **{k: round(v, 6) for k, v in spans.items()})
    result['check'] = {k: dict(value=v, limit=lim) for k, v, lim in rows}
    return result, rows
