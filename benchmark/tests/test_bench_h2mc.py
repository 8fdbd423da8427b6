"""The cell torus_box.h2mc (H2MC small steps) through the harness at the
CPU-sized scene (--small), and two faults of H2MC that leave every path
right, so path_mismatch passes them:

* density_dropped: the MH ratio without the Gaussian densities' terms,
  exp(px - py) left out;
* hess_offdiag_zeroed: the Hessian's off-diagonal entries zeroed, so the
  Gaussians are the wrong ones.

The acceptance band catches neither at the CPU size (CAUGHT_BY_BAND), so
the run's `correct` passes both. The checks of lmcbench/h2mc_check.py,
which check.py does not call yet, catch them: the second's stored
Gaussians lie off the reference's (gauss_mismatch), and both faults'
acceptance probabilities lie off the reference's MH ratio
(mh_mismatch).

On the card it runs the cell at its own size, as the benchmark does,
with a fault of FAULTS planted where one is named, and judges the state
the timed path left: 512 stored Gaussians and one more H2MC step of those
chains against the float64 reference and against the control (the
reference in bfloat16):

    python3 benchmark/tests/test_bench_h2mc.py [--seconds S] [--fault F]
        [--registry] [--no-gauss] [--save DIR] [--workload CELL] <seed>...
    python3 benchmark/tests/test_bench_h2mc.py --judge FILE...
    python3 benchmark/tests/test_bench_h2mc.py --eigh-kernels

one JSON line a run: the run's verdict and compared numbers, its
end-to-end metrics, the graph record of its step, the path control's
numbers, gauss and mh (the program against the reference), gauss_control
and mh_control (the control against the same), and with_h2mc_checks:
what `correct` reads with gauss_mismatch and mh_mismatch held to their
limits too. With --registry the trace registry is on (its graphs
stamped) and the window's stages and lane counters an iteration are
reported. With --save the sampled chains go to DIR/<cell>.<seed>.<fault>.pt
and are not judged; --judge judges such files on the host (the reference
parses the same generated scene). --eigh-kernels profiles
mcmc/gaussian.py's _eigh at the step's batch sizes and prints the device
kernels it ran, by name."""

import json
import os
import shutil
import sys
import tempfile
import time

import pytest
import torch

from _util import THREADS, last_json, run_cli
from lmcbench import cell as cell_mod, check, h2mc_check, manifest
from test_bench_faults import (always_accept, answer_altered,
                               density_dropped, half_left_out,
                               splats_flipped, splats_halved, unchanged)

NAME = 'torus_box.h2mc'


def hess_offdiag_zeroed(monkeypatch):
    """The Hessian's off-diagonal entries come out zero."""
    from langevin_mcmc_tpu_torch.path import replay
    orig = replay.path_grad_hessian

    def broken(*a, **k):
        g, h, finite = orig(*a, **k)
        eye = torch.eye(h.shape[-1], dtype=torch.bool, device=h.device)
        return g, torch.where(eye, h, torch.zeros_like(h)), finite
    monkeypatch.setattr(replay, 'path_grad_hessian', broken)


FAULTS = {f.__name__: f for f in (
    density_dropped, hess_offdiag_zeroed, always_accept, answer_altered,
    half_left_out, splats_flipped, splats_halved, unchanged)}
# whether the cell's acceptance band (small_limits) catches each fault at
# the CPU size
CAUGHT_BY_BAND = dict(density_dropped=False, hess_offdiag_zeroed=False)


def run_sampled(name, seed, seconds, device, small=False, fault=None,
                registry=False, gauss=True, n_gauss=h2mc_check.N_GAUSS,
                control=False):
    """The cell's run as the benchmark makes it (cell.run), with the
    stored Gaussians sampled (take_gauss) and one more H2MC step of those
    chains taken (take_mh) where check.take samples the paths. Returns
    (a dict of the run's numbers, the samples or None)."""
    from langevin_mcmc_tpu_torch.integrators import mlt
    from langevin_mcmc_tpu_torch.ops import tracing
    cell = manifest.load_cell(name)
    box = {}
    mp = pytest.MonkeyPatch()
    orig_take = check.take
    orig_make = mlt.make_mlt_multi_step
    window_from = 1 + int(cell.traffic.get('settle_calls', 0))

    def take(seed_, banked, init_banked, opts, *a, **k):
        if gauss:
            sample = h2mc_check.take_gauss(seed_, banked, opts, n=n_gauss)
            box['samples'] = dict(
                cell=name, seed=seed_, fault=fault, small=small,
                sample=sample, mh=h2mc_check.take_mh(
                    seed_, sample, banked, box['scene'], opts))
        box['graphs'] = tracing.snapshot()['graphs']
        if registry:
            box['b'] = tracing.snapshot()
        return orig_take(seed_, banked, init_banked, opts, *a, **k)
    mp.setattr(check, 'take', take)

    def make(scene, *a, **k):
        box['scene'] = scene
        multi = orig_make(scene, *a, **k)
        if not registry:
            return multi
        call = multi.__call__

        class Counted:
            n = 0

            def __getattr__(self, attr):
                return getattr(multi, attr)

            def __call__(self, *ca):
                if Counted.n == window_from:
                    box['a'] = tracing.snapshot()
                Counted.n += 1
                return call(*ca)
        return Counted()
    mp.setattr(mlt, 'make_mlt_multi_step', make)
    if registry:
        tracing.enable(device)
    if fault:
        FAULTS[fault](mp)
    try:
        res, _ = cell_mod.run(cell, seed, seconds, False, device, small=small,
                              control=control)
    finally:
        mp.undo()
        if registry:
            tracing.disable()
    out = dict(cell=name, seed=seed, fault=fault, correct=res['correct'],
               check={k: v['value'] for k, v in res['check'].items()},
               metrics={k: v['value'] for k, v in res['metrics'].items()},
               device=res['device'], info=res['info'],
               graphs=list(box['graphs'].values()))
    if control:
        out['path_control'] = res['control']
    if registry:
        d = tracing.delta(box['a'], box['b'])
        iters = res['info']['iterations']
        out['registry'] = dict(
            iterations=iters,
            stages_ms={k: dict(self=v['self_ms'] / iters,
                               incl=v['incl_ms'] / iters,
                               count=v['count'])
                       for k, v in tracing.stages_ms(d).items()},
            device_ms=(d['device_ns'] or 0) * 1e-6 / iters,
            lanes={k: {s: v / iters for s, v in c.items()}
                   for k, c in d['lanes'].items()})
    return out, box.get('samples')


def judge_samples(samples, workers=1, controls=True):
    """gauss and mh (the program against the float64 reference) and,
    where controls, gauss_control and mh_control (the reference in
    bfloat16 in the program's place) of run_sampled's samples, the
    reference computed on the host in `workers` processes."""
    cell = manifest.load_cell(samples['cell'])
    sample, mh = samples['sample'], samples['mh']
    out = {}
    tmp = tempfile.mkdtemp(prefix='lmcbench-h2mc-')
    try:
        xml = cell_mod._write_scene(cell, samples['small'], tmp)
        t0 = time.perf_counter()
        want = h2mc_check.reference_gauss(sample, xml, workers=workers)
        num, info = h2mc_check.judge_gauss(sample, want)
        out['gauss'] = dict(num, **info)
        a_ref = h2mc_check.reference_mh(sample, mh, want, xml,
                                        workers=workers)
        num, info = h2mc_check.judge_mh(mh, a_ref)
        out['mh'] = dict(num, **info, s=time.perf_counter() - t0)
        if controls:
            t0 = time.perf_counter()
            low = h2mc_check.reference_gauss(sample, xml, torch.bfloat16,
                                             workers=workers)
            num, info = h2mc_check.judge_gauss(sample, want, gauss=low)
            out['gauss_control'] = dict(num, **info)
            a_low = h2mc_check.reference_mh(sample, mh, low, xml,
                                            torch.bfloat16, workers=workers)
            num, info = h2mc_check.judge_mh(mh, a_ref, a=a_low)
            out['mh_control'] = dict(num, **info,
                                     s=time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def with_h2mc_checks(correct, judged):
    """What `correct` reads once check.py holds gauss_mismatch and
    mh_mismatch to their limits too."""
    return bool(correct and judged['gauss']['gauss_mismatch']
                <= h2mc_check.GAUSS_LIMIT
                and judged['mh']['mh_mismatch'] <= h2mc_check.MH_LIMIT)


def eigh_kernels(device):
    """The device kernels _eigh runs on [n, 16, 16] symmetric batches at
    the step's two sizes, by name, with their device ms."""
    from torch.profiler import ProfilerActivity, profile
    from langevin_mcmc_tpu_torch.mcmc import gaussian as G
    from lmcbench.devtrace import Trace
    out = {}
    for n in (8192, 65536):
        a = torch.randn((n, 16, 16), device=device)
        h = a + a.transpose(1, 2)
        G._eigh(h)
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            G._eigh(h)
            torch.cuda.synchronize(device)
        tr = Trace.from_events(prof.profiler.kineto_results.events())
        out[n] = {k: v * 1e3 for k, v in sorted(tr.kernels.items(),
                                                 key=lambda kv: -kv[1])}
    return out


# ---------------------------------------------------------------------------
# CPU tests
# ---------------------------------------------------------------------------

def test_h2mc_reference_imports_nothing_of_the_port_and_sets_tf32_off():
    """The H2MC reference and its check import neither the port nor JAX
    (by their sources, and by what importing them loads), and importing
    the reference turns TF32 off."""
    import ast
    import subprocess
    from _util import BENCH
    forbidden = {'jax', 'jaxlib', 'flax', 'langevin_mcmc_tpu',
                 'langevin_mcmc_tpu_torch'}
    for rel in ('lmcref/mcmc/h2mc.py', 'lmcref/mcmc/__init__.py',
                'lmcbench/h2mc_check.py'):
        with open(os.path.join(BENCH, rel)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else [node.module] \
                if isinstance(node, ast.ImportFrom) and node.level == 0 \
                else []
            assert not {n.split('.')[0] for n in names} & forbidden, \
                (rel, names)
    code = ('import sys, torch\n'
            'torch.backends.cuda.matmul.allow_tf32 = True\n'
            'torch.backends.cudnn.allow_tf32 = True\n'
            'import lmcref.mcmc.h2mc, lmcbench.h2mc_check\n'
            'print(sorted({m.split(".")[0] for m in sys.modules}), '
            'torch.backends.cuda.matmul.allow_tf32, '
            'torch.backends.cudnn.allow_tf32)')
    out = subprocess.run([sys.executable, '-c', code], cwd=BENCH,
                         capture_output=True, text=True, check=True).stdout
    tops, tf32 = out.strip().split('] ')
    assert not set(eval(tops + ']')) & forbidden
    assert tf32.split() == ['False', 'False']


@pytest.mark.parametrize('trace', [0, 1])
def test_h2mc_cell_runs_small(trace):
    rc, out, err = run_cli(['--workload', NAME, '--seed', '3000000123',
                            '--seconds', '1', '--trace', str(trace),
                            '--small'])
    assert rc == 0, err[-3000:]
    res = last_json(out)
    cell = manifest.load_cell(NAME)
    limits = cell.traffic['limits']
    assert res['check']['path_mismatch']['value'] <= limits['path_mismatch']
    assert res['check']['iterations_not_finite']['value'] == 0.0
    assert res['correct'] is True, res['check']
    if trace:
        assert set(res['metrics']) <= {x['name'] for x in cell.per_layer}
        assert {'bootstrap_s', 'acceptance'} <= set(res['metrics'])
    else:
        assert set(res['metrics']) == {x['name'] for x in cell.end_to_end}
    assert res['attempted'] > 0 and res['failed'] == 0


def _small_limits():
    t = manifest.load_cell(NAME).traffic
    return dict(t['limits'], **t.get('small_limits', {}))


def test_h2mc_sound_run_passes_the_h2mc_checks():
    """A sound run's stored Gaussians and acceptance probabilities lie
    within the tolerances of the reference's, and the control's do not."""
    torch.set_num_threads(int(THREADS))
    r, samples = run_sampled(NAME, 78, 0.5, torch.device('cpu'), small=True,
                             n_gauss=64)
    j = judge_samples(samples)
    assert r['correct'] is True, r['check']
    assert j['gauss']['gauss_mismatch'] == 0.0, j['gauss']
    assert j['mh']['mh_mismatch'] <= h2mc_check.MH_LIMIT, j['mh']
    assert with_h2mc_checks(r['correct'], j)
    assert j['gauss_control']['gauss_mismatch'] > h2mc_check.GAUSS_LIMIT, \
        j['gauss_control']
    assert j['mh_control']['mh_mismatch'] > h2mc_check.MH_LIMIT, \
        j['mh_control']


@pytest.mark.parametrize('fault', sorted(CAUGHT_BY_BAND))
def test_h2mc_fault_passes_path_mismatch(fault):
    """Each fault passes path_mismatch and the acceptance band, so the
    run's `correct` reads true; the checks of h2mc_check fail it."""
    torch.set_num_threads(int(THREADS))
    r, samples = run_sampled(NAME, 77, 0.5, torch.device('cpu'), small=True,
                             fault=fault, n_gauss=64)
    j = judge_samples(samples, controls=False)
    limits = _small_limits()
    assert r['check']['path_mismatch'] <= limits['path_mismatch'], r
    lo, hi = limits['acceptance']
    in_band = lo <= r['check']['acceptance'] <= hi
    assert in_band != CAUGHT_BY_BAND[fault], r['check']
    assert r['correct'] is True, r['check']
    # the Gaussians of the first fault are right, those of the second are
    # not; the acceptance probabilities of both are off
    if fault == 'density_dropped':
        assert j['gauss']['gauss_mismatch'] == 0.0, j['gauss']
    else:
        assert j['gauss']['gauss_mismatch'] > h2mc_check.GAUSS_LIMIT, \
            j['gauss']
    assert j['mh']['mh_mismatch'] > h2mc_check.MH_LIMIT, j['mh']
    assert not with_h2mc_checks(r['correct'], j)


if __name__ == '__main__':
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument('seeds', nargs='*', type=int)
    p.add_argument('--workload', default=NAME)
    p.add_argument('--seconds', type=float, default=20.0)
    p.add_argument('--fault', default=None, choices=sorted(FAULTS))
    p.add_argument('--registry', action='store_true')
    p.add_argument('--control', action='store_true',
                   help='also the path control (check.control)')
    p.add_argument('--no-gauss', action='store_true')
    p.add_argument('--save', default=None,
                   help='save the samples here, unjudged')
    p.add_argument('--judge', nargs='*', default=[],
                   help='judge saved samples on the host')
    p.add_argument('--small', action='store_true')
    p.add_argument('--eigh-kernels', action='store_true')
    args = p.parse_args()
    os.environ.setdefault('PYTHONUNBUFFERED', '1')
    workers = len(os.sched_getaffinity(0))
    for path in args.judge:
        samples = torch.load(path, weights_only=False)
        t0 = time.perf_counter()
        j = judge_samples(samples, workers=workers)
        print(json.dumps(dict(file=os.path.basename(path),
                              fault=samples['fault'], seed=samples['seed'],
                              judge_s=time.perf_counter() - t0, **j)),
              flush=True)
    dev = torch.device('cpu') if args.small else torch.device('cuda', 0)
    if args.eigh_kernels:
        print(json.dumps(dict(eigh_kernels=eigh_kernels(dev))), flush=True)
    for s in args.seeds:
        r, samples = run_sampled(args.workload, s, args.seconds, dev,
                                 small=args.small, fault=args.fault,
                                 registry=args.registry,
                                 gauss=not args.no_gauss,
                                 control=args.control)
        if samples is not None and args.save:
            os.makedirs(args.save, exist_ok=True)
            torch.save(samples, os.path.join(
                args.save, f'{args.workload}.{s}.{args.fault}.pt'))
        elif samples is not None:
            r.update(judge_samples(samples, workers=workers))
            r['with_h2mc_checks'] = with_h2mc_checks(r['correct'], r)
        print(json.dumps(r), flush=True)
    sys.exit(0)
