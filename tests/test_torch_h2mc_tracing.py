"""The trace registry's H2MC spans and counters (ops/tracing.py), on the
CPU and, where there is a card, on it (tests marked cuda; this file
imports no JAX, so on the card: python -m pytest --noconftest
tests/test_torch_h2mc_tracing.py -q):

* an H2MC step's stages include chain.hess (the Hessian's replicated-lane
  pass, inside chain.grad) and gauss.h2mc (the closed form);
* the counter hess_passes reads each side's row groups after one step
  with tracing on (3, with HESS_LANES set to force them), and 0 with it
  off;
* the counters h2mc_lanes, h2mc_fallback and hess_nonfinite of each
  side against the lanes counted by hand on a planted step: lanes that
  mix, take a large step or hold their Gaussian, and lanes whose frozen
  replay has a non-finite gradient;
* with tracing off the step runs exactly the torch operations (on the
  card: the graph nodes) it runs with the tracing calls taken out.
"""

import contextlib
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.integrators import mlt
from langevin_mcmc_tpu_torch.mcmc import chain
from langevin_mcmc_tpu_torch.mcmc import gaussian as G
from langevin_mcmc_tpu_torch.ops import graphs, tracing
from langevin_mcmc_tpu_torch.path import replay
from langevin_mcmc_tpu_torch.scene.parse import parse_scene


def _setup(tmp, device='cpu', C=64):
    xml = testscenes.write_scene(str(tmp), small=True, width=16, height=12,
                                 max_depth=3, num_init_samples=256,
                                 num_chains=C, kernel='h2mc')
    scene, opts, _ = parse_scene(xml, device=device)
    gen = torch.Generator(device=device).manual_seed(11)
    with torch.no_grad():
        b, ld, banked = mlt.bootstrap(scene, opts, gen, chunk=256)
    return scene, opts, gen, b, ld, banked


@pytest.fixture(scope='module')
def h2mc_box(tmp_path_factory):
    torch.set_num_threads(2)
    return _setup(tmp_path_factory.mktemp('h2mc_box'))


@pytest.fixture
def traced_cpu():
    tracing.enable('cpu')
    try:
        yield
    finally:
        tracing.disable()


def _inputs(scene, opts, banked, seed=3):
    """A planted step's state and draws: every third lane holds its
    Gaussian, every fifth mixes, every seventh takes a large step."""
    C = banked.state.ls_score.shape[0]
    D = opts.max_depth
    lanes = torch.arange(C)
    state = dataclasses.replace(banked.state, gaussian_init=lanes % 3 == 0)
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn((C, 2 * D), generator=gen)
    noise = chain.perturb_noise(gen, C, D, opts, 'cpu')
    return state, z, noise, lanes % 5 == 0, lanes % 7 == 0


def _planted_nonfinite(monkeypatch):
    """The frozen replay's contribution, of the lanes whose record's
    screen x is below 0.3, times 1 + sqrt(offset_0^2): the same value at a
    zero offset, and a gradient that is NaN (the other lanes' square root
    is taken at 1, so no NaN reaches them through the where)."""
    orig = replay.replay_path

    def broken(scene, opts, rec, offset, noise, mode='perturb', **k):
        out = orig(scene, opts, rec, offset, noise, mode=mode, **k)
        if mode != 'frozen' or not torch.is_grad_enabled():
            return out
        mark = (rec.screen_pos[:, 0] < 0.3)[:, None]
        one = torch.ones_like(offset[:, :1])
        x = torch.where(mark, offset[:, :1], one)
        f = torch.where(mark, 1.0 + torch.sqrt(torch.square(x)), one)
        res = dict(out[1], contrib=torch.where(mark, out[1]['contrib'] * f,
                                               out[1]['contrib']))
        return (out[0], res) + tuple(out[2:])
    monkeypatch.setattr(replay, 'replay_path', broken)
    return lambda rec: rec.screen_pos[:, 0] < 0.3


def test_h2mc_stages_include_hess_and_gauss(h2mc_box, traced_cpu):
    scene, opts, gen, b, ld, banked = h2mc_box
    multi = mlt.make_mlt_multi_step(scene, opts, b,
                                    opts.large_step_probability, 2,
                                    length_dist=ld)
    film = torch.zeros((scene.height, scene.width, 3))
    a = tracing.snapshot()
    with torch.no_grad():
        multi(gen, mlt.attach_cache(banked, opts), film, banked)
    d = tracing.delta(a, tracing.snapshot())
    paths = set(d['stages'])
    assert 'mlt.small/chain.grad/chain.hess' in paths
    assert 'mlt.small/chain.replay' in paths
    assert any(p.endswith('/gauss.h2mc') for p in paths)
    t = tracing.stage_times(d)
    # one span a side, two sides an iteration, two iterations
    assert t['chain.hess']['count'] == 2 * 2
    assert t['gauss.h2mc']['count'] == 2 * 2
    assert t['chain.grad']['incl_ns'] >= t['chain.hess']['incl_ns'] > 0


def test_h2mc_counters_match_a_hand_count(h2mc_box, traced_cpu,
                                          monkeypatch):
    scene, opts, gen, b, ld, banked = h2mc_box
    state, z, noise, use_iso, skip = _inputs(scene, opts, banked)
    planted = _planted_nonfinite(monkeypatch)
    C = z.shape[0]
    a = tracing.snapshot()
    with torch.no_grad():
        prop, _ = chain.small_step_h2mc(scene, opts, state, z, noise,
                                        use_iso=use_iso, skip_lanes=skip)
    d = tracing.delta(a, tracing.snapshot())
    Kc = min(C, max(int(C * opts.cur_grad_fraction), 8))
    need = ~state.gaussian_init & ~use_iso & ~skip
    covered = need & (torch.cumsum(need.long(), 0) <= Kc)
    used = prop['ok'] & ~use_iso & ~skip
    iso = G.isotropic_gaussian(C, z.shape[1], opts.perturb_std_dev, 'cpu',
                               dense=True)

    def is_iso(g):
        return ((g.inv_cov == iso.inv_cov).all(-1).all(-1)
                & (g.mean == 0.0).all(-1))
    want = dict(
        h2mc_lanes=dict(cur=int(covered.sum()), prop=int(used.sum())),
        h2mc_fallback=dict(
            cur=int((covered & is_iso(prop['gauss_cur'])).sum()),
            prop=int((used & is_iso(prop['gauss_prop'])).sum())),
        hess_nonfinite=dict(cur=int((covered & planted(state.rec)).sum()),
                            prop=int((used & planted(prop['rec'])).sum())))
    assert {k: d['lanes'][k] for k in want} == want
    # the plant reached lanes on both sides, and both fell back
    assert want['hess_nonfinite']['cur'] > 0
    assert want['hess_nonfinite']['prop'] > 0
    assert want['h2mc_lanes']['cur'] == Kc


@pytest.mark.parametrize('traced', [False, True])
def test_hess_passes_count_row_groups(h2mc_box, traced, monkeypatch):
    scene, opts, gen, b, ld, banked = h2mc_box
    state, z, noise, use_iso, skip = _inputs(scene, opts, banked)
    C, Dm = z.shape
    Kc = min(C, max(int(C * opts.cur_grad_fraction), 8))
    monkeypatch.setattr(replay, 'HESS_LANES', -(-Dm * C // 3))
    want = dict(cur=len(replay.hess_groups(Kc, Dm)),
                prop=len(replay.hess_groups(C, Dm)))
    assert want['prop'] == 3 and want['cur'] >= 1
    if traced:
        tracing.enable('cpu')
    try:
        a = tracing.snapshot()
        with torch.no_grad():
            chain.small_step_h2mc(scene, opts, state, z, noise,
                                  use_iso=use_iso, skip_lanes=skip)
        d = tracing.delta(a, tracing.snapshot())
    finally:
        tracing.disable()
    assert d['launches']['hess_passes'] == (
        want if traced else dict(cur=0, prop=0))


def _stubbed(monkeypatch):
    """The tracing calls of the H2MC path taken out."""
    monkeypatch.setattr(tracing, 'span',
                        lambda name: contextlib.nullcontext())
    monkeypatch.setattr(tracing, 'count_lanes', lambda *a: False)
    monkeypatch.setattr(tracing, 'enabled', lambda: False)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_tracing_off_runs_the_ops_of_a_step_without_it(h2mc_box,
                                                       monkeypatch):
    scene, opts, gen, b, ld, banked = h2mc_box
    assert not tracing.enabled()

    def ops():
        state, z, noise, use_iso, skip = _inputs(scene, opts, banked)
        with torch.no_grad(), _Ops() as mode:
            chain.small_step_h2mc(scene, opts, state, z, noise,
                                  use_iso=use_iso, skip_lanes=skip)
        return mode.ops
    off = ops()
    with monkeypatch.context() as m:
        _stubbed(m)
        bare = ops()
    assert off == bare and len(off) > 1000


@pytest.mark.cuda
def test_untraced_h2mc_capture_has_the_nodes_of_one_without_tracing(
        tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device('cuda', 0)
    scene, opts, gen, b, ld, banked = _setup(tmp_path, dev, C=1024)

    def nodes():
        g = graphs.StepGraphs(dev, gen)
        step = mlt.make_mlt_step(scene, opts, b,
                                 opts.large_step_probability,
                                 length_dist=ld)
        film = torch.zeros((scene.height, scene.width, 3), device=dev)
        cur = mlt.attach_cache(banked, opts)
        with torch.no_grad():
            g.run_eager(lambda: step(gen, cur, film, banked))
            g.capture(lambda: step(gen, cur, film, banked))
        return g
    assert not tracing.enabled()
    off = nodes()
    with monkeypatch.context() as m:
        _stubbed(m)
        bare = nodes()
    assert not off.traced and off.nodes == bare.nodes
    assert len(off.calls) == 2
    assert {fn.__name__ for fn, _, _ in off.calls} == {'_eigh'}
