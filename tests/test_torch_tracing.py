"""The port's trace registry (ops/tracing.py), on the CPU and, where there
is a card, on it (tests marked cuda; this file imports no JAX, so on the
card: python -m pytest --noconftest tests/test_torch_tracing.py -q).

* nesting: self times, inclusive times from the span tree, and their sum
  against the clock between the first and the last stamp;
* delta of two snapshots, and a stage that charged nothing reads None;
* reset_launches zeroes every launch counter and no other count;
* with tracing off a render launches no stamp and records no host span,
  and make_intersect_fns returns the backends' own functions;
* host spans share torch.profiler's clock;
* the live-ray counter against a plain count over a generated scene's
  query;
* a traced multi-step gives the untraced one's chain state and film bit
  for bit;
* on the card: a captured stamp replayed N times counts N, and a step
  captured with tracing off has the nodes of one without spans.
"""

import time

import pytest
import torch

from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.integrators import mlt
from langevin_mcmc_tpu_torch.ops import graphs, intersect, tracing
from langevin_mcmc_tpu_torch.scene.parse import parse_scene
from langevin_mcmc_tpu_torch.utils.tree import tree_leaves


@pytest.fixture
def traced_cpu():
    """Tracing on for the CPU for one test, off after it."""
    tracing.enable('cpu')
    try:
        yield
    finally:
        tracing.disable()


@pytest.fixture(scope='module')
def small_box(tmp_path_factory):
    def make(**kw):
        xml = testscenes.write_scene(
            str(tmp_path_factory.mktemp('box')), small=True, width=16,
            height=12, max_depth=3, num_init_samples=256, num_chains=64,
            **kw)
        return parse_scene(xml, device='cpu')
    return make


def _busy(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


def test_nesting_self_and_inclusive_times_add_up(traced_cpu):
    a = tracing.snapshot()
    with tracing.span('outer'):
        _busy(0.002)
        with tracing.span('inner'):
            _busy(0.003)
            with tracing.span('leaf'):
                _busy(0.001)
        _busy(0.001)
        with tracing.span('inner'):
            _busy(0.002)
    d = tracing.delta(a, tracing.snapshot())
    st = tracing.stage_times(d)
    assert set(d['stages']) >= {'outer', 'outer/inner', 'outer/inner/leaf'}
    # intervals charged: up to leaf's entry, and up to each exit
    assert st['inner']['count'] == 3 and st['leaf']['count'] == 1
    assert st['leaf']['incl_ns'] == st['leaf']['self_ns'] >= 1e6
    assert st['inner']['incl_ns'] == (st['inner']['self_ns']
                                      + st['leaf']['incl_ns'])
    assert st['outer']['incl_ns'] == (st['outer']['self_ns']
                                      + st['inner']['incl_ns'])
    assert st['inner']['self_ns'] >= 5e6 and st['outer']['self_ns'] >= 3e6
    # every interval between the first and the last stamp is charged once
    assert sum(ns for ns, _ in d['stages'].values()) == d['device_ns']
    # (the interval before the first span is charged to 'other')
    other = st.get('other', dict(self_ns=0))['self_ns']
    assert st['outer']['incl_ns'] + other == d['device_ns']
    # the host spans nest as the stages do
    spans = tracing.host_spans(a)
    byid = {s['id']: s for s in spans}
    leaf = [s for s in spans if s['name'] == 'leaf'][0]
    assert byid[byid[leaf['parent']]['parent']]['name'] == 'outer'
    for s in spans:
        assert s['start_ns'] <= s['end_ns']


def test_delta_of_two_snapshots(traced_cpu):
    with tracing.span('first'):
        pass
    a = tracing.snapshot()
    tracing.ray_counts['any'] += 7
    with tracing.span('second'):
        _busy(0.001)
    b = tracing.snapshot()
    d = tracing.delta(a, b)
    assert d['launches']['rays'] == dict(closest=0, any=7)
    assert d['host_spans'] == 1 and b['host_spans'] == a['host_spans'] + 1
    assert 'second' in d['stages'] and 'first' not in d['stages']
    assert tracing.stage_ms(d, 'first') is None
    assert tracing.stage_ms(d, 'second') >= 1.0
    assert d['device_ns'] == b['clock_ns'] - a['clock_ns'] > 0
    assert tracing.delta(b, b)['stages'] == {}


def test_reset_launches_zeroes_every_owner_and_nothing_else(traced_cpu):
    from langevin_mcmc_tpu_torch.mcmc import cache, chain
    from langevin_mcmc_tpu_torch.ops import bvh, chunkwalk, sweep_isect
    name = chain.LANE_COUNTERS[0]
    for m in (intersect, chunkwalk, sweep_isect, bvh, cache):
        for k in m.launch_counts:
            m.launch_counts[k] += 3
    tracing.ray_counts['closest'] += 5
    with tracing.span('kept'):
        tracing.count_lanes(name, 'prop', torch.ones(4, dtype=torch.bool))
    a = tracing.snapshot()
    assert a['launches']['rays']['closest'] >= 5
    tracing.reset_launches()
    b = tracing.snapshot()
    assert set(b['launches']) == set(a['launches'])
    for owner, counts in b['launches'].items():
        assert set(counts) == set(a['launches'][owner])
        assert not any(counts.values()), owner
    assert b['lanes'] == a['lanes'] and b['lanes'][name]['prop'] >= 4
    assert b['stages'] == a['stages'] and 'kept' in b['stages']
    assert b['live'] == a['live']


def _render(scene, opts, seed, n_inner=2, calls=2):
    """Bootstrap and `calls` multi-step calls on the CPU: (banked, film)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        b, ld, init = mlt.bootstrap(scene, opts, gen, chunk=128)
        banked = mlt.attach_cache(init, opts)
        multi = mlt.make_mlt_multi_step(scene, opts, b, 0.3, n_inner,
                                        length_dist=ld)
        film = torch.zeros((scene.height, scene.width, 3))
        for _ in range(calls):
            banked, film, _ = multi(gen, banked, film, init)
    return banked, film


def test_tracing_off_launches_no_stamp_and_records_nothing(small_box,
                                                           monkeypatch):
    calls = []
    monkeypatch.setattr(tracing._State, 'stamp',
                        lambda self, i: calls.append(('stamp', i)))
    close = tracing.host_close
    monkeypatch.setattr(tracing, 'host_close',
                        lambda sp: calls.append(('host', sp)) or close(sp))
    scene, opts, _ = small_box(kernel='mala')
    assert not tracing.enabled()
    fns = intersect.make_intersect_fns(scene)
    assert all(f.func.__module__.endswith('chunkwalk') for f in fns)
    before = tracing.snapshot()
    _render(scene, opts, 5)
    after = tracing.snapshot()
    assert calls == []
    assert after['launches']['rays'] == before['launches']['rays']
    assert after.get('host_spans') == before.get('host_spans')
    # and on: the same render stamps and records
    tracing.enable('cpu')
    try:
        _render(scene, opts, 5)
    finally:
        tracing.disable()
    assert any(c[0] == 'stamp' for c in calls)
    assert any(c[0] == 'host' for c in calls)


def test_host_spans_share_the_profiler_clock(traced_cpu):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.host_span('around'):
            torch.ones(64)
    sp = [s for s in tracing.host_spans() if s['name'] == 'around'][-1]
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == 'aten::ones']
    assert ops
    for e in ops:
        s = e.start_ns()
        assert sp['start_ns'] <= s <= s + e.duration_ns() <= sp['end_ns']


def test_live_ray_counter_counts_live_rays(small_box, traced_cpu):
    scene, _, _ = small_box(kernel='iso')
    g = torch.Generator().manual_seed(11)
    n = 3000
    org = torch.rand(n, 3, generator=g) * 0.5 - 0.25
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    time_ = torch.rand(n, generator=g)
    mn = torch.full((n,), 1e-3)
    mx = torch.where(torch.rand(n, generator=g) < 0.3,
                     torch.full((n,), -1.0), torch.full((n,), 1e30))
    a = tracing.snapshot()
    fi, fo = intersect.make_intersect_fns(scene)
    hit = fi(org, d, time_, mn, mx)[0]
    occ = fo(org, d, time_, mn, mx)
    b = tracing.snapshot()
    d_ = tracing.delta(a, b)
    live = int((mx >= mn).sum())
    assert 0 < live < n
    assert d_['live'] == dict(closest=live, any=live)
    assert d_['launches']['rays'] == dict(closest=n, any=n)
    assert torch.equal(hit, occ) and hit.any()
    st = tracing.stage_times(d_)
    assert st['isect.closest']['count'] == st['isect.any']['count'] == 1


def test_traced_multi_step_is_bit_for_bit_the_untraced(small_box):
    scene, opts, _ = small_box(kernel='mala')
    off = _render(scene, opts, 9)
    tracing.enable('cpu')
    try:
        a = tracing.snapshot()
        on = _render(scene, opts, 9)
        d = tracing.delta(a, tracing.snapshot())
    finally:
        tracing.disable()
    for x, y in zip(tree_leaves(off), tree_leaves(on)):
        if x.is_floating_point():
            x, y = x.view(torch.int32 if x.dtype == torch.float32
                          else torch.int64), \
                y.view(torch.int32 if y.dtype == torch.float32
                       else torch.int64)
        assert torch.equal(x, y)
    st = tracing.stage_times(d)
    for name in ('mlt.bootstrap', 'mlt.bootstrap.pass', 'mlt.large',
                 'mlt.small', 'chain.replay', 'chain.grad', 'mlt.splat',
                 'mlt.commit', 'isect.closest', 'isect.any'):
        assert st[name]['count'] > 0, name
    assert d['calls'] == 2
    calls = [s for s in tracing.host_spans(a) if s['name'] == 'mlt.call']
    assert [s['arg'] for s in calls] == [a['calls'] + 1, a['calls'] + 2]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the stamp kernel has no CPU mode')
    return torch.device('cuda', torch.cuda.current_device())


@pytest.mark.cuda
def test_captured_stamp_counts_every_replay():
    dev = _card()
    x = torch.zeros(1024, device=dev)
    tracing.enable(dev)
    try:
        # a device without an index is the current one
        g = graphs.StepGraphs('cuda')

        def body():
            with tracing.span('card.body'):
                x.add_(1.0)
        g.run_eager(body)
        g.capture(body)
        a = tracing.snapshot()
        n = 25
        for _ in range(n):
            g.replay()
        d = tracing.delta(a, tracing.snapshot())
    finally:
        tracing.disable()
    assert g.traced
    assert d['stages']['card.body'][1] == n
    assert d['stages'][tracing.GAP][1] == n
    assert sum(ns for ns, _ in d['stages'].values()) == d['device_ns'] > 0
    assert float(x[0]) == n + 2


@pytest.mark.cuda
def test_untraced_capture_has_the_nodes_of_one_without_spans():
    dev = _card()
    x = torch.zeros(1024, device=dev)

    def plain():
        x.mul_(0.5).add_(1.0)

    def spanned():
        with tracing.span('card.a'):
            x.mul_(0.5)
            with tracing.span('card.b'):
                x.add_(1.0)

    def nodes(body):
        g = graphs.StepGraphs(dev)
        g.run_eager(body)
        g.capture(body)
        return g
    assert not tracing.enabled()
    ref, off = nodes(plain), nodes(spanned)
    tracing.enable(dev)
    try:
        on = nodes(spanned)
    finally:
        tracing.disable()
    assert off.nodes == ref.nodes and not off.traced
    # four span stamps, and one at each end of the graph
    assert on.traced and sum(on.nodes) == sum(ref.nodes) + 6
