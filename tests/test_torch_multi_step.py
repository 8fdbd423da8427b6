"""The port's multi-step (integrators/mlt.make_mlt_multi_step) and the
render loops' n_inner schedule, against the JAX package.

* render_mlt and render_mlt_multihost with the bootstrap, the direct pass
  and the (multi-)step replaced by recording stubs in both packages (for
  JAX, jax.jit patched to the identity inside the test): the same calls
  of the same large-step probability and length, the same snapshot
  iterations and the same effective spp, exactly, over settings of
  num_steps, n_inner, reportintervalspp, ls_ratio and largestepscale; the
  multihost loop raises when a call's n_done falls short (a stub, and a
  real CPU render whose chain state holds a NaN);
* the sync-free branches of the chain step against the JAX functions on
  the same inputs: large_step_cache with every lane uniform and every
  lane from the cache (the mixed case is test_torch_large_steps'),
  small_step_mala with no gradient lane (every row full; no cache lane is
  test_torch_mcmc's) at the tolerances of those files, and
  intersect_bruteforce with dead rays mixed in (hits and ids exactly,
  t, u, v at rtol 1e-5);
* ops/graphs: cond_call outside a capture is lax.cond (the branch bit for
  bit, or zeros), and every kernel wrapper's launch counts are in the
  registry that StepGraphs keeps counting under replay;
* on the CPU the multi-step equals n_inner calls of make_mlt_step bit for
  bit (chain state, film, counts) with n_done == n_inner, and a MALA step
  reads nothing back to the host from mcmc/chain.py or
  integrators/mlt.py (Tensor.__bool__, .item() and torch.nonzero raise
  there).
"""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from langevin_mcmc_tpu import Options as JOptions
from langevin_mcmc_tpu.integrators import mlt as jmlt
from langevin_mcmc_tpu.mcmc import chain as jchain
from langevin_mcmc_tpu.ops import intersect as jisect
from langevin_mcmc_tpu.parallel import mesh as jmesh
from langevin_mcmc_tpu.parallel import multihost as jmultihost
from langevin_mcmc_tpu.parallel import shardmap_step as jshardmap
from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.utils import image_io as jimage_io
from langevin_mcmc_tpu.utils.distribution import Distribution1D as JDist
from langevin_mcmc_tpu_torch import Options, testscenes
from langevin_mcmc_tpu_torch.integrators import mlt
from langevin_mcmc_tpu_torch.mcmc import chain
from langevin_mcmc_tpu_torch.ops import intersect
from langevin_mcmc_tpu_torch.parallel import multihost
from langevin_mcmc_tpu_torch.path import trace
from langevin_mcmc_tpu_torch.scene.parse import parse_scene
from langevin_mcmc_tpu_torch.utils.distribution import Distribution1D
from langevin_mcmc_tpu_torch.utils.tree import tree_leaves
from torch_parity import LCBOX, port_scene, to_np, assert_close_most
from test_torch_large_steps import chains, filled  # noqa: F401
from test_torch_large_steps import _tape, LENGTH_W, Dm as LS_DM
from test_torch_mcmc import chains as mala_chains  # noqa: F401
from test_torch_mcmc import _fill_both, D as MALA_D

torch.set_num_threads(1)
W, H, C = 16, 12, 64          # 192 pixels: 3 iterations a spp


# ---------------------------------------------------------------------------
# the render loops' schedule
# ---------------------------------------------------------------------------

class _Log:
    """What a stubbed render loop did: each call's (first iteration,
    ls_prob, iterations) and the iteration of each snapshot."""

    def __init__(self):
        self.calls, self.snaps, self.done = [], [], 0

    def call(self, ls_prob, n):
        self.calls.append((self.done, float(ls_prob), n))
        self.done += n

    def snap(self, path, img):
        if path.endswith('.exr'):
            self.snaps.append(self.done)


def _options(cls, ls_ratio, scale, ris, h2mc):
    return cls(num_chains=C, spp=2, direct_spp=0, mala=not h2mc, h2mc=h2mc,
               large_step_probability=0.3, large_step_prob_scale=scale,
               ls_ratio=ls_ratio, report_interval_spp=ris)


def _jax_render(monkeypatch, num_steps, n_inner, ris, ls_ratio, scale,
                h2mc):
    log = _Log()
    banked = types.SimpleNamespace(cache=None)

    def make(scene, opts, b, ls_prob, n, length_dist=None, **kw):
        def multi(key, banked, film, init):
            log.call(ls_prob, n)
            return banked, film + n, jnp.int32(n)
        return multi
    monkeypatch.setattr(jax, 'jit', lambda f, **kw: f)
    monkeypatch.setattr(jmlt, 'bootstrap',
                        lambda *a, **k: (1.0, None, banked))
    monkeypatch.setattr(jmlt, 'attach_cache', lambda b, o: b)
    monkeypatch.setattr(jmlt, 'make_mlt_multi_step', make)
    monkeypatch.setattr(jimage_io, 'write_image', log.snap)
    opts = _options(JOptions, ls_ratio, scale, ris, h2mc)
    scene = types.SimpleNamespace(width=W, height=H)
    out, _ = jmlt.render_mlt(scene, opts, jax.random.PRNGKey(0),
                             num_steps=num_steps, n_inner=n_inner,
                             intermediate_path='snap' if ris else None)
    return log, float(np.asarray(out).reshape(-1)[0])


def _port_render(monkeypatch, num_steps, n_inner, ris, ls_ratio, scale,
                 h2mc):
    log = _Log()
    banked = types.SimpleNamespace(cache=None)

    def make(scene, opts, b, ls_prob, n, length_dist=None, **kw):
        def multi(gen, banked, film, init):
            log.call(ls_prob, n)
            return banked, film + n, torch.tensor(n, dtype=torch.int32)
        multi.step = types.SimpleNamespace(counts={})
        multi.graphs = None
        return multi
    monkeypatch.setattr(mlt, 'bootstrap', lambda *a, **k: (1.0, None, banked))
    monkeypatch.setattr(mlt, 'attach_cache', lambda b, o: b)
    monkeypatch.setattr(mlt, 'make_mlt_multi_step', make)
    monkeypatch.setattr(mlt.image_io, 'write_image', log.snap)
    opts = _options(Options, ls_ratio, scale, ris, h2mc)
    scene = types.SimpleNamespace(width=W, height=H,
                                  device=torch.device('cpu'))
    tm = {}
    out, _ = mlt.render_mlt(scene, opts, torch.Generator(),
                            num_steps=num_steps, n_inner=n_inner, timings=tm,
                            intermediate_path='snap' if ris else None)
    assert tm['steps'] == tm['n_done'] == log.done
    return log, float(out.reshape(-1)[0])


# (num_steps, n_inner, reportintervalspp, ls_ratio, largestepscale, h2mc)
SCHEDULES = [
    (24, 16, 0, 0.5, 2.0, False),   # 24 -> 32: two calls, switch after both
    (72, 16, 0, 0.3, 0.5, False),   # 72 -> 80, switch after call 1
    (100, 16, 0, 0.1, 3.0, False),  # 100 -> 112
    (5, 16, 0, 0.5, 2.0, False),    # n_inner cut to num_steps
    (10, 16, 1, 0.3, 2.0, False),   # snapshots every 3: n_inner 3, 10 -> 12
    (20, 16, 2, 0.6, 0.25, False),  # snapshots every 6: 20 -> 24
    (40, 8, 4, 0.9, 2.0, False),    # report every 12, n_inner 8
    (30, 16, 0, 0.5, 2.0, True),    # H2MC: no second probability
    (None, 4, 0, 0.4, 2.0, False),  # spp 2: 6 iterations in calls of 4
]


@pytest.mark.parametrize('sched', SCHEDULES)
def test_render_mlt_schedule_matches_jax(monkeypatch, sched):
    jlog, jval = _jax_render(monkeypatch, *sched)
    tlog, tval = _port_render(monkeypatch, *sched)
    assert tlog.calls == jlog.calls
    assert tlog.snaps == jlog.snaps
    # the film (iterations run) over the effective spp
    assert tval == pytest.approx(jval, rel=1e-6)


def _jax_multihost(monkeypatch, num_steps, ls_ratio, scale, short_at=None):
    log = _Log()
    banked = types.SimpleNamespace(
        state=types.SimpleNamespace(ls_score=np.zeros(C)), cache=None)

    def make(mesh, scene, opts, b, ls_prob, n, length_dist=None, **kw):
        def step(key, banked, film, init):
            nd = n - 1 if len(log.calls) == short_at else n
            log.call(ls_prob, nd)
            # one film partial a device; they sum to nd
            return banked, film + nd / film.shape[0], jnp.int32(nd)
        return step
    monkeypatch.setattr(jax, 'jit', lambda f, **kw: f)
    monkeypatch.setattr(jmultihost, 'bootstrap_multihost',
                        lambda *a, **k: (1.0, None, banked))
    monkeypatch.setattr(jmesh, 'shard_chains', lambda mesh, t: t)
    monkeypatch.setattr(jmlt, 'attach_cache', lambda b, o: b)
    monkeypatch.setattr(jshardmap, 'make_sharded_multi_step', make)
    opts = _options(JOptions, ls_ratio, scale, 0, False)
    scene = types.SimpleNamespace(width=W, height=H)
    out = jmultihost.render_mlt_multihost(scene, opts, jax.random.PRNGKey(0),
                                          num_steps=num_steps)[0]
    return log, float(np.asarray(out).reshape(-1)[0])


def _port_multihost(monkeypatch, num_steps, ls_ratio, scale, short_at=None):
    log = _Log()
    banked = types.SimpleNamespace(
        state=types.SimpleNamespace(ls_score=torch.zeros(C)), cache=None)

    def make(mesh, scene, opts, b, ls_prob, n, length_dist=None, **kw):
        def step(gens, banks, films, init):
            nd = n - 1 if len(log.calls) == short_at else n
            log.call(ls_prob, nd)
            return banks, [f + nd / f.shape[0] for f in films], nd
        step.counts = lambda: {}
        multi = types.SimpleNamespace(graphs=None)
        step.multis = [multi]
        return step
    monkeypatch.setattr(multihost, 'bootstrap_multihost',
                        lambda *a, **k: (1.0, None, banked))
    monkeypatch.setattr(multihost.mlt, 'attach_cache', lambda b, o: b)
    monkeypatch.setattr(multihost, 'make_sharded_multi_step', make)
    opts = _options(Options, ls_ratio, scale, 0, False)
    scene = types.SimpleNamespace(width=W, height=H,
                                  device=torch.device('cpu'))
    tm = {}
    out = multihost.render_mlt_multihost(scene, opts, 0, num_steps=num_steps,
                                         timings=tm)[0]
    assert tm['steps'] == log.done
    return log, float(out.reshape(-1)[0])


@pytest.mark.parametrize('num_steps,ls_ratio,scale', [
    (72, 0.3, 2.0), (24, 0.5, 0.5), (5, 0.1, 2.0), (160, 0.45, 3.0)])
def test_render_mlt_multihost_schedule_matches_jax(monkeypatch, num_steps,
                                                   ls_ratio, scale):
    jlog, jval = _jax_multihost(monkeypatch, num_steps, ls_ratio, scale)
    tlog, tval = _port_multihost(monkeypatch, num_steps, ls_ratio, scale)
    assert tlog.calls == jlog.calls
    # whole calls: 72 iterations are run as 80
    assert tlog.done == -(-num_steps // min(16, num_steps)) * min(16,
                                                                   num_steps)
    assert tval == pytest.approx(jval, rel=1e-6)


def test_render_mlt_multihost_raises_on_short_call(monkeypatch):
    with pytest.raises(RuntimeError, match='non-finite'):
        _jax_multihost(monkeypatch, 64, 0.3, 2.0, short_at=2)
    with pytest.raises(RuntimeError, match='non-finite'):
        _port_multihost(monkeypatch, 64, 0.3, 2.0, short_at=2)


@pytest.fixture(scope='module')
def small_box(tmp_path_factory):
    def make(num_chains=C, **kw):
        xml = testscenes.write_scene(
            str(tmp_path_factory.mktemp('box')), small=True, width=W,
            height=H, max_depth=3, num_init_samples=512,
            num_chains=num_chains, **kw)
        return parse_scene(xml, device='cpu')
    return make


def test_render_mlt_multihost_raises_on_nan_state(small_box, monkeypatch):
    """A NaN planted in the seed state's ss_score (on valid lanes, with no
    large steps, so no accept can replace it) keeps n_done at 0."""
    scene, opts, _ = small_box(kernel='iso')
    opts = opts.replace(large_step_probability=0.0)
    boot = multihost.bootstrap_multihost

    def planted(*a, **k):
        b, ld, banked = boot(*a, **k)
        st = banked.state
        ss = st.ss_score.clone()
        ss[0] = float('nan')
        st = dataclasses.replace(st, ss_score=ss,
                                 valid=torch.ones_like(st.valid))
        return b, ld, dataclasses.replace(banked, state=st)
    monkeypatch.setattr(multihost, 'bootstrap_multihost', planted)
    with torch.no_grad(), pytest.raises(RuntimeError, match='0/4'):
        multihost.render_mlt_multihost(scene, opts, 1, num_steps=4,
                                       chunk=256)


# ---------------------------------------------------------------------------
# the sync-free branches against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('branch', ['uniform', 'cache'])
def test_large_step_cache_one_branch_matches_jax(chains, filled, branch):
    """Every lane on one branch: cache_prob 0 (uniform), or cache_prob 1
    with lengths drawn only where the row is full (cache)."""
    js, jo, ts, jst, tst, _, _ = chains
    cj, ct = filled
    n = tst.ls_score.shape[0]
    D = jo.max_depth
    if branch == 'uniform':
        jo = jo.replace(cache_prob=0.0)
        lw = LENGTH_W
    else:
        jo = jo.replace(cache_prob=1.0)
        count = np.asarray(cj.count)
        dim = 2 * np.arange(len(LENGTH_W))
        full = (dim < len(count)) & (dim >= jo.pss_min_length) \
            & (count[np.minimum(dim, len(count) - 1)] >= jo.pss_max_size)
        lw = np.where(full, LENGTH_W, 0.0)
        assert lw.sum() > 0
    jdist, tdist = JDist(lw), Distribution1D(lw, 'cpu')
    key = jax.random.PRNGKey(11)
    jprop, ja = jchain.large_step_cache(js, jo, key, jst, jdist, cj)
    k_len, k_split, k_tape, k_pick, k_samp, k_off, k_noise = \
        jax.random.split(key, 7)
    k1, k2, k3 = jax.random.split(k_noise, 3)
    sd = jo.discrete_std_dev
    noise = dict(time=jax.random.normal(k1, (n,)) * sd,
                 cam_disc=jax.random.normal(k2, (n, D)) * sd,
                 lgt_disc=jax.random.normal(k3, (n, D)) * sd)
    t = lambda x: torch.as_tensor(np.array(x))
    with torch.no_grad():
        tprop, ta = chain.large_step_cache(
            ts, jo, tst, tdist, ct, trace.Tape(t(_tape(k_tape, n)), D),
            t(jax.random.uniform(k_len, (n,))),
            t(jax.random.uniform(k_split, (n,))),
            t(jax.random.uniform(k_pick, (n,))),
            t(jax.random.uniform(k_samp, (n, 1)))[:, 0],
            t(jax.random.normal(k_off, (n, LS_DM))) * jo.cache_sig,
            {k: t(v) for k, v in noise.items()})
    use = to_np(tprop['use_cache'])
    assert use.all() if branch == 'cache' else not use.any()
    ja = np.asarray(ja)
    assert (ja > 0).sum() >= 3
    assert_close_most(to_np(ta), ja, 2e-3, err_msg='a')
    for k in ('ls', 'ss', 'contrib', 'screen'):
        assert_close_most(to_np(tprop[k]), np.asarray(jprop[k]), 2e-3,
                          err_msg=k)
    for k in ('cam_depth', 'lgt_depth'):
        np.testing.assert_array_equal(to_np(getattr(tprop['rec'], k)),
                                      np.asarray(getattr(jprop['rec'], k)))


def test_mala_with_no_gradient_lane_matches_jax(mala_chains):
    """Every cache row full: each lane in range is in the cache phase, so
    the current-side gradient and the proposal-side gradient consume
    nothing and the cache queries run on both sides."""
    js, jo, ts, jst, tst = mala_chains
    n = tst.ls_score.shape[0]
    jo = jo.replace(pss_max_size=16)
    cj, ct = _fill_both(jo, 2 * MALA_D, 12, np.random.default_rng(3))
    assert (np.asarray(cj.count)[2:2 * MALA_D + 1] >= 16).all()
    key = jax.random.PRNGKey(9)
    with jax.disable_jit():     # op by op: no compile of the whole step
        jprop, ja = jchain.small_step_mala(js, jo, key, jst, cache=cj)
    k_off, k_noise = jax.random.split(key)
    z = np.array(jax.random.normal(k_off, (n, 2 * MALA_D)))
    k1, k2, k3 = jax.random.split(k_noise, 3)
    sd = jo.discrete_std_dev
    noise = dict(time=jax.random.normal(k1, (n,)) * sd,
                 cam_disc=jax.random.normal(k2, (n, MALA_D)) * sd,
                 lgt_disc=jax.random.normal(k3, (n, MALA_D)) * sd)
    with torch.no_grad():
        tprop, ta = chain.small_step_mala(
            ts, jo, tst, torch.as_tensor(z),
            {k: torch.as_tensor(np.array(v)) for k, v in noise.items()},
            cache=ct)
    assert not to_np(tprop['grad_lane']).any()
    assert to_np(tprop['cache_lane']).sum() >= n // 2
    ja = np.asarray(ja)
    assert (ja > 0).sum() >= 3
    np.testing.assert_array_equal(to_np(tprop['cur_ok']),
                                  np.asarray(jprop['cur_ok']))
    assert_close_most(to_np(tprop['ss']), np.asarray(jprop['ss']), 2e-3,
                      frac=0.05, err_msg='proposal ss')
    assert_close_most(to_np(ta), ja, 2e-2, frac=0.05, err_msg='MH ratio')
    for k in ('queried', 'v1_now', 'v2_now'):
        assert_close_most(to_np(tprop[k]).astype(np.float32),
                          np.asarray(jprop[k]).astype(np.float32), 2e-2,
                          frac=0.05, atol=1e-6, err_msg=k)


def test_bruteforce_with_dead_rays_matches_jax():
    """Rays of lcbox, a third of them dead (max_t < min_t), across more
    than one block of the port's brute force: every result equal to the
    JAX function's, and no dead ray hits."""
    js, _, _ = jax_parse(LCBOX)
    ts = port_scene(js)
    rng = np.random.default_rng(5)
    R = 3000
    p = to_np(ts.tri_p[0]).reshape(-1, 3)
    lo, hi = p.min(0), p.max(0)
    org = (lo + (hi - lo) * rng.uniform(0.3, 0.7, (R, 3))).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    time = rng.random(R).astype(np.float32)
    mn = np.full(R, 1e-4, np.float32)
    mx = np.where(rng.random(R) < 1 / 3, -1.0, np.inf).astype(np.float32)
    want = jisect.intersect_bruteforce(js, *(jnp.asarray(x) for x in
                                             (org, d, time, mn, mx)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(intersect, 'PAIR_BLOCK', 1024 * intersect.TRI_CHUNK)
        got = intersect.intersect_bruteforce(ts, *(torch.as_tensor(x) for x
                                                   in (org, d, time, mn,
                                                       mx)))
    # hits and ids exactly; t, u, v to f32 rounding (the two compilers
    # order the products differently)
    for g, w, name in zip(got, want, ('hit', 'id', 't', 'u', 'v')):
        if name in ('hit', 'id'):
            np.testing.assert_array_equal(to_np(g), np.asarray(w),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    dead = mx < mn
    assert not to_np(got[0])[dead].any() and to_np(got[0])[~dead].sum() > 100


@pytest.mark.parametrize('flag', [True, False])
def test_cond_call_outside_capture_is_lax_cond(flag):
    """Outside a capture cond_call runs the branch and selects on the
    device: the branch's results bit for bit (NaN and -0.0 included) when
    the flag is true, zeros when it is false, as lax.cond gives; a tuple
    stays a tuple."""
    from langevin_mcmc_tpu_torch.ops.graphs import cond_call
    x = torch.tensor([1.5, float('nan'), -0.0, 3.0])
    calls = []

    def branch(a, b):
        calls.append(1)
        return a * 2.0, (b + 1).to(torch.int32)
    got = cond_call(torch.tensor(flag), branch, x, torch.arange(4))
    assert isinstance(got, tuple) and len(calls) == 1
    if flag:
        assert torch.equal(got[0].view(torch.int32),
                           (x * 2.0).view(torch.int32))
        assert torch.equal(got[1], torch.arange(1, 5, dtype=torch.int32))
    else:
        assert torch.equal(got[0].view(torch.int32),
                           torch.zeros(4).view(torch.int32))
        assert got[1].dtype == torch.int32 and not got[1].any()
    single = cond_call(torch.tensor(flag), lambda a: a + 1.0, x)
    assert isinstance(single, torch.Tensor)
    assert torch.equal(single.view(torch.int32),
                       (x + 1.0 if flag else torch.zeros(4))
                       .view(torch.int32))


def test_kernel_launch_counters_are_registered():
    """Every kernel wrapper's launch counts live in the one registry
    (ops/tracing) that StepGraphs keeps counting under replay."""
    from langevin_mcmc_tpu_torch.ops import bvh, chunkwalk, tracing
    from langevin_mcmc_tpu_torch.ops import sweep_isect
    registered = [id(c) for c in tracing._counters]
    for m in (chunkwalk, sweep_isect, bvh):
        assert id(m.launch_counts) in registered
        tracing.reset_launches()
        assert id(m.launch_counts) in registered
    assert sorted(chunkwalk.launch_counts) == [
        'any_hit_resident', 'closest_hit_resident', 'split_any_hit',
        'split_closest_hit']


# ---------------------------------------------------------------------------
# the multi-step on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def booted(small_box):
    scene, opts, _ = small_box(num_chains=256, large_step='cache',
                               light_coords=True)
    with torch.no_grad():
        b, ld, banked = mlt.bootstrap(scene, opts,
                                      torch.Generator().manual_seed(3),
                                      chunk=256)
    return scene, opts, b, ld, banked


def test_multi_step_equals_eager_steps(booted):
    scene, opts, b, ld, init = booted
    n_inner = 3
    banked = mlt.attach_cache(init, opts)
    shape = (scene.height, scene.width, 3)
    with torch.no_grad():
        step = mlt.make_mlt_step(scene, opts, b, 0.3, length_dist=ld)
        gen, film = torch.Generator().manual_seed(9), torch.zeros(shape)
        want = banked
        for _ in range(n_inner):
            want = step(gen, want, film, init)
        multi = mlt.make_mlt_multi_step(scene, opts, b, 0.3, n_inner,
                                        length_dist=ld)
        got, got_film, n_done = multi(torch.Generator().manual_seed(9),
                                      banked, torch.zeros(shape), init)
    assert n_done.dtype == torch.int32 and int(n_done) == n_inner
    assert torch.equal(got_film, film) and film.sum() > 0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)
    assert {k: int(v) for k, v in multi.step.counts.items()} == \
        {k: int(v) for k, v in step.counts.items()}
    assert int(step.counts['large']) > 0


def test_step_counts_are_summed_in_place(booted):
    """step.counts holds one tensor a key for the step's life (a captured
    step adds into it at every replay)."""
    scene, opts, b, ld, init = booted
    banked = mlt.attach_cache(init, opts)
    film = torch.zeros((scene.height, scene.width, 3))
    with torch.no_grad():
        step = mlt.make_mlt_step(scene, opts, b, 0.3, length_dist=ld)
        held = dict(step.counts)
        gen = torch.Generator().manual_seed(2)
        banked = step(gen, banked, film, init)
        first = {k: int(v) for k, v in held.items()}
        step(gen, banked, film, init)
    assert sorted(held) == ['accepts', 'cache', 'cache_accepts', 'large',
                            'mmlt']
    assert all(step.counts[k] is held[k] for k in held)
    assert int(held['large']) > first['large'] > 0


def test_mala_step_reads_nothing_back(booted, monkeypatch):
    scene, opts, b, ld, init = booted
    banked = mlt.attach_cache(init, opts)
    film = torch.zeros((scene.height, scene.width, 3))
    step = mlt.make_mlt_step(scene, opts, b, 0.3, length_dist=ld)
    guarded = tuple(os.path.join('langevin_mcmc_tpu_torch', *p) for p in
                    (('mcmc', 'chain.py'), ('integrators', 'mlt.py')))

    def guard(name, fn):
        def wrapped(*a, **k):
            caller = sys._getframe(1).f_code.co_filename
            if caller.endswith(guarded):
                raise AssertionError(f'{name} called from {caller}')
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(torch.Tensor, '__bool__',
                        guard('Tensor.__bool__', torch.Tensor.__bool__))
    monkeypatch.setattr(torch.Tensor, 'item',
                        guard('Tensor.item', torch.Tensor.item))
    monkeypatch.setattr(torch, 'nonzero', guard('torch.nonzero',
                                                  torch.nonzero))
    with torch.no_grad():
        step(torch.Generator().manual_seed(4), banked, film, init)
    # the guard is live: the same call from chain.py's namespace raises
    with pytest.raises(AssertionError, match='chain.py'):
        exec(compile('bool(torch.ones(1))', chain.__file__, 'exec'),
             {'torch': torch})
