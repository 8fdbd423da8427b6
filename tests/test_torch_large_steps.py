"""Multiplexed and cache-seeded large steps: the port against the JAX
package on the same inputs (every draw rebuilt from the JAX key).

* _sample_st_split: the (s, t) split exactly, in both MIS modes;
* large_step_multiplexed: the acceptance a, ls, ss, contrib and screen at
  rtol 2e-3 per lane with at most 1% of lanes beyond 10x rtol (as in
  test_torch_mcmc's test_large_step_matches_jax: the generators round f32
  differently, so a lane on a discrete threshold diverges);
* eval_pdf_cache on planted entries (queries on, near and far from stored
  entries, (s, t) tags mixed in a row): rtol 1e-4;
* sample_cache: the drawn indices exactly for the same uniforms (weights
  are small integers, so both CDFs are exact);
* large_step_cache on a pre-filled cache (rows filled from the chains'
  own paths, records included): which lanes take the cache branch
  exactly, a and the proposal at rtol 2e-3 with at most 1% of lanes
  beyond 10x rtol, as for the multiplexed step.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.mcmc import cache as jcache
from langevin_mcmc_tpu.mcmc import chain as jchain
from langevin_mcmc_tpu.path.records import PathRecord as JPathRecord
from langevin_mcmc_tpu.path.records import get_path_pss as jget_pss
from langevin_mcmc_tpu.utils.distribution import Distribution1D as JDist
from langevin_mcmc_tpu_torch import Options
from langevin_mcmc_tpu_torch.interop import record_to_numpy
from langevin_mcmc_tpu_torch.mcmc import cache as cache_mod
from langevin_mcmc_tpu_torch.mcmc import chain
from langevin_mcmc_tpu_torch.path import trace
from langevin_mcmc_tpu_torch.path.records import to_subpath
from langevin_mcmc_tpu_torch.utils.distribution import Distribution1D
from torch_parity import LCBOX, port_scene, to_np, assert_close_most

torch.set_num_threads(1)
C = 128
D = 4
Dm = 2 * D
# path-length weights (lengths 2..4; bins 0..2D+1 as the bootstrap's)
LENGTH_W = np.array([0, 0, 3, 2, 1, 0, 0, 0, 0, 0], np.float64)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize('bidir', [True, False])
def test_sample_st_split_matches_jax(bidir):
    opts = Options(bidirectional=bidir)
    key = jax.random.PRNGKey(4)
    length = jnp.asarray(np.random.default_rng(1).integers(1, 9, 4000),
                         jnp.int32)
    js, jt = jchain._sample_st_split(opts, key, length)
    u = np.array(jax.random.uniform(key, length.shape))
    ts, tt = chain._sample_st_split(opts, _t(u), _t(length))
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    np.testing.assert_array_equal(to_np(tt), np.asarray(jt))
    assert (to_np(ts) >= 1).all()
    if not bidir:
        assert (to_np(tt) <= 1).all()


@pytest.fixture(scope='module')
def chains():
    """JAX and port chain states over the same seed paths on lcbox (one
    technique per lane, picked by contribution; two thirds valid), the
    same length distribution, cache sampling on."""
    js, jo, _ = jax_parse(LCBOX)
    jo = jo.replace(max_depth=D, num_chains=C, mala=True,
                    large_step_multiplexed=True,
                    sample_from_global_cache=True, pss_max_size=16,
                    cache_prob=0.7)
    ts = port_scene(js)
    u = np.random.default_rng(21).random((C, trace.Tape.size(D)),
                                         dtype=np.float32)
    with torch.no_grad():
        rec, con, _, _ = trace.generate_path_bidir(
            ts, jo, trace.Tape(torch.as_tensor(u), D), min_depth=3,
            max_depth=D)
    flat, s_tags, t_tags = con.flatten()
    ls = to_np(flat['ls_score'])
    pick = np.argmax(ls, 1)
    lanes = np.arange(C)
    take = lambda a: to_np(a)[lanes, pick]
    seeds = dict(contrib=take(flat['contrib']),
                 screen=take(flat['screen_pos']), ls=take(flat['ls_score']),
                 ss=take(flat['ss_score']), score_sum=ls.sum(1))
    trec = to_subpath(rec, _t(s_tags[pick]), _t(t_tags[pick]))
    jrec = JPathRecord(**{k: jnp.asarray(v)
                          for k, v in record_to_numpy(trec).items()})
    valid = np.arange(C) % 3 != 0
    args = ('contrib', 'screen', 'ls', 'ss', 'score_sum')
    jst = jchain.init_chain_state(jrec, *(jnp.asarray(seeds[k])
                                          for k in args), jo)
    jst = dataclasses.replace(jst, valid=jnp.asarray(valid))
    tst = chain.init_chain_state(trec, *(_t(seeds[k]) for k in args), jo)
    tst = dataclasses.replace(tst, valid=_t(valid))
    return (js, jo, ts, jst, tst, JDist(LENGTH_W),
            Distribution1D(LENGTH_W, 'cpu'))


def _tape(key, n):
    return np.array(jax.random.uniform(key, (n, trace.Tape.size(D))))


def test_large_step_multiplexed_matches_jax(chains):
    js, jo, ts, jst, tst, jdist, tdist = chains
    key = jax.random.PRNGKey(7)
    jprop, ja = jax.jit(lambda k, s: jchain.large_step_multiplexed(
        js, jo, k, s, jdist))(key, jst)
    k_len, k_split, k_tape = jax.random.split(key, 3)
    with torch.no_grad():
        tprop, ta = chain.large_step_multiplexed(
            ts, jo, tst, tdist, trace.Tape(_t(_tape(k_tape, C)), D),
            _t(jax.random.uniform(k_len, (C,))),
            _t(jax.random.uniform(k_split, (C,))))
    np.testing.assert_array_equal(to_np(tprop['length']),
                                  np.asarray(jprop['length']))
    assert (np.asarray(ja) > 0).sum() >= 5
    assert_close_most(to_np(ta), np.asarray(ja), 2e-3, err_msg='a')
    for k in ('ls', 'ss', 'contrib', 'screen'):
        assert_close_most(to_np(tprop[k]), np.asarray(jprop[k]), 2e-3,
                          err_msg=k)
    np.testing.assert_array_equal(to_np(tprop['rec'].cam_depth),
                                  np.asarray(jprop['rec'].cam_depth))
    np.testing.assert_array_equal(to_np(tprop['rec'].lgt_depth),
                                  np.asarray(jprop['rec'].lgt_depth))


# ---------------------------------------------------------------------------
# the cache's KDE pdf and sampling
# ---------------------------------------------------------------------------

def _planted(opts, rng, rounds=3, n=96):
    """The same pushes into a JAX and a port cache: rows of dims 2..8,
    (s, t) tags two per row, integer weights 1..8."""
    cj = jcache.make_cache(opts, Dm)
    ct = cache_mod.make_cache(opts, Dm, 'cpu')
    for _ in range(rounds):
        dims = (2 * rng.integers(1, 5, n)).astype(np.int32)
        pss = rng.random((n, Dm)).astype(np.float32)
        w = rng.integers(1, 9, n).astype(np.float32)
        s = (dims // 2 + rng.integers(0, 2, n)).astype(np.int32)
        t = (dims // 2 + 1 - s).astype(np.int32)
        v = np.zeros((n, Dm), np.float32)
        mask = np.ones(n, bool)
        cj = jcache.push_batch(cj, *(jnp.asarray(x) for x in
                                     (dims, pss, v, v, w, mask)), opts,
                               s_tag=jnp.asarray(s), t_tag=jnp.asarray(t))
        ct = cache_mod.push_batch(ct, *(_t(x) for x in
                                        (dims, pss, v, v, w, mask)), opts,
                                  s_tag=_t(s), t_tag=_t(t))
    return cj, ct


def test_eval_pdf_cache_matches_jax():
    opts = Options(pss_max_size=40, cache_sig=0.15)
    rng = np.random.default_rng(3)
    cj, ct = _planted(opts, rng)
    np.testing.assert_array_equal(to_np(ct.count), np.asarray(cj.count))
    n = 90
    dims = (2 * rng.integers(1, 5, n)).astype(np.int32)
    s = (dims // 2 + rng.integers(0, 2, n)).astype(np.int32)
    t = (dims // 2 + 1 - s).astype(np.int32)
    count = np.asarray(cj.count)
    store = np.asarray(cj.pss)
    q = rng.random((n, Dm)).astype(np.float32)
    # a third on a stored entry, a third near one (wrapping across 0/1),
    # a third anywhere
    for i in range(n):
        e = store[dims[i], rng.integers(0, count[dims[i]])]
        if i % 3 == 0:
            q[i] = e
        elif i % 3 == 1:
            q[i] = np.mod(e + rng.normal(size=Dm) * 0.1, 1.0)
    pj = np.asarray(jcache.eval_pdf_cache(cj, *(jnp.asarray(x) for x in
                                                (dims, q, s, t)), opts))
    pt = to_np(cache_mod.eval_pdf_cache(ct, *(_t(x) for x in
                                              (dims, q, s, t)), opts))
    assert (pj > 0).sum() > n // 2
    np.testing.assert_allclose(pt, pj, rtol=1e-4, atol=1e-30)


def test_sample_cache_matches_jax():
    opts = Options(pss_max_size=40)
    rng = np.random.default_rng(5)
    cj, ct = _planted(opts, rng)
    n = 500
    dims = (2 * rng.integers(1, 5, n)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    ij, pj, wj, _ = jcache.sample_cache(cj, key, jnp.asarray(dims), opts)
    u = np.array(jax.random.uniform(key, (n, 1)))[:, 0]
    it, pt, wt, _ = cache_mod.sample_cache(ct, _t(dims), _t(u))
    np.testing.assert_array_equal(to_np(it), np.asarray(ij))
    np.testing.assert_array_equal(to_np(pt), np.asarray(pj))
    np.testing.assert_array_equal(to_np(wt), np.asarray(wj))
    assert len(np.unique(np.asarray(ij))) > 20


# ---------------------------------------------------------------------------
# the cache-seeded large step
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def filled(chains):
    """Both caches with paths, rows filled from the chains' own seed paths
    (pushed twice, so the common dimensions' 16-entry rows fill)."""
    js, jo, ts, jst, tst, _, _ = chains
    cj = jcache.make_cache(jo, Dm, jax.tree.map(lambda a: a[0], jst.rec))
    ct = cache_mod.make_cache(jo, Dm, 'cpu', tst.rec)
    dims = 2 * (tst.rec.cam_depth + tst.rec.lgt_depth - 1)
    pss = jget_pss(jst.rec, Dm)
    z = jnp.zeros_like(pss)
    for _ in range(2):
        cj = jcache.push_batch(cj, jnp.asarray(to_np(dims)), pss, z, z,
                               jst.ls_score, jnp.ones(C, bool), jo,
                               s_tag=jst.rec.cam_depth,
                               t_tag=jst.rec.lgt_depth, rec=jst.rec)
        ct = cache_mod.push_batch(ct, dims, _t(pss), _t(z), _t(z),
                                  tst.ls_score,
                                  torch.ones(C, dtype=torch.bool), jo,
                                  s_tag=tst.rec.cam_depth,
                                  t_tag=tst.rec.lgt_depth, rec=tst.rec)
    full = np.asarray(cj.count) >= jo.pss_max_size
    assert full.sum() >= 2, np.asarray(cj.count)
    np.testing.assert_array_equal(to_np(ct.count), np.asarray(cj.count))
    return cj, ct


def test_large_step_cache_matches_jax(chains, filled):
    js, jo, ts, jst, tst, jdist, tdist = chains
    cj, ct = filled
    key = jax.random.PRNGKey(5)
    jprop, ja = jax.jit(lambda k, s, c: jchain.large_step_cache(
        js, jo, k, s, jdist, c))(key, jst, cj)
    k_len, k_split, k_tape, k_pick, k_samp, k_off, k_noise = \
        jax.random.split(key, 7)
    k1, k2, k3 = jax.random.split(k_noise, 3)
    sd = jo.discrete_std_dev
    noise = dict(time=jax.random.normal(k1, (C,)) * sd,
                 cam_disc=jax.random.normal(k2, (C, D)) * sd,
                 lgt_disc=jax.random.normal(k3, (C, D)) * sd)
    u_pick = np.array(jax.random.uniform(k_pick, (C,)))
    with torch.no_grad():
        tprop, ta = chain.large_step_cache(
            ts, jo, tst, tdist, ct, trace.Tape(_t(_tape(k_tape, C)), D),
            _t(jax.random.uniform(k_len, (C,))),
            _t(jax.random.uniform(k_split, (C,))), _t(u_pick),
            _t(jax.random.uniform(k_samp, (C, 1)))[:, 0],
            _t(jax.random.normal(k_off, (C, Dm))) * jo.cache_sig,
            {k: _t(v) for k, v in noise.items()})
    length = np.asarray(jprop['length'])
    np.testing.assert_array_equal(to_np(tprop['length']), length)
    # the JAX step's branch pick, from its length and the row counts
    row_full = np.asarray(cj.count)[2 * length] >= jo.pss_max_size
    use_cache = row_full & (u_pick <= jo.cache_prob)
    np.testing.assert_array_equal(to_np(tprop['use_cache']), use_cache)
    assert use_cache.sum() >= 10 and (~use_cache).sum() >= 10
    ja = np.asarray(ja)
    assert (ja[use_cache] > 0).sum() >= 3 and (ja[~use_cache] > 0).sum() >= 3
    assert_close_most(to_np(ta), ja, 2e-3, err_msg='a')
    for k in ('ls', 'ss', 'contrib', 'screen'):
        assert_close_most(to_np(tprop[k]), np.asarray(jprop[k]), 2e-3,
                          err_msg=k)
    for k in ('cam_depth', 'lgt_depth'):
        np.testing.assert_array_equal(to_np(getattr(tprop['rec'], k)),
                                      np.asarray(getattr(jprop['rec'], k)))
