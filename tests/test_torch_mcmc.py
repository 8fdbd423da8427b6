"""MCMC pieces of the port against the JAX package, and the port's MCMC
estimator against its own plain MC estimator.

* gaussian.py: the same formulas in f32 (rtol 1e-5);
* the global cache: push_batch exactly; query_knn within rtol 1e-4 on
  well-separated queries and with planted duplicates (the port computes
  exact subtract-then-square distances, the JAX package the f32 expansion
  |q|^2 - 2 q.e + |e|^2; both weight a coincident entry ~1e6 above the
  rest, so the interpolated moments agree);
* large_step and the MH ratio of small_step_mala from the same draws,
  rebuilt from the JAX key (rtol 2e-3 per lane with bounded divergent
  lanes, as in test_torch_trace; the MH ratio takes rtol 2e-2 since it
  goes through the proposal-side gradient);
* the port's render_mlt against its render_mc on lcbox: mean within 10%
  and row correlation above 0.9.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.mcmc import gaussian as JG
from langevin_mcmc_tpu.mcmc import cache as jcache
from langevin_mcmc_tpu.mcmc import chain as jchain
from langevin_mcmc_tpu.path.records import PathRecord as JPathRecord
from langevin_mcmc_tpu.utils.distribution import Distribution1D as JDist
from langevin_mcmc_tpu_torch import Options, testscenes
from langevin_mcmc_tpu_torch.interop import (chain_state_from_numpy,
                                             record_to_numpy)
from langevin_mcmc_tpu_torch.mcmc import gaussian as G
from langevin_mcmc_tpu_torch.mcmc import cache as cache_mod
from langevin_mcmc_tpu_torch.mcmc import chain
from langevin_mcmc_tpu_torch.path import trace
from langevin_mcmc_tpu_torch.path.records import to_subpath
from langevin_mcmc_tpu_torch.utils.distribution import Distribution1D
from torch_parity import (LCBOX, port_scene, jax_tree_to_numpy, to_np,
                          assert_close_most)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# gaussian.py
# ---------------------------------------------------------------------------

def test_gaussians_match_jax():
    rng = np.random.default_rng(0)
    C, dim = 64, 8
    opts = Options()
    v1 = rng.normal(size=(C, dim)).astype(np.float32)
    v2 = (rng.random((C, dim)) * 2).astype(np.float32)
    M = (rng.random((C, dim)) * 10 + 0.01).astype(np.float32)
    ss = np.full(C, 0.005, np.float32)
    sc = np.where(rng.random(C) < 0.2, 0.0, rng.random(C)).astype(np.float32)
    off = (rng.normal(size=(C, dim)) * 0.01).astype(np.float32)
    key = jax.random.PRNGKey(3)
    z = np.array(jax.random.normal(key, (C, dim)))

    gj = JG.mala_gaussian(jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(ss),
                          0.005, jnp.asarray(M), jnp.asarray(sc), opts)
    gt = G.mala_gaussian(*(torch.as_tensor(x) for x in (v1, v2, ss)), 0.005,
                         torch.as_tensor(M), torch.as_tensor(sc), opts)
    for k in ('mean', 'cov_l_d', 'inv_cov_d', 'log_det'):
        np.testing.assert_allclose(to_np(getattr(gt, k)),
                                   np.asarray(getattr(gj, k)), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(
        to_np(G.gaussian_log_pdf(torch.as_tensor(off), gt)),
        np.asarray(JG.gaussian_log_pdf(jnp.asarray(off), gj)), rtol=1e-5)
    np.testing.assert_allclose(
        to_np(G.gaussian_sample(gt, torch.as_tensor(z))),
        np.asarray(JG.gaussian_sample(key, gj)), rtol=1e-5, atol=1e-8)

    ij = JG.isotropic_gaussian((C,), dim, 0.01, dense=False)
    it = G.isotropic_gaussian(C, dim, 0.01, 'cpu')
    for k in ('mean', 'cov_l_d', 'inv_cov_d', 'log_det'):
        np.testing.assert_allclose(to_np(getattr(it, k)),
                                   np.asarray(getattr(ij, k)), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(
        to_np(G.gaussian_log_pdf(torch.as_tensor(off), it)),
        np.asarray(JG.gaussian_log_pdf(jnp.asarray(off), ij)), rtol=1e-5)


def test_distribution_matches_jax():
    """The path-length distribution bootstrap builds (Distribution1D)."""
    w = np.array([0.0, 3.0, 1.0, 0.0, 6.0, 2.0])
    u = np.random.default_rng(4).random(500).astype(np.float32)
    dj, dt = JDist(w), Distribution1D(w, 'cpu')
    ij, pj = dj.sample_discrete(jnp.asarray(u))
    it, pt = dt.sample_discrete(torch.as_tensor(u))
    np.testing.assert_array_equal(to_np(it), np.asarray(ij))
    np.testing.assert_allclose(to_np(pt), np.asarray(pj), rtol=1e-6)


# ---------------------------------------------------------------------------
# the global cache
# ---------------------------------------------------------------------------

def _small_cache_opts():
    return Options(pss_max_size=16)


def _pushes(rng, C, Dm, ndim):
    dims = rng.integers(0, ndim + 2, C).astype(np.int32)
    pss = rng.random((C, Dm)).astype(np.float32)
    v1 = rng.normal(size=(C, Dm)).astype(np.float32)
    v2 = rng.random((C, Dm)).astype(np.float32)
    w = rng.random(C).astype(np.float32)
    mask = rng.random(C) < 0.7
    return dims, pss, v1, v2, w, mask


def _fill_both(opts, Dm, rounds, rng):
    cj = jcache.make_cache(opts, Dm)
    ct = cache_mod.make_cache(opts, Dm, 'cpu')
    ndim = opts.pss_max_length + 1
    for _ in range(rounds):
        dims, pss, v1, v2, w, mask = _pushes(rng, 96, Dm, ndim)
        st = (dims // 2).astype(np.int32)
        cj = jcache.push_batch(cj, *(jnp.asarray(x) for x in
                                     (dims, pss, v1, v2, w, mask)), opts,
                               s_tag=jnp.asarray(st), t_tag=jnp.asarray(st))
        ct = cache_mod.push_batch(ct, *(torch.as_tensor(x) for x in
                                        (dims, pss, v1, v2, w, mask)), opts,
                                  s_tag=torch.as_tensor(st),
                                  t_tag=torch.as_tensor(st))
    return cj, ct


def test_push_batch_matches_jax():
    opts = _small_cache_opts()
    cj, ct = _fill_both(opts, 8, 3, np.random.default_rng(1))
    assert int(np.asarray(cj.count).sum()) > 0
    assert (np.asarray(cj.count) == opts.pss_max_size).any(), \
        'no row filled: the overflow path is untested'
    for k in ('pss', 'v1', 'v2', 'weight', 's_tag', 't_tag', 'count'):
        np.testing.assert_array_equal(to_np(getattr(ct, k)),
                                      np.asarray(getattr(cj, k)), err_msg=k)
    np.testing.assert_allclose(to_np(ct.score_sum), np.asarray(cj.score_sum),
                               rtol=1e-6)


def test_query_knn_matches_jax_with_planted_duplicates():
    opts = _small_cache_opts()
    Dm = 8
    rng = np.random.default_rng(2)
    cj, ct = _fill_both(opts, Dm, 3, rng)
    count = np.asarray(cj.count)
    rows = [d for d in range(2, opts.pss_max_length + 1) if count[d] >= 4]
    C = 48
    dims = rng.choice(rows, C).astype(np.int32)
    pss_store = np.asarray(cj.pss)
    q = rng.random((C, Dm)).astype(np.float32)
    # a third of the queries sit exactly on a stored entry, a third within
    # the query radius of one, a third anywhere
    for i in range(C):
        e = pss_store[dims[i], rng.integers(0, count[dims[i]])]
        if i % 3 == 0:
            q[i] = e
        elif i % 3 == 1:
            q[i] = e + rng.normal(size=Dm).astype(np.float32) * 1e-3
    fj, v1j, v2j = (np.asarray(x) for x in jcache.query_knn(
        cj, jnp.asarray(dims), jnp.asarray(q), opts))
    ft, v1t, v2t = (to_np(x) for x in cache_mod.query_knn(
        ct, torch.as_tensor(dims), torch.as_tensor(q), opts))
    np.testing.assert_array_equal(ft, fj)
    assert ft[0::3].all() and ft[1::3].all()
    np.testing.assert_allclose(v1t[ft], v1j[fj], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v2t[ft], v2j[fj], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# large step and MALA small step from the same draws
# ---------------------------------------------------------------------------

C = 64
D = 3


@pytest.fixture(scope='module')
def chains(tmp_path_factory):
    """A JAX and a port ChainState over the same seed paths (one technique
    per lane, picked by contribution), half of the lanes valid."""
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('small')),
                                 small=True, width=64, height=48,
                                 max_depth=D)
    js, jo, _ = jax_parse(xml)
    jo = jo.replace(max_depth=D, num_chains=C)
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
    s_sel, t_sel = s_tags[pick], t_tags[pick]
    take = lambda a: to_np(a)[lanes, pick]
    seeds = dict(contrib=take(flat['contrib']),
                 screen=take(flat['screen_pos']), ls=take(flat['ls_score']),
                 ss=take(flat['ss_score']), score_sum=ls.sum(1))
    trec = to_subpath(rec, torch.as_tensor(s_sel), torch.as_tensor(t_sel))
    jrec = JPathRecord(**{k: jnp.asarray(v)
                          for k, v in record_to_numpy(trec).items()})
    valid = np.arange(C) % 2 == 0
    args = ('contrib', 'screen', 'ls', 'ss', 'score_sum')
    jst = jchain.init_chain_state(jrec, *(jnp.asarray(seeds[k])
                                          for k in args), jo)
    jst = dataclasses.replace(jst, valid=jnp.asarray(valid))
    tst = chain.init_chain_state(trec, *(torch.as_tensor(seeds[k])
                                         for k in args), jo)
    tst = dataclasses.replace(tst, valid=torch.as_tensor(valid))
    return js, jo, ts, jst, tst


def test_chain_state_crosses_over(chains):
    """interop builds the port's ChainState from the JAX one's arrays."""
    _, _, _, jst, tst = chains
    back = record_to_numpy(chain_state_from_numpy(jax_tree_to_numpy(jst)))
    want = record_to_numpy(tst)
    for k, v in want.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                np.testing.assert_allclose(back[k][k2], v2, rtol=1e-6,
                                           err_msg=f'{k}.{k2}')
        else:
            np.testing.assert_allclose(back[k], v, rtol=1e-6, err_msg=k)


def test_large_step_matches_jax(chains):
    js, jo, ts, jst, tst = chains
    key = jax.random.PRNGKey(7)
    jprop, ja = jax.jit(lambda k, s: jchain.large_step(js, jo, k, s))(key,
                                                                      jst)
    k_tape, k_pick = jax.random.split(key)
    tape = np.array(jax.random.uniform(k_tape, (C, trace.Tape.size(D))))
    u_pick = np.array(jax.random.uniform(k_pick, (C,)))
    with torch.no_grad():
        tprop, ta = chain.large_step(ts, jo, tst,
                                     trace.Tape(torch.as_tensor(tape), D),
                                     torch.as_tensor(u_pick))
    assert (np.asarray(ja) > 0).sum() >= 3
    assert_close_most(to_np(ta), np.asarray(ja), 2e-3, err_msg='a')
    for k in ('ls', 'ss', 'contrib', 'screen', 'score_sum'):
        assert_close_most(to_np(tprop[k]), np.asarray(jprop[k]), 2e-3,
                          err_msg=k)
    same = (to_np(tprop['rec'].cam_depth) == np.asarray(
        jprop['rec'].cam_depth)) & (to_np(tprop['rec'].lgt_depth)
                                    == np.asarray(jprop['rec'].lgt_depth))
    assert (~same).sum() <= C // 50


def test_mala_mh_ratio_matches_jax(chains):
    js, jo, ts, jst, tst = chains
    key = jax.random.PRNGKey(9)
    cj = jcache.make_cache(jo, 2 * D)
    jprop, ja = jax.jit(lambda k, s, c: jchain.small_step_mala(
        js, jo, k, s, cache=c))(key, jst, cj)
    k_off, k_noise = jax.random.split(key)
    z = np.array(jax.random.normal(k_off, (C, 2 * D)))
    k1, k2, k3 = jax.random.split(k_noise, 3)
    sd = jo.discrete_std_dev
    noise = dict(time=jax.random.normal(k1, (C,)) * sd,
                 cam_disc=jax.random.normal(k2, (C, D)) * sd,
                 lgt_disc=jax.random.normal(k3, (C, D)) * sd)
    ct = cache_mod.make_cache(jo, 2 * D, 'cpu')
    with torch.no_grad():
        tprop, ta = chain.small_step_mala(
            ts, jo, tst, torch.as_tensor(z),
            {k: torch.as_tensor(np.array(v)) for k, v in noise.items()},
            cache=ct)
    ja = np.asarray(ja)
    assert (ja > 0).sum() >= 3
    np.testing.assert_array_equal(to_np(tprop['cur_ok']),
                                  np.asarray(jprop['cur_ok']))
    assert_close_most(to_np(tprop['ss']), np.asarray(jprop['ss']), 2e-3,
                      frac=0.05, err_msg='proposal ss')
    assert_close_most(to_np(ta), ja, 2e-2, frac=0.05, err_msg='MH ratio')
    for k in ('mean', 'inv_cov_d'):
        assert_close_most(to_np(getattr(tprop['gauss_cur'], k)),
                          np.asarray(getattr(jprop['gauss_cur'], k)), 2e-2,
                          frac=0.05, atol=1e-6, err_msg=f'gauss_cur {k}')


# ---------------------------------------------------------------------------
# the whole estimator
# ---------------------------------------------------------------------------

def test_mcmc_matches_mc_mean_fast():
    """The port's MLT (bootstrap, MALA gradient and replay, acceptance,
    splats, cache) against its own plain MC on lcbox. maxDepth 3 so the
    MLT (which takes depths >= 3) has indirect paths; 32x24 film."""
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    from langevin_mcmc_tpu_torch.integrators.pathtrace import render_mc
    from langevin_mcmc_tpu_torch.integrators.mlt import render_mlt
    scene, opts, _ = parse_scene(LCBOX, film_wh=(32, 24), device='cpu')
    opts = opts.replace(max_depth=3, direct_spp=16, num_chains=256,
                        num_init_samples=4096, large_step_probability=0.3)
    with torch.no_grad():
        mc = to_np(render_mc(scene, opts.replace(spp=64),
                             torch.Generator().manual_seed(0), chunk=4096))
        film, b = render_mlt(scene, opts, torch.Generator().manual_seed(1),
                             num_steps=240, chunk=4096)
    img = to_np(film)
    assert np.isfinite(img).all()
    m_mc, m_mlt = mc.mean(), img.mean()
    assert abs(m_mlt - m_mc) / m_mc < 0.10, f'MC {m_mc} vs MCMC {m_mlt}'
    corr = np.corrcoef(mc.mean((1, 2)), img.mean((1, 2)))[0, 1]
    assert corr > 0.9, f'row correlation {corr}'
