"""H2MC in the port against the JAX package and against itself.

* h2mc_gaussian on planted gradient / Hessian batches (well-separated
  eigenvalues, and fallback lanes: zero score, a Hessian below the norm
  threshold): mean, inv_cov, log_det and cov_l cov_l^T within rtol 1e-3
  of the largest entry of the lane (f32 eigendecompositions by two LAPACK
  builds; cov_l itself is not compared, its columns' signs are arbitrary).
  A dense sample x = cov_l z + mean satisfies
  (x - mean)^T inv_cov (x - mean) = |z|^2 (rtol 1e-3, f32 products).
* path_grad_hessian (one replicated-lane pass a row group) against the
  plain form it replaced, one backward pass a Hessian row, kept here
  (row_pass_grad_hessian): gradient, Hessian and finite lanes bit for
  bit, on the small torus at D = 8 with a bake and on the moving open
  scene at D = 3 without one, each with mixed (s, t) slots and a lane
  planted non-finite; and with HESS_LANES forcing 2 and 4 row groups,
  bit for bit with one group.
* path_grad_hessian on the small generated torus (D = 3, slot (3, 0)):
  its gradient equals path_grad (rtol 1e-5), H is symmetric within the
  tolerance of the JAX package's own test (rtol 1e-2, atol 2e-2:
  second-order f32 autodiff), and H matches central differences of the
  autograd gradient (15%, or 2% of the lane's largest entry, skipping
  differences across a discontinuity).
* The MH ratio of small_step_h2mc, recomputed from the port's offsets and
  gradients/Hessians with JAX's h2mc_gaussian and gaussian_log_pdf:
  within rtol 1e-2 (the log-pdfs are differences of terms ~1e1 that two
  f32 eigendecompositions round apart; exp amplifies that).
* The port's H2MC render_mlt against its render_mc on lcbox: mean within
  10% and row correlation above 0.9.
* (slow, RUN_SLOW=1) path_grad_hessian against JAX: rtol 1e-3 per lane,
  at most 1% divergent lanes.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.mcmc import gaussian as JG
from langevin_mcmc_tpu.path import replay as jreplay
from langevin_mcmc_tpu.path.records import PathRecord as JPathRecord
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.interop import record_to_numpy
from langevin_mcmc_tpu_torch.mcmc import chain
from langevin_mcmc_tpu_torch.mcmc import gaussian as G
from langevin_mcmc_tpu_torch.path import trace, replay
from langevin_mcmc_tpu_torch.path.records import to_subpath
from torch_parity import LCBOX, port_scene, to_np, assert_close_most

torch.set_num_threads(1)
SIGMA = 0.01


# ---------------------------------------------------------------------------
# h2mc_gaussian
# ---------------------------------------------------------------------------

def _planted(rng, C, dim):
    """Gradients and symmetric Hessians Q diag(lam) Q^T with eigenvalues
    of both signs, log-spaced and well separated; lanes 0-3 are fallback
    lanes (zero score; a Hessian below 0.5 / sigma^2 in norm)."""
    grad = rng.normal(size=(C, dim)) * 30.0
    hess = np.zeros((C, dim, dim))
    for c in range(C):
        q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
        lam = np.logspace(1, 4.5, dim) * rng.choice([-1.0, 1.0], dim)
        hess[c] = (q * lam) @ q.T
    hess[2:4] *= 1e-4
    sc = np.ones(C)
    sc[0:2] = 0.0
    return (grad.astype(np.float32), hess.astype(np.float32),
            sc.astype(np.float32))


def _lane_scale(a):
    return np.abs(a).reshape(a.shape[0], -1).max(1).reshape(
        (-1,) + (1,) * (a.ndim - 1))


def test_h2mc_gaussian_matches_jax():
    C, dim = 32, 6
    grad, hess, sc = _planted(np.random.default_rng(0), C, dim)
    gj = JG.h2mc_gaussian(jnp.asarray(grad), jnp.asarray(hess), SIGMA,
                          jnp.asarray(sc))
    gt, _ = G.h2mc_gaussian(torch.as_tensor(grad), torch.as_tensor(hess),
                            SIGMA, torch.as_tensor(sc))
    covj = np.einsum('cij,ckj->cik', np.asarray(gj.cov_l),
                     np.asarray(gj.cov_l))
    covt = np.einsum('cij,ckj->cik', to_np(gt.cov_l), to_np(gt.cov_l))
    for name, got, want in (('mean', to_np(gt.mean), np.asarray(gj.mean)),
                            ('inv_cov', to_np(gt.inv_cov),
                             np.asarray(gj.inv_cov)),
                            ('cov', covt, covj)):
        err = np.abs(got - want) / np.maximum(_lane_scale(want), 1e-30)
        assert err.max() < 1e-3, f'{name}: max relative error {err.max()}'
    np.testing.assert_allclose(to_np(gt.log_det), np.asarray(gj.log_det),
                               rtol=1e-5)
    assert not to_np(gt.is_diagonal).any()
    # the fallback lanes are the isotropic N(0, sigma^2)
    iso = np.eye(dim) / SIGMA ** 2
    np.testing.assert_allclose(to_np(gt.inv_cov)[:4], np.broadcast_to(
        iso, (4, dim, dim)), rtol=1e-6)
    np.testing.assert_array_equal(to_np(gt.mean)[:4], 0.0)

    off = (np.random.default_rng(1).normal(size=(C, dim)) * 0.01).astype(
        np.float32)
    np.testing.assert_allclose(
        to_np(G.gaussian_log_pdf(torch.as_tensor(off), gt)),
        np.asarray(JG.gaussian_log_pdf(jnp.asarray(off), gj)), rtol=1e-4)


def test_dense_sample_whitens():
    C, dim = 32, 6
    grad, hess, sc = _planted(np.random.default_rng(2), C, dim)
    g, _ = G.h2mc_gaussian(torch.as_tensor(grad), torch.as_tensor(hess),
                           SIGMA, torch.as_tensor(sc))
    z = torch.as_tensor(np.random.default_rng(3).normal(
        size=(C, dim)).astype(np.float32))
    d = G.gaussian_sample(g, z) - g.mean
    quad = torch.einsum('ci,cij,cj->c', d, g.inv_cov, d)
    np.testing.assert_allclose(to_np(quad), to_np((z * z).sum(-1)),
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# path_grad_hessian
# ---------------------------------------------------------------------------

B = 192
D = 3
SLOT = (3, 0)


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """The small torus, and B proposal records tagged (3, 0) with their
    bake (a zero-offset perturb replay), as the H2MC step makes them."""
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('small')),
                                 small=True, width=64, height=48,
                                 max_depth=D, kernel='h2mc')
    js, jo, _ = jax_parse(xml)
    jo = jo.replace(max_depth=D)
    ts = port_scene(js)
    u = np.random.default_rng(11).random((B, trace.Tape.size(D)),
                                         dtype=np.float32)
    with torch.no_grad():
        rec, con, _, _ = trace.generate_path_bidir(
            ts, jo, trace.Tape(torch.as_tensor(u), D), min_depth=-1,
            max_depth=D)
        r = to_subpath(rec, torch.full((B,), SLOT[0], dtype=torch.int32),
                       torch.full((B,), SLOT[1], dtype=torch.int32))
        noise = dict(time=torch.zeros(B), cam_disc=torch.zeros(B, D),
                     lgt_disc=torch.zeros(B, D))
        new_rec, res, bake = replay.replay_path(
            ts, jo, r, torch.zeros(B, 2 * D), noise, collect_bake=True)
    live = to_np(con.ss_score[:, SLOT[0] - 2, SLOT[1]] > 1e-6) \
        & to_np(res['valid'])
    assert live.sum() >= 3
    g, h, _ = replay.path_grad_hessian(ts, jo, new_rec, bake=bake)
    return js, jo, ts, new_rec, bake, live, to_np(g), to_np(h)


def test_hessian_gradient_and_symmetry(setup):
    _, jo, ts, rec, bake, live, g, h = setup
    assert np.isfinite(g).all() and np.isfinite(h).all()
    np.testing.assert_allclose(g, to_np(replay.path_grad(ts, jo, rec,
                                                         bake=bake)),
                               rtol=1e-5, atol=1e-6)
    assert np.abs(h[live]).max() > 0
    np.testing.assert_allclose(h[live], np.swapaxes(h[live], 1, 2),
                               rtol=1e-2, atol=2e-2)


def test_hessian_matches_central_differences(setup):
    _, jo, ts, rec, _, live, _, h = setup
    dim = 2 * (SLOT[0] + SLOT[1] - 1)
    eps = 1e-3
    checked = 0
    for lane in np.nonzero(live)[0][:3]:
        r1 = dataclasses.replace(
            rec, **{k.name: getattr(rec, k.name)[lane:lane + 1]
                    for k in dataclasses.fields(rec)})
        f1 = replay.log_luminance_fn(ts, jo, r1)

        def grad_at(off):
            with torch.enable_grad():
                x = off.clone().requires_grad_(True)
                (gx,) = torch.autograd.grad(f1(x).sum(), x)
            return to_np(gx)[0]

        scale = np.abs(h[lane]).max()
        for k in range(dim):
            e = torch.zeros(1, 2 * D)
            e[0, k] = eps
            fd = (grad_at(e) - grad_at(-e)) / (2 * eps)
            row = h[lane, :, k]
            if not np.isfinite(fd).all() or np.abs(fd).max() > 10 * scale:
                continue  # across a discontinuity
            tol = np.maximum(0.15 * np.abs(fd), 0.02 * scale)
            assert (np.abs(fd - row)[:dim] <= tol[:dim]).all(), \
                f'lane {lane} column {k}: fd {fd[:dim]} vs H {row[:dim]}'
            checked += 1
    assert checked >= 4


def row_pass_grad_hessian(scene, opts, rec, bake=None):
    """The plain form of path_grad_hessian: one backward of the summed
    log-luminance with its graph kept, then one backward pass of
    sum(g[:, i]) for each Hessian row i; non-finite lanes zeroed."""
    C, Dm = rec.time.shape[0], 2 * rec.max_depth
    with torch.enable_grad():
        offset = torch.zeros((C, Dm), requires_grad=True)
        f = replay.log_luminance_fn(scene, opts, rec, bake=bake)(offset)
        (g,) = torch.autograd.grad(f.sum(), offset, create_graph=True)
        rows = []
        for i in range(Dm):
            (h_i,) = torch.autograd.grad(g[:, i].sum(), offset,
                                         retain_graph=i + 1 < Dm,
                                         allow_unused=True)
            rows.append(torch.zeros_like(offset) if h_i is None else h_i)
        h = torch.stack(rows, 1)
    g = g.detach()
    finite = (torch.isfinite(g).all(-1)
              & torch.isfinite(h).all(-1).all(-1))
    return (torch.where(finite[:, None], g, torch.zeros_like(g)),
            torch.where(finite[:, None, None], h, torch.zeros_like(h)),
            finite)


MIXED_B = 64


@pytest.fixture(scope='module', params=['bake', 'no_bake'])
def mixed(request, tmp_path_factory):
    """MIXED_B proposal records of mixed (s, t) slots (each lane's slot of
    largest ls_score), as the H2MC step makes them: the small torus at D =
    8 with its bake ('bake'), or the moving open scene of
    test_torch_motion_paths at D = 3 without one ('no_bake'). One lane
    whose camera walk continues has NaN Russian-roulette weights, so its
    gradient is not finite. Returns (scene, opts, record, bake or None,
    the planted lane, path_grad_hessian's result)."""
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    baked = request.param == 'bake'
    d = 8 if baked else 3
    xml = testscenes.write_scene(
        str(tmp_path_factory.mktemp(request.param)), small=True, width=64,
        height=48, max_depth=d, kernel='h2mc',
        scene='box' if baked else 'open', motion=not baked)
    ts, opts, _ = parse_scene(xml, device='cpu')
    opts = opts.replace(max_depth=d)
    assert ts.has_motion != baked
    u = np.random.default_rng(31).random((MIXED_B, trace.Tape.size(d)),
                                         dtype=np.float32)
    with torch.no_grad():
        rec, con, _, _ = trace.generate_path_bidir(
            ts, opts, trace.Tape(torch.as_tensor(u), d), min_depth=-1,
            max_depth=d)
        flat, s_tags, t_tags = con.flatten()
        pick = torch.argmax(flat['ls_score'], 1)
        r = to_subpath(rec, torch.as_tensor(s_tags)[pick],
                       torch.as_tensor(t_tags)[pick])
        noise = dict(time=torch.zeros(MIXED_B),
                     cam_disc=torch.zeros(MIXED_B, d),
                     lgt_disc=torch.zeros(MIXED_B, d))
        out = replay.replay_path(ts, opts, r, torch.zeros(MIXED_B, 2 * d),
                                 noise, collect_bake=baked)
    new_rec, bake = out[0], (out[2] if baked else None)
    assert len(set(zip(r.cam_depth.tolist(), r.lgt_depth.tolist()))) >= 4
    lane = int(torch.nonzero(new_rec.cam_depth >= 3)[0])
    cam_rr = new_rec.cam_rr.clone()
    cam_rr[lane] = float('nan')
    new_rec = dataclasses.replace(new_rec, cam_rr=cam_rr)
    return (ts, opts, new_rec, bake, lane,
            replay.path_grad_hessian(ts, opts, new_rec, bake=bake))


def test_grad_hessian_matches_row_passes(mixed):
    ts, opts, rec, bake, lane, got = mixed
    want = row_pass_grad_hessian(ts, opts, rec, bake=bake)
    for name, x, y in zip(('gradient', 'Hessian', 'finite'), got, want):
        np.testing.assert_array_equal(to_np(x), to_np(y), err_msg=name)
    g, h, finite = (to_np(x) for x in got)
    # the planted lane alone is zeroed, and the Hessians are not trivial
    assert not finite[lane] and finite.sum() >= MIXED_B - 2
    assert not g[lane].any() and not h[lane].any()
    assert (np.abs(h).reshape(MIXED_B, -1).max(1) > 0).sum() >= MIXED_B // 2


@pytest.mark.parametrize('groups', [2, 4])
def test_row_groups_match_one_group(mixed, groups, monkeypatch):
    ts, opts, rec, bake, _, one = mixed
    Dm = 2 * rec.max_depth
    assert len(replay.hess_groups(MIXED_B, Dm)) == 1
    monkeypatch.setattr(replay, 'HESS_LANES', Dm * MIXED_B // groups)
    assert len(replay.hess_groups(MIXED_B, Dm)) == groups
    got = replay.path_grad_hessian(ts, opts, rec, bake=bake)
    for name, x, y in zip(('gradient', 'Hessian', 'finite'), got, one):
        np.testing.assert_array_equal(to_np(x), to_np(y), err_msg=name)


@pytest.mark.slow
def test_hessian_matches_jax(setup):
    js, jo, _, rec, _, live, g, h = setup
    jrec = JPathRecord(**{k: jnp.asarray(v)
                          for k, v in record_to_numpy(rec).items()})
    gj, hj = jax.jit(lambda r: jreplay.path_grad_hessian(js, jo, r))(jrec)
    assert_close_most(g[live], np.asarray(gj)[live], 1e-3, atol=1e-3 * 1e-3,
                      err_msg='gradient')
    assert_close_most(h[live], np.asarray(hj)[live], 1e-3, atol=1e-3 * 1e-2,
                      err_msg='Hessian')


# ---------------------------------------------------------------------------
# the H2MC small step
# ---------------------------------------------------------------------------

C = 64


@pytest.fixture(scope='module')
def h2mc_step(setup):
    """One small_step_h2mc from C seed paths (one technique per lane,
    picked by contribution; every lane's current-side Gaussian built)."""
    js, jo, ts = setup[:3]
    jo = jo.replace(num_chains=C, cur_grad_fraction=1.0)
    u = np.random.default_rng(21).random((C, trace.Tape.size(D)),
                                         dtype=np.float32)
    with torch.no_grad():
        rec, con, _, _ = trace.generate_path_bidir(
            ts, jo, trace.Tape(torch.as_tensor(u), D), min_depth=3,
            max_depth=D)
    flat, s_tags, t_tags = con.flatten()
    pick = torch.argmax(flat['ls_score'], 1)
    lanes = torch.arange(C)
    take = lambda a: a[lanes, pick]
    trec = to_subpath(rec, torch.as_tensor(s_tags)[pick],
                      torch.as_tensor(t_tags)[pick])
    st = chain.init_chain_state(trec, take(flat['contrib']),
                                take(flat['screen_pos']),
                                take(flat['ls_score']),
                                take(flat['ss_score']),
                                flat['ls_score'].sum(1), jo)
    rng = np.random.default_rng(22)
    z = torch.as_tensor(rng.normal(size=(C, 2 * D)).astype(np.float32))
    noise = {k: torch.as_tensor((rng.normal(size=s) * 0.01).astype(
        np.float32)) for k, s in (('time', (C,)), ('cam_disc', (C, D)),
                                  ('lgt_disc', (C, D)))}
    with torch.no_grad():
        prop, a = chain.small_step_h2mc(ts, jo, st, z, noise)
    return jo, ts, st, z, prop, a


def test_h2mc_mh_ratio_matches_jax(h2mc_step):
    jo, ts, st, z, prop, a = h2mc_step
    assert to_np(prop['cur_ok']).all()
    offset = G.gaussian_sample(prop['gauss_cur'], z)

    def jax_gauss(rec, ss):
        bake = replay.bake_frozen(ts, jo, rec)
        g, h = (to_np(x) for x in replay.path_grad_hessian(ts, jo, rec,
                                                           bake=bake)[:2])
        m = to_np(ss) > 1e-15
        g = np.where(m[:, None], g, 0.0)
        h = np.where(m[:, None, None], h, 0.0)
        return JG.h2mc_gaussian(jnp.asarray(g), jnp.asarray(h), SIGMA,
                                jnp.asarray(to_np(ss)))

    gj_cur = jax_gauss(st.rec, st.ss_score)
    gj_prop = jax_gauss(prop['rec'], prop['ss'])
    off = jnp.asarray(to_np(offset))
    py = np.asarray(JG.gaussian_log_pdf(off, gj_cur), np.float64)
    px = np.asarray(JG.gaussian_log_pdf(-off, gj_prop), np.float64)
    ss_p = to_np(prop['ss']).astype(np.float64)
    ss_c = to_np(st.ss_score).astype(np.float64)
    aj = np.clip(np.exp(px - py) * ss_p / np.maximum(ss_c, 1e-20), 0, 1)
    aj = np.where(to_np(prop['ok']), aj, 0.0)
    at = to_np(a)
    assert (at > 0).sum() >= 8 and (at < 1).sum() >= 4
    assert_close_most(at, aj, 1e-2, err_msg='H2MC MH ratio')


# ---------------------------------------------------------------------------
# the whole estimator
# ---------------------------------------------------------------------------

def test_h2mc_matches_mc_mean():
    """The port's H2MC MLT (bootstrap, grad + Hessian, dense Gaussians,
    acceptance, splats) against its own plain MC on lcbox; maxDepth 3 and
    a 32x24 film as in the MALA test."""
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    from langevin_mcmc_tpu_torch.integrators.pathtrace import render_mc
    from langevin_mcmc_tpu_torch.integrators.mlt import render_mlt
    scene, opts, _ = parse_scene(LCBOX, film_wh=(32, 24), device='cpu')
    opts = opts.replace(max_depth=3, direct_spp=16, num_chains=256,
                        num_init_samples=4096, large_step_probability=0.3,
                        mala=False, h2mc=True)
    with torch.no_grad():
        mc = to_np(render_mc(scene, opts.replace(spp=64),
                             torch.Generator().manual_seed(0), chunk=4096))
        film, b = render_mlt(scene, opts, torch.Generator().manual_seed(1),
                             num_steps=20, chunk=4096, n_inner=10)
    img = to_np(film)
    assert np.isfinite(img).all()
    m_mc, m_mlt = mc.mean(), img.mean()
    assert abs(m_mlt - m_mc) / m_mc < 0.10, f'MC {m_mc} vs MCMC {m_mlt}'
    corr = np.corrcoef(mc.mean((1, 2)), img.mean((1, 2)))[0, 1]
    assert corr > 0.9, f'row correlation {corr}'
