"""Light-coordinate sampling (uselightcoordinatesampling) in the port, on
lcbox (an enclosed box under a large ceiling area light, D = 4): an (s, 0)
technique whose camera vertex c > 1 hits the light stores, in place of the
previous vertex's BSDF parameters, the light triangle's sample parameters
of the hit point, and its replay samples the light there.

* port only: get_sample_param inverts sample_tri (atol 1e-4, as the JAX
  package's test); a zero-offset perturb and frozen replay reproduce the
  generated (s, 0) scores (rtol 2e-4, as the JAX package's test); the
  frozen replay's gradient reaches the light coordinates;
* against JAX on the same inputs: get_sample_param and sample_tri_pdf
  (rtol 1e-5); bidirectional generation, every slot and the stored
  parameters (rtol 2e-3 per lane, at most 1% of lanes beyond 10x rtol, as
  in test_torch_trace); generate_subpath on the (s, 0) slots (rtol 3e-4,
  as in test_torch_subpath); perturb replay (rtol 2e-3, as in
  test_torch_replay) and path_grad (rtol 2e-2 / atol 4e-4 per lane, as in
  test_torch_replay: reverse mode through D steps of f32 geometry).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.ops import lights as jlights
from langevin_mcmc_tpu.path import trace as jtrace
from langevin_mcmc_tpu.path import replay as jreplay
from langevin_mcmc_tpu.path.records import PathRecord as JPathRecord
from langevin_mcmc_tpu_torch.interop import record_to_numpy
from langevin_mcmc_tpu_torch.ops import lights
from langevin_mcmc_tpu_torch.path import trace, replay
from langevin_mcmc_tpu_torch.path.records import to_subpath
from torch_parity import LCBOX, port_scene, to_np, assert_close_most

torch.set_num_threads(1)
B = 384
D = 4


@pytest.fixture(scope='module')
def lcbox():
    js, jo, _ = jax_parse(LCBOX)
    jo = jo.replace(max_depth=D, use_light_coordinate_sampling=True)
    ts = port_scene(js)
    u = np.random.default_rng(3).random((B, trace.Tape.size(D)),
                                        dtype=np.float32)
    with torch.no_grad():
        rec, con, _, _ = trace.generate_path_bidir(
            ts, jo, trace.Tape(torch.as_tensor(u), D), min_depth=-1,
            max_depth=-1)
    return js, jo, ts, u, rec, con


def _tag(rec, s, t):
    return to_subpath(rec, torch.full((B,), s, dtype=torch.int32),
                      torch.full((B,), t, dtype=torch.int32))


def _jax_rec(rec):
    return JPathRecord(**{k: jnp.asarray(v)
                          for k, v in record_to_numpy(rec).items()})


def _zero_noise():
    return dict(time=torch.zeros(B), cam_disc=torch.zeros(B, D),
                lgt_disc=torch.zeros(B, D))


def test_get_sample_param_inverts_sample_tri(lcbox):
    js, _, ts, _, _, _ = lcbox
    light_tris = np.nonzero(to_np(ts.tri_light) >= 0)[0]
    assert len(light_tris) > 0
    rng = np.random.default_rng(0)
    tri = torch.as_tensor(rng.choice(light_tris, 256))
    u = torch.as_tensor(rng.uniform(0.05, 0.95, (256, 2)).astype(np.float32))
    time = torch.zeros(256)
    pos, _ = lights.sample_tri(ts, tri, u, time)
    u2 = lights.get_sample_param(ts, tri, pos, time)
    np.testing.assert_allclose(to_np(u2), to_np(u), rtol=1e-4, atol=1e-4)
    jtri = jnp.asarray(to_np(tri))
    zt = jnp.zeros(256)
    np.testing.assert_allclose(
        to_np(u2), np.asarray(jlights.get_sample_param(
            js, jtri, jnp.asarray(to_np(pos)), zt)), rtol=1e-5, atol=1e-6)
    jpos, _ = jlights._sample_tri(js, jtri, jnp.asarray(to_np(u)), zt)
    np.testing.assert_allclose(to_np(pos), np.asarray(jpos), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(to_np(lights.sample_tri_pdf(ts, tri)),
                               np.asarray(jlights.sample_tri_pdf(js, jtri)),
                               rtol=1e-6)


@pytest.mark.parametrize('s', [3, 4, 5])
def test_lc_zero_offset_replay_parity(lcbox, s):
    """Zero-offset perturb and frozen replay reproduce the generated (s, 0)
    ssScore: the generation's lcJacobian / SamplePdf() and the replay's
    bsdfPdf / shapePdf agree (s = 3 takes no light coordinates)."""
    _, jo, ts, _, rec, con = lcbox
    ls = to_np(con.ls_score[:, s - 2, 0])
    ss = to_np(con.ss_score[:, s - 2, 0])
    m = ls > 1e-8
    assert m.sum() >= 10, f'the box should hit the light often: {m.sum()}'
    r = _tag(rec, s, 0)
    with torch.no_grad():
        _, res = replay.replay_path(ts, jo, r, torch.zeros(B, 2 * D),
                                    _zero_noise())
        _, resf = replay.replay_path(ts, jo, r, torch.zeros(B, 2 * D), None,
                                     mode='frozen')
    v = to_np(res['valid'])
    assert v[m].mean() > 0.99
    mm = m & v
    np.testing.assert_allclose(to_np(res['ss_score'])[mm], ss[mm],
                               rtol=2e-4, atol=1e-9)
    np.testing.assert_allclose(to_np(res['ls_score'])[mm], ls[mm],
                               rtol=2e-4, atol=1e-9)
    mf = m & to_np(resf['valid'])
    np.testing.assert_allclose(to_np(resf['ss_score'])[mf], ss[mf],
                               rtol=2e-4, atol=1e-9)


def test_lc_gradient_flows_through_light_coords(lcbox):
    """The frozen replay's gradient moves the point on the light: finite on
    every lane, non-zero in the light coordinates (dims 4-5 of slot (4, 0):
    screen, then two vertex pairs) of most lanes."""
    _, jo, ts, _, rec, con = lcbox
    m = to_np(con.ls_score[:, 2, 0]) > 1e-8
    assert m.sum() >= 5
    g = to_np(replay.path_grad(ts, jo, _tag(rec, 4, 0)))
    assert np.isfinite(g).all()
    lc_dims = np.abs(g[m][:, 4:6]).sum(1)
    assert (lc_dims > 0).mean() > 0.5, 'gradients dead in light coords'


def test_lc_bidir_matches_jax(lcbox):
    js, jo, ts, u, rec, con = lcbox
    jrec, jcon, _, _ = jax.jit(lambda uu: jtrace.generate_path_bidir(
        js, jo, jtrace.Tape(uu, D), min_depth=-1, max_depth=-1))(
            jnp.asarray(u))
    flat, _, _ = con.flatten()
    jflat, _, _ = jcon.flatten()
    for k in ('ls_score', 'ss_score', 'contrib', 'screen_pos', 'mis_weight'):
        assert_close_most(to_np(flat[k]), np.asarray(jflat[k]), 2e-3,
                          err_msg=k)
    # the light-coordinate parameters stored in place of BSDF parameters
    lc = to_np(con.ls_score[:, 2:, 0]) > 0
    assert lc.sum() >= 10
    assert_close_most(to_np(rec.cam_bsdf_rnd), np.asarray(jrec.cam_bsdf_rnd),
                      2e-3, err_msg='cam_bsdf_rnd')


@pytest.fixture(scope='module')
def jax_subpath(lcbox):
    js, jo = lcbox[0], lcbox[1]
    return jax.jit(lambda uu, ss, tt: jtrace.generate_subpath(
        js, jo, jtrace.Tape(uu, D), ss, tt))


@pytest.mark.parametrize('s', [3, 4, 5])
def test_lc_subpath_matches_jax(lcbox, jax_subpath, s):
    js, jo, ts, u, _, _ = lcbox
    full = lambda v: jnp.full(B, v, jnp.int32)
    jrec, jres = jax_subpath(jnp.asarray(u), full(s), full(0))
    with torch.no_grad():
        rec, res = trace.generate_subpath(
            ts, jo, trace.Tape(torch.as_tensor(u), D),
            torch.full((B,), s, dtype=torch.int32),
            torch.zeros(B, dtype=torch.int32))
    jv, tv = np.asarray(jres['valid']), to_np(res['valid'])
    assert jv.sum() >= 10 and (jv != tv).sum() <= B // 100
    m = jv & tv
    for k in ('ls', 'ss', 'contrib', 'screen', 'mis'):
        assert_close_most(to_np(res[k])[m], np.asarray(jres[k])[m], 3e-4,
                          err_msg=f'({s}, 0) {k}')
    assert_close_most(to_np(rec.cam_bsdf_rnd), np.asarray(jrec.cam_bsdf_rnd),
                      3e-4, err_msg=f'({s}, 0) cam_bsdf_rnd')


@pytest.fixture(scope='module')
def jax_fns(lcbox):
    js, jo = lcbox[0], lcbox[1]

    @jax.jit
    def perturb(r, offset, noise):
        return jreplay.replay_path(js, jo, r, offset, noise, mode='perturb')

    @jax.jit
    def grad(r):
        return jreplay.path_grad(js, jo, r)

    return perturb, grad


@pytest.mark.parametrize('s', [4, 5])
def test_lc_perturb_matches_jax(lcbox, jax_fns, s):
    _, jo, ts, _, rec, _ = lcbox
    rng = np.random.default_rng(12)
    offset = (rng.normal(size=(B, 2 * D)) * 0.01).astype(np.float32)
    noise = {k: (rng.normal(size=sh) * 0.01).astype(np.float32)
             for k, sh in (('time', (B,)), ('cam_disc', (B, D)),
                           ('lgt_disc', (B, D)))}
    r = _tag(rec, s, 0)
    _, jres = jax_fns[0](_jax_rec(r), jnp.asarray(offset),
                         {k: jnp.asarray(v) for k, v in noise.items()})
    with torch.no_grad():
        _, res = replay.replay_path(
            ts, jo, r, torch.as_tensor(offset),
            {k: torch.as_tensor(v) for k, v in noise.items()})
    jv, tv = np.asarray(jres['valid']), to_np(res['valid'])
    assert jv.sum() >= 10 and (jv != tv).sum() <= B // 100
    for k in ('ls_score', 'ss_score', 'contrib', 'screen_pos', 'mis_weight'):
        assert_close_most(to_np(res[k]), np.asarray(jres[k]), 2e-3,
                          err_msg=f'({s}, 0) {k}')


@pytest.mark.parametrize('s', [4, 5])
def test_lc_path_grad_matches_jax(lcbox, jax_fns, s):
    _, jo, ts, _, rec, con = lcbox
    r = _tag(rec, s, 0)
    with torch.no_grad():
        new_rec, res, bake = replay.replay_path(
            ts, jo, r, torch.zeros(B, 2 * D), _zero_noise(),
            collect_bake=True)
    g = to_np(replay.path_grad(ts, jo, new_rec, bake=bake))
    np.testing.assert_allclose(g, to_np(replay.path_grad(ts, jo, new_rec)),
                               rtol=1e-5, atol=1e-6)
    gj = np.asarray(jax_fns[1](_jax_rec(new_rec)))
    m = (to_np(con.ss_score[:, s - 2, 0]) > 1e-6) & to_np(res['valid'])
    assert m.sum() >= 5
    # the light coordinates: the BSDF pair of camera vertex s - 3
    assert np.abs(g[m][:, 2 * s - 4:2 * s - 2]).max() > 0
    assert_close_most(g[m], gj[m], 2e-2, atol=2e-2 * 2e-2,
                      err_msg=f'path_grad ({s}, 0)')
