"""Path replay on the small generated open scene (D = 3): paths that end
in the env map, refract through the rough dielectric torus and read the
floor's and the sphere's textures.

* port only: a zero offset reproduces generation slot by slot (rtol 2e-3),
  frozen replay equals perturb replay (rtol 1e-2), as in
  test_torch_replay;
* path_grad with the perturb replay's bake equals path_grad without one
  within 1e-5 on lanes that read no texture, within 1e-2 on lanes that do
  (the bake holds texture values read at the perturb hit's st, the
  frozen replay reads them at its own, f32 rounding apart);
* against JAX: perturb replay from the same record, offset and noise
  (rtol 2e-3 per lane, bounded divergent lanes), and path_grad (rtol 2e-2
  / atol 4e-4 per lane), on the lanes of each feature: an env hit (the
  frozen env pixel), a dielectric vertex, a textured vertex;
* central finite differences of the frozen log-luminance against
  path_grad on up to four lanes of each feature, both with the lane's
  zero-offset bake (so texture values and the env pixel are constants, as
  the gradient takes them; dimensions whose one-sided slopes disagree
  cross a discontinuity within eps and are skipped, at least four
  dimensions are checked), and finite raw gradients on every lane.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.path import replay as jreplay
from langevin_mcmc_tpu.path.records import PathRecord as JPathRecord
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.interop import record_to_numpy
from langevin_mcmc_tpu_torch.path import trace, replay
from langevin_mcmc_tpu_torch.path.records import to_subpath
from langevin_mcmc_tpu_torch.scene.scenedata import BSDF_ROUGH_DIELECTRIC
from torch_parity import port_scene, to_np, assert_close_most

torch.set_num_threads(1)
B = 256
D = 3
# (2, 0): camera ray straight to the sky; (3, 0), (4, 0): after bounces
SLOTS = [(2, 0), (3, 0), (4, 0), (2, 1), (3, 1), (2, 2), (1, 2), (1, 3)]


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('open')),
                                 small=True, width=64, height=48,
                                 max_depth=D, scene='open')
    js, jo, _ = jax_parse(xml)
    jo = jo.replace(max_depth=D)
    ts = port_scene(js)
    u = np.random.default_rng(11).random((B, trace.Tape.size(D)),
                                         dtype=np.float32)
    with torch.no_grad():
        rec, con, _, _ = trace.generate_path_bidir(
            ts, jo, trace.Tape(torch.as_tensor(u), D), min_depth=-1,
            max_depth=D)
    rng = np.random.default_rng(12)
    offset = (rng.normal(size=(B, 2 * D)) * 0.01).astype(np.float32)
    noise = {k: (rng.normal(size=s) * 0.01).astype(np.float32)
             for k, s in (('time', (B,)), ('cam_disc', (B, D)),
                          ('lgt_disc', (B, D)))}
    return js, jo, ts, rec, con, offset, noise


def _gen_slot(con, s, t):
    if s == 1:
        return to_np(con.l_ls_score[:, t - 2]), to_np(con.l_ss_score[:, t - 2])
    return to_np(con.ls_score[:, s - 2, t]), to_np(con.ss_score[:, s - 2, t])


def _tag(rec, s, t):
    return to_subpath(rec, torch.full((B,), s, dtype=torch.int32),
                      torch.full((B,), t, dtype=torch.int32))


def _zero_noise():
    return dict(time=torch.zeros(B), cam_disc=torch.zeros(B, D),
                lgt_disc=torch.zeros(B, D))


def _jax_rec(rec):
    return JPathRecord(**{k: jnp.asarray(v)
                          for k, v in record_to_numpy(rec).items()})


def _features(ts, rec, s, t):
    """Per-lane masks: the subpath ends in the env map; a camera or light
    vertex of it lies on the dielectric; one lies on a textured surface."""
    ncam, nlgt = max(s - 1, 0), max(t - 1, 0)
    tris = torch.cat([rec.cam_tri[:, :ncam], rec.lgt_tri[:, :nlgt]], 1)
    ok = tris >= 0
    mat = ts.tri_mat[torch.clamp(tris, min=0).long()].long()
    diel = ok & (ts.mat_type[mat] == BSDF_ROUGH_DIELECTRIC)
    tex = ok & (ts.mat_tex[mat, 0] >= 0)
    env = (rec.env_lprim >= 0) & (t == 0)
    return dict(env=to_np(env), dielectric=to_np(diel.any(1)),
                texture=to_np(tex.any(1)))


@pytest.mark.parametrize('slot', SLOTS)
def test_zero_offset_reproduces_generation(setup, slot):
    _, jo, ts, rec, con, _, _ = setup
    s, t = slot
    ls_gen, ss_gen = _gen_slot(con, s, t)
    mask = ss_gen > 1e-8
    assert mask.sum() >= 3, f'too few paths on slot {slot}'
    with torch.no_grad():
        _, res = replay.replay_path(ts, jo, _tag(rec, s, t),
                                    torch.zeros(B, 2 * D), _zero_noise())
    valid = to_np(res['valid'])
    assert valid[mask].mean() > 0.95
    m = mask & valid
    np.testing.assert_allclose(to_np(res['ss_score'])[m], ss_gen[m],
                               rtol=2e-3, atol=1e-7)
    np.testing.assert_allclose(to_np(res['ls_score'])[m], ls_gen[m],
                               rtol=2e-3, atol=1e-7)


@pytest.mark.parametrize('slot', [(2, 0), (3, 0), (4, 0), (2, 1), (1, 2)])
def test_frozen_matches_perturb(setup, slot):
    _, jo, ts, rec, con, _, _ = setup
    s, t = slot
    _, ss_gen = _gen_slot(con, s, t)
    r = _tag(rec, s, t)
    with torch.no_grad():
        _, res_p = replay.replay_path(ts, jo, r, torch.zeros(B, 2 * D),
                                      _zero_noise())
        _, res_f = replay.replay_path(ts, jo, r, torch.zeros(B, 2 * D), None,
                                      mode='frozen')
    m = (ss_gen > 1e-8) & to_np(res_p['valid']) & to_np(res_f['valid'])
    assert m.sum() >= 3
    np.testing.assert_allclose(to_np(res_f['ss_score'])[m],
                               to_np(res_p['ss_score'])[m], rtol=1e-2,
                               atol=1e-7)


@pytest.fixture(scope='module')
def jax_fns(setup):
    js, jo = setup[0], setup[1]

    @jax.jit
    def perturb(r, offset, noise):
        return jreplay.replay_path(js, jo, r, offset, noise, mode='perturb')

    @jax.jit
    def grad(r):
        return jreplay.path_grad(js, jo, r)

    return perturb, grad


@pytest.mark.parametrize('slot', [(2, 0), (3, 0), (4, 0), (2, 1), (1, 2)])
def test_perturb_matches_jax(setup, jax_fns, slot):
    _, jo, ts, rec, _, offset, noise = setup
    s, t = slot
    r = _tag(rec, s, t)
    _, jres = jax_fns[0](_jax_rec(r), jnp.asarray(offset),
                         {k: jnp.asarray(v) for k, v in noise.items()})
    with torch.no_grad():
        _, res = replay.replay_path(
            ts, jo, r, torch.as_tensor(offset),
            {k: torch.as_tensor(v) for k, v in noise.items()})
    jv = np.asarray(jres['valid'])
    tv = to_np(res['valid'])
    assert (jv != tv).sum() <= B // 100
    assert jv.sum() >= 3
    for k in ('ls_score', 'ss_score', 'contrib', 'screen_pos', 'mis_weight'):
        assert_close_most(to_np(res[k]), np.asarray(jres[k]), 2e-3,
                          err_msg=f'{slot} {k}')


# each feature on the slots whose paths carry it
GRAD_CASES = [((2, 0), 'env'), ((3, 0), 'env'), ((4, 0), 'dielectric'),
              ((2, 1), 'dielectric'), ((2, 1), 'texture'), ((1, 2), 'texture')]


@pytest.mark.parametrize('slot, feature', GRAD_CASES)
def test_path_grad_matches_jax(setup, jax_fns, slot, feature):
    _, jo, ts, rec, con, _, _ = setup
    s, t = slot
    _, ss_gen = _gen_slot(con, s, t)
    r = _tag(rec, s, t)
    with torch.no_grad():
        new_rec, res, bake = replay.replay_path(
            ts, jo, r, torch.zeros(B, 2 * D), _zero_noise(),
            collect_bake=True)
    g = to_np(replay.path_grad(ts, jo, new_rec, bake=bake))
    g_nobake = to_np(replay.path_grad(ts, jo, new_rec))
    feats = _features(ts, new_rec, s, t)
    # the bake holds texture values read at the perturb replay's hit, the
    # frozen replay reads them at its own: st differs by f32 rounding and
    # the checker's texel steps turn that into ~1e-3 of the value
    tex = feats['texture']
    np.testing.assert_allclose(g[~tex], g_nobake[~tex], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g[tex], g_nobake[tex], rtol=1e-2, atol=1e-4)
    gj = np.asarray(jax_fns[1](_jax_rec(new_rec)))
    m = (ss_gen > 1e-6) & to_np(res['valid']) & feats[feature]
    assert m.sum() >= 3, f'{m.sum()} lanes with {feature} on {slot}'
    assert np.abs(g[m]).max() > 0
    assert_close_most(g[m], gj[m], 2e-2, atol=2e-2 * 2e-2,
                      err_msg=f'path_grad {slot} {feature}')


@pytest.mark.parametrize('slot, feature', [((2, 0), 'env'),
                                           ((4, 0), 'dielectric'),
                                           ((2, 1), 'texture')])
def test_gradients_finite_and_match_finite_differences(setup, slot, feature):
    _, jo, ts, rec, con, _, _ = setup
    s, t = slot
    _, ss_gen = _gen_slot(con, s, t)
    r = _tag(rec, s, t)
    # raw autograd gradient, before path_grad's non-finite guard
    with torch.enable_grad():
        off = torch.zeros(B, 2 * D, requires_grad=True)
        f = replay.log_luminance_fn(ts, jo, r)(off)
        (g,) = torch.autograd.grad(f.sum(), off)
    assert torch.isfinite(g).all(), 'non-finite raw gradients'
    lanes = np.nonzero((ss_gen > 1e-6) & _features(ts, r, s, t)[feature])[0]
    assert len(lanes) >= 1
    eps = 1e-3
    checked = 0
    for lane in lanes[:4]:
        r1 = dataclasses.replace(
            r, **{k.name: getattr(r, k.name)[lane:lane + 1]
                  for k in dataclasses.fields(r)})
        # with the zero-offset bake, texture values and the env pixel are
        # constants of the offset, as the gradient takes them
        with torch.no_grad():
            r1, _, bake1 = replay.replay_path(
                ts, jo, r1, torch.zeros(1, 2 * D),
                dict(time=torch.zeros(1), cam_disc=torch.zeros(1, D),
                     lgt_disc=torch.zeros(1, D)), collect_bake=True)
        f1 = replay.log_luminance_fn(ts, jo, r1, bake=bake1)
        g1 = to_np(replay.path_grad(ts, jo, r1, bake=bake1))[0]
        with torch.no_grad():
            f0 = float(f1(torch.zeros(1, 2 * D))[0])
        for k in range(2 * (s + t - 1)):
            e = torch.zeros(1, 2 * D)
            e[0, k] = eps
            with torch.no_grad():
                fp = (float(f1(e)[0]) - f0) / eps
                fm = (f0 - float(f1(-e)[0])) / eps
            # one-sided slopes that disagree mean a discontinuity within
            # eps: a PSS coordinate wrapping past 0 or 1, or the frozen env
            # neighbourhood's pixel edge
            if not np.isfinite(fp + fm) \
                    or abs(fp - fm) > 0.2 * max(abs(fp), abs(fm)) + 0.5:
                continue
            fd = 0.5 * (fp + fm)
            assert abs(fd - g1[k]) < max(0.15 * abs(fd), 0.3), \
                f'lane {lane} dim {k}: fd={fd} grad={g1[k]}'
            checked += 1
    assert checked >= 4
