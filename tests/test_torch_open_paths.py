"""Path generation and the direct pass on the small generated open scene
(env map, point light, textures, rough dielectric; D = 3) in the port
against the JAX package, from the same uniform tape.

Tolerance as in test_torch_trace: rtol 2e-3 per lane on every
contribution slot, at most 1% of lanes beyond 10x rtol (a lane on a
discrete threshold: Russian roulette, a BSDF lobe or the dielectric's
reflect/refract pick, a triangle edge, an env CDF bin); integer records
equal on 99% of lanes. The direct pass's film, splatted from the same
tapes, agrees within 1e-3 of its mean per pixel on 99% of pixels."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.path import trace as jtrace
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.path import trace
from torch_parity import port_scene, jax_tree_to_numpy, to_np, \
    assert_close_most

torch.set_num_threads(1)
B = 384
D = 3
RTOL = 2e-3
SLOTS = ('ls_score', 'ss_score', 'mis_weight', 'contrib', 'screen_pos')


@pytest.fixture(scope='module')
def case(tmp_path_factory):
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('open')),
                                 small=True, width=64, height=48,
                                 max_depth=D, scene='open')
    js, jo, _ = jax_parse(xml)
    jo = jo.replace(max_depth=D)
    u = np.random.default_rng(5).random((B, jtrace.Tape.size(D)),
                                        dtype=np.float32)
    return js, jo, port_scene(js), u


def _flat(con):
    flat, _, _ = con.flatten()
    return {k: np.asarray(to_np(flat[k])) for k in SLOTS}


def test_bidir_matches_jax(case):
    js, jo, ts, u = case
    jrec, jcon, jla, jca = jax.jit(lambda u: jtrace.generate_path_bidir(
        js, jo, jtrace.Tape(u, D), min_depth=-1, max_depth=D))(
            jnp.asarray(u))
    with torch.no_grad():
        trec, tcon, tla, tca = trace.generate_path_bidir(
            ts, jo, trace.Tape(torch.as_tensor(u), D), min_depth=-1,
            max_depth=D)
    jf, tf = _flat(jcon), _flat(tcon)
    assert (jf['ls_score'] > 0).any(axis=0).sum() >= 6, 'too few techniques'
    for k in SLOTS:
        assert_close_most(tf[k], jf[k], RTOL, err_msg=f'bidir {k}')
    jr = jax_tree_to_numpy(jrec)
    same = np.ones(B, bool)
    for k in ('cam_tri', 'lgt_tri', 'cam_nee_light', 'cam_nee_lprim',
              'lgt_light_id', 'lgt_lprim', 'cam_use_abs', 'lgt_use_abs',
              'env_lprim'):
        eq = to_np(getattr(trec, k)) == jr[k]
        same &= eq.reshape(B, -1).all(1)
    assert (~same).sum() <= B // 100, f'{(~same).sum()} lanes differ'
    # the open scene's features all show up in these paths
    assert (jr['env_lprim'] >= 0).sum() > B // 10
    assert (jr['cam_tri'] < 0).any(1).sum() > B // 10
    for k in ('cam_bsdf_rnd', 'lgt_bsdf_rnd', 'cam_rr', 'lgt_rr',
              'cam_nee_rnd', 'lgt_rnd_pos', 'lgt_rnd_dir'):
        assert_close_most(to_np(getattr(trec, k)), jr[k], RTOL,
                          err_msg=f'bidir {k}')
    np.testing.assert_array_equal(to_np(tla)[same], np.asarray(jla)[same])
    np.testing.assert_array_equal(to_np(tca)[same], np.asarray(jca)[same])


@pytest.mark.parametrize('max_depth', [2, -1])
def test_uni_matches_jax(case, max_depth):
    js, jo, ts, u = case
    jrec, jcon = jax.jit(lambda u: jtrace.generate_path_uni(
        js, jo, jtrace.Tape(u, D), min_depth=-1, max_depth=max_depth))(
            jnp.asarray(u))
    with torch.no_grad():
        trec, tcon = trace.generate_path_uni(
            ts, jo, trace.Tape(torch.as_tensor(u), D), min_depth=-1,
            max_depth=max_depth)
    jf, tf = _flat(jcon), _flat(tcon)
    assert (jf['ls_score'] > 0).any()
    for k in SLOTS:
        assert_close_most(tf[k], jf[k], RTOL, err_msg=f'uni {max_depth} {k}')
    jr = jax_tree_to_numpy(jrec)
    for k in ('cam_tri', 'cam_nee_lprim', 'env_lprim'):
        eq = (to_np(getattr(trec, k)) == jr[k]).reshape(B, -1).all(1)
        assert (~eq).sum() <= B // 100, k
    assert (jr['env_lprim'] >= 0).any()


def _splat(w, h, screen, contrib, ls):
    """Film [h, w, 3] of the flattened slots with ls > 1e-10 (numpy)."""
    keep = ls > 1e-10
    px = np.clip((screen[..., 0] * w).astype(int), 0, w - 1)
    py = np.clip((screen[..., 1] * h).astype(int), 0, h - 1)
    film = np.zeros((h, w, 3))
    np.add.at(film, (py[keep], px[keep]), contrib[keep])
    return film


def test_direct_pass_film_matches_jax(case):
    """The direct pass (uni, depths <= 2) over every pixel of the 64x48
    film, 2 samples each, from the same tapes in both packages."""
    js, jo, ts, _ = case
    w, h, spp = ts.width, ts.height, 2
    ids = np.tile(np.arange(w * h), spp)
    pix = np.stack([ids % w, ids // w], -1).astype(np.int32)
    u = np.random.default_rng(6).random((len(ids), jtrace.Tape.size(D)),
                                        dtype=np.float32)
    _, jcon = jax.jit(lambda u, p: jtrace.generate_path_uni(
        js, jo, jtrace.Tape(u, D), pixel=p, min_depth=-1, max_depth=2))(
            jnp.asarray(u), jnp.asarray(pix))
    with torch.no_grad():
        _, tcon = trace.generate_path_uni(
            ts, jo, trace.Tape(torch.as_tensor(u), D),
            pixel=torch.as_tensor(pix), min_depth=-1, max_depth=2)
    films = []
    for con in (jcon, tcon):
        f = con.flatten()[0]
        films.append(_splat(w, h, *(np.asarray(to_np(f[k])) for k in
                                    ('screen_pos', 'contrib', 'ls_score'))))
    jfilm, tfilm = films
    assert np.isfinite(tfilm).all() and tfilm.min() >= 0
    # the sky is lit in the top rows
    assert tfilm[:4].mean() > 0
    err = np.abs(tfilm - jfilm).max(-1) / max(jfilm.mean(), 1e-9)
    assert (err > 1e-3).mean() <= 0.01, f'max {err.max():.3g}'
    np.testing.assert_allclose(tfilm.mean(), jfilm.mean(), rtol=1e-3)
