"""Point and environment lights of the small generated open scene in the
port against the JAX package (its env code has no other test on a machine
without the reference scenes).

* sample_direct and emit for every light type (point, area, env) from the
  same light ids, primitives, randoms and positions: equal within rtol
  1e-4 (atol 1e-6) on all lanes but a bounded few (assert_close_most: an
  env CDF bisection step or a tent jitter on an f32 tie can land in the
  neighbouring pixel); integer outputs (the env pixel) equal on 99% of
  lanes;
* env_sample_direction, env_emission (with and without a bake pack) and
  the frozen-pixel sample equal JAX's within the same bounds;
* ports of test_env_sample_pdf_consistency on the generated sky (JAX's
  function beside the port's on the same map) and of
  test_env_sampling_importance on a smooth synthetic map, with the
  tolerances of tests/test_lights.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.ops import lights as jlights
from langevin_mcmc_tpu.path import replay as jreplay
from langevin_mcmc_tpu.utils import vecmath as jvm
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.ops import lights
from langevin_mcmc_tpu_torch.scene.scenedata import (LIGHT_AREA, LIGHT_ENV,
                                                      LIGHT_POINT,
                                                      build_env_sample_info,
                                                      _env_neighborhoods,
                                                      _env_rw_pairs)
from langevin_mcmc_tpu_torch.utils import vecmath as vm
from torch_parity import port_scene, to_np, assert_close_most

torch.set_num_threads(1)
N = 2048
RTOL = 1e-4


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('open')),
                                 small=True, width=64, height=48,
                                 max_depth=3, scene='open')
    js, _, _ = jax_parse(xml)
    return js, port_scene(js)


@pytest.fixture(scope='module')
def lanes(scenes):
    """Light ids cycling over the scene's lights, their primitives (area
    triangle by its CDF, 0 otherwise), randoms, shading points."""
    js, ts = scenes
    rng = np.random.default_rng(31)
    lid = (np.arange(N) % ts.num_lights).astype(np.int32)
    u_disc = rng.random(N).astype(np.float32)
    lprim = to_np(lights.sample_discrete(ts, torch.as_tensor(lid),
                                         torch.as_tensor(u_disc)))
    pos = np.concatenate([rng.uniform(-3, 3, (N, 2)),
                          rng.uniform(0.05, 2.5, (N, 1))], 1)
    return dict(lid=lid, ltype=to_np(ts.light_type)[lid],
                lprim=lprim.astype(np.int32), u_disc=u_disc,
                r1=rng.random((N, 2)).astype(np.float32),
                r2=rng.random((N, 2)).astype(np.float32),
                pos=pos.astype(np.float32), time=np.zeros(N, np.float32))


def _t(d, k):
    return torch.as_tensor(d[k])


def _j(d, k):
    return jnp.asarray(d[k])


def test_lights_of_the_open_scene(scenes):
    _, ts = scenes
    assert sorted(to_np(ts.light_type).tolist()) == [LIGHT_POINT, LIGHT_AREA,
                                                     LIGHT_ENV]


def test_sample_discrete_matches_jax(scenes, lanes):
    js, _ = scenes
    want = np.asarray(jlights.sample_discrete(js, _j(lanes, 'lid'),
                                              _j(lanes, 'u_disc')))
    np.testing.assert_array_equal(lanes['lprim'], want)


def _compare(got, want, keys, ltype, tag):
    for k in keys:
        g, w = to_np(got[k]), np.asarray(want[k])
        if k == 'lprim_id':
            assert (g != w).mean() <= 0.01, f'{tag} {k}'
            continue
        for t in (LIGHT_POINT, LIGHT_AREA, LIGHT_ENV):
            m = ltype == t
            assert_close_most(g[m], w[m], RTOL, atol=1e-6,
                              err_msg=f'{tag} {k} light type {t}')


def test_sample_direct_matches_jax(scenes, lanes):
    js, ts = scenes
    ltype = lanes['ltype']
    with torch.no_grad():
        got = lights.sample_direct(ts, _t(lanes, 'lid'), _t(lanes, 'lprim'),
                                   _t(lanes, 'r1'), _t(lanes, 'pos'),
                                   _t(lanes, 'time'))
    want = jlights.sample_direct(js, _j(lanes, 'lid'), _j(lanes, 'lprim'),
                                 _j(lanes, 'r1'), _j(lanes, 'pos'),
                                 _j(lanes, 'time'))
    np.testing.assert_array_equal(to_np(got['valid']),
                                  np.asarray(want['valid']))
    env = ltype == LIGHT_ENV
    assert np.isinf(to_np(got['dist'])[env]).all()
    keys = ('dir_to_light', 'contrib', 'cos_at_light', 'direct_pdf',
            'emission_pdf', 'lprim_id')
    _compare(got, want, keys, ltype, 'sample_direct')
    fin = ~env
    assert_close_most(to_np(got['dist'])[fin], np.asarray(want['dist'])[fin],
                      RTOL, err_msg='sample_direct dist')


def test_emit_matches_jax(scenes, lanes):
    js, ts = scenes
    ltype = lanes['ltype']
    with torch.no_grad():
        got = lights.emit(ts, _t(lanes, 'lid'), _t(lanes, 'lprim'),
                          _t(lanes, 'r1'), _t(lanes, 'r2'), _t(lanes, 'time'))
    want = jlights.emit(js, _j(lanes, 'lid'), _j(lanes, 'lprim'),
                        _j(lanes, 'r1'), _j(lanes, 'r2'), _j(lanes, 'time'))
    _compare(got, want, ('org', 'dir', 'emission', 'cos_at_light',
                         'emission_pdf', 'direct_pdf', 'lprim_id'), ltype,
             'emit')
    # env emission rays start on the x1000 bounding sphere's disc
    env = ltype == LIGHT_ENV
    r = np.linalg.norm(to_np(got['org'])[env] - to_np(ts.bsphere_center),
                       axis=1)
    assert (r > 0.99 * ts.bsphere_radius).all()


def test_env_sample_and_emission_match_jax(scenes, lanes):
    js, ts = scenes
    with torch.no_grad():
        lp, d, value, pdf = lights.env_sample_direction(
            ts, _t(lanes, 'r2'), _t(lanes, 'time'))
    jlp, jd, jvalue, jpdf = jlights.env_sample_direction(
        js, _j(lanes, 'r2'), _j(lanes, 'time'))
    assert (to_np(lp) != np.asarray(jlp)).mean() <= 0.01
    for g, w, k in ((d, jd, 'dir'), (value, jvalue, 'value'),
                    (pdf, jpdf, 'pdf')):
        assert_close_most(to_np(g), np.asarray(w), RTOL, atol=1e-6,
                          err_msg=f'env_sample_direction {k}')

    rng = np.random.default_rng(32)
    dirs = rng.normal(size=(N, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs[: N // 4] = to_np(d)[: N // 4]   # include the sun
    t0 = _t(lanes, 'time')
    with torch.no_grad():
        got = lights.env_emission(ts, torch.as_tensor(dirs), t0)
        pack = lights.bake_env_dir(ts, torch.as_tensor(dirs), t0)
        got_pack = lights.env_emission(ts, torch.as_tensor(dirs), t0,
                                       pack=pack)
    jpack = jlights.bake_env_dir(js, jnp.asarray(dirs), _j(lanes, 'time'))
    want = jlights.env_emission(js, jnp.asarray(dirs), _j(lanes, 'time'))
    want_pack = jlights.env_emission(js, jnp.asarray(dirs),
                                     _j(lanes, 'time'), pack=jpack)
    for k in range(4):
        for g, w in ((got, want), (got_pack, want_pack)):
            if k == 0:
                assert (to_np(g[0]) != np.asarray(w[0])).mean() <= 0.01
            else:
                assert_close_most(to_np(g[k]), np.asarray(w[k]), RTOL,
                                  atol=1e-6, err_msg=f'env_emission {k}')
    for k in range(1, 4):
        np.testing.assert_array_equal(to_np(got[k]), to_np(got_pack[k]))


def test_frozen_env_sample_matches_jax(scenes, lanes):
    js, ts = scenes
    lp = lights.env_sample_direction(ts, _t(lanes, 'r2'),
                                     _t(lanes, 'time'))[0]
    rnd = np.random.default_rng(33).random((N, 2)).astype(np.float32)
    with torch.no_grad():
        pack = lights.bake_env_pixel(ts, lp)
        got = lights.frozen_env_sample_direction(ts, pack,
                                                 torch.as_tensor(rnd),
                                                 _t(lanes, 'time'))
    want = jreplay._frozen_env_sample_direction(
        js, jnp.asarray(to_np(lp)), jnp.asarray(rnd), _j(lanes, 'time'))
    jpack = jlights.bake_env_pixel(js, jnp.asarray(to_np(lp)))
    for k in ('row', 'col', 'cdf_row0', 'cdf_row1', 'cdf_col0', 'cdf_col1',
              'v00', 'v11', 'rw0', 'rw1'):
        np.testing.assert_array_equal(to_np(pack[k]), np.asarray(jpack[k]),
                                      err_msg=k)
    for k in range(3):
        assert_close_most(to_np(got[k]), np.asarray(want[k]), RTOL,
                          atol=1e-6, err_msg=f'frozen env {k}')


@pytest.mark.parametrize('package', ['port', 'jax'])
def test_env_sample_pdf_consistency(scenes, package):
    """env_emission's pdf at a sampled direction matches the sampling pdf
    (tests/test_lights.py, on the generated sky)."""
    js, ts = scenes
    rng = np.random.default_rng(0)
    n = 512
    rnd = rng.random((n, 2), np.float32)
    if package == 'port':
        with torch.no_grad():
            _, d, value, pdf = lights.env_sample_direction(
                ts, torch.as_tensor(rnd), torch.zeros(n))
            _, em, dpdf, _ = lights.env_emission(ts, d, torch.zeros(n))
        lum = lambda x: to_np(vm.luminance(x))
        pdf, dpdf, em_l, val_l = to_np(pdf), to_np(dpdf), lum(em), lum(value)
    else:
        _, d, value, pdf = jlights.env_sample_direction(
            js, jnp.asarray(rnd), jnp.zeros(n))
        _, em, dpdf, _ = jlights.env_emission(js, d, jnp.zeros(n))
        lum = lambda x: np.asarray(jvm.luminance(x))
        pdf, dpdf = np.asarray(pdf), np.asarray(dpdf)
        em_l, val_l = lum(em), lum(value)
    ratio = pdf / np.maximum(dpdf, 1e-12)
    assert np.median(np.abs(ratio - 1.0)) < 0.05
    vr = em_l / np.maximum(val_l, 1e-12)
    assert np.median(np.abs(vr - 1.0)) < 0.05


def test_env_sampling_importance(scenes):
    """MC integral of luminance / pdf over sampled directions equals the
    map's power integral (tests/test_lights.py, on the port, smooth
    synthetic map)."""
    _, ts = scenes
    h, w = 64, 128
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    img = (1.0 + np.sin(xx / w * 2 * np.pi) * 0.5
           + yy / h)[..., None].repeat(3, -1).astype(np.float32)
    cdf_rows, cdf_cols, row_w, norm, pix = build_env_sample_info(img)
    t = torch.as_tensor
    scene = dataclasses.replace(
        ts, env_image=t(img), env_neigh=t(_env_neighborhoods(img)),
        env_rw2=t(_env_rw_pairs(row_w)), env_cdf_rows=t(cdf_rows),
        env_cdf_cols=t(cdf_cols), env_row_weights=t(row_w),
        env_normalization=float(norm), env_pixel_size=t(pix))
    rng = np.random.default_rng(1)
    n = 200_000
    with torch.no_grad():
        _, d, value, pdf = lights.env_sample_direction(
            scene, t(rng.random((n, 2), np.float32)), torch.zeros(n))
    est = (to_np(vm.luminance(value)) / to_np(pdf)).mean()
    lum_img = (0.212671 * img[..., 0] + 0.715160 * img[..., 1]
               + 0.072169 * img[..., 2])
    sin_t = np.sin((np.arange(h) + 0.5) * np.pi / h)
    integral = (lum_img * sin_t[:, None]).sum() * (2 * np.pi / w) * (np.pi / h)
    assert abs(est / integral - 1.0) < 0.05
