"""Scene features of the small generated open scene (env map, point light,
bitmap textures, rough dielectric) in the port against the JAX package.

* every host array the port's parser builds equals the JAX SceneData's
  bit for bit: geometry, materials and their texture ids, the light CDF,
  the env CDFs, neighbourhoods and row-weight pairs, the bounding sphere,
  the Woop tables; the texture atlas equals the JAX atlas flattened (the
  port keeps one flat layout with int32 row offsets);
* eval_texture at random st, wrapped past [0, 1], equals the JAX lookup
  within 1e-6 relative (rtol 1e-6, atol 1e-7);
* the vecmath helpers the new branches call equal JAX's within 1e-6;
* the parser: the features ported here parse, and so do the ones ported
  since (motion of shapes, camera and env map, the large-step samplers,
  light coordinates, the isotropic-only small step), each setting what
  the JAX parser sets.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.scene import textures as jtex
from langevin_mcmc_tpu.utils import vecmath as jvm
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.interop import textures_from_numpy
from langevin_mcmc_tpu_torch.scene import textures as ttex
from langevin_mcmc_tpu_torch.scene.parse import (LIGHT_AREA, parse_scene,
                                                  parse_scene_host)
from langevin_mcmc_tpu_torch.scene.scenedata import HOST_FIELDS
from langevin_mcmc_tpu_torch.utils import vecmath as tvm
from torch_parity import to_np

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def open_xml(tmp_path_factory):
    return testscenes.write_scene(str(tmp_path_factory.mktemp('open')),
                                  small=True, width=64, height=48,
                                  max_depth=3, scene='open')


@pytest.fixture(scope='module')
def scenes(open_xml):
    js, _, _ = jax_parse(open_xml)
    host, _, _ = parse_scene_host(open_xml)
    ts, _, _ = parse_scene(open_xml, device='cpu')
    return js, host, ts


def test_open_scene_has_every_feature(scenes):
    js, host, ts = scenes
    assert sorted(host['light_type'].tolist()) == [0, 1, 2]
    assert host['env_light_id'] == js.env_light_id >= 0
    assert (host['mat_type'] == 2).any()
    assert (host['mat_kd_tex'] >= 0).sum() == 2
    assert ts.tex_slots == (True, False, False, False)
    assert ts.textures.count == 2


@pytest.mark.parametrize('field', HOST_FIELDS)
def test_host_arrays_equal_jax(scenes, field):
    js, host, ts = scenes
    want = np.asarray(getattr(js, field))
    got = np.asarray(host[field])
    assert got.dtype == want.dtype, f'{field}: {got.dtype} vs {want.dtype}'
    np.testing.assert_array_equal(got, want, err_msg=field)


def test_device_scene_equals_jax(scenes):
    js, host, ts = scenes
    for k in ('env_image', 'env_neigh', 'env_rw2', 'env_cdf_rows',
              'env_cdf_cols', 'env_row_weights', 'env_pixel_size',
              'light_cdf', 'light_pos', 'mat_eta', 'mat_inv_eta',
              'mat_alpha', 'bsphere_center'):
        np.testing.assert_array_equal(to_np(getattr(ts, k)),
                                      np.asarray(getattr(js, k)), err_msg=k)
    assert np.float32(ts.env_normalization) == np.asarray(js.env_normalization)
    assert np.float32(ts.bsphere_radius) == np.asarray(js.bsphere_radius)
    assert ts.env_light_id == js.env_light_id
    tex = js.textures
    want = textures_from_numpy(dict(neigh=np.asarray(tex.neigh),
                                    size=np.asarray(tex.size),
                                    gamma=np.asarray(tex.gamma),
                                    uvscale=np.asarray(tex.uvscale),
                                    offset=tex.offset))
    for k in ('neigh', 'offset', 'size', 'gamma', 'uvscale'):
        np.testing.assert_array_equal(to_np(getattr(ts.textures, k)), want[k],
                                      err_msg=k)
    assert ts.textures.offset.dtype == torch.int32


def test_flat_atlas_offsets(scenes):
    js, _, ts = scenes
    size = to_np(ts.textures.size)
    np.testing.assert_array_equal(
        to_np(ts.textures.offset),
        np.concatenate([[0], np.cumsum(size[:, 0] * size[:, 1])[:-1]]))
    assert ts.textures.neigh.shape[0] == int((size[:, 0] * size[:, 1]).sum())


def test_eval_texture_matches_jax(scenes):
    js, _, ts = scenes
    rng = np.random.default_rng(4)
    n = 4096
    st = rng.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    tid = rng.integers(-1, ts.textures.count, n).astype(np.int32)
    want = np.asarray(jtex.eval_texture(js.textures, jnp.asarray(tid),
                                        jnp.asarray(st)))
    got = to_np(ttex.eval_texture(ts.textures, torch.as_tensor(tid),
                                  torch.as_tensor(st)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[tid < 0] == 1.0).all()


def test_texture_atlas_limit():
    big = np.zeros((2, 1, 1, 12), np.float32)
    with pytest.raises(ValueError, match='2\\*\\*31'):
        ttex._flatten_neigh(big, np.array([[2 ** 16, 2 ** 15]] * 2))


def test_vecmath_matches_jax():
    rng = np.random.default_rng(8)
    n = 1024
    u = rng.random((n, 2)).astype(np.float32)
    u[:4] = [[0.5, 0.5], [0.5, 0.2], [0.9, 0.5], [0.0, 1.0]]
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    nrm = np.tile(np.float32([[0, 0, 1]]), (n, 1))
    ct = rng.uniform(-1, 1, n).astype(np.float32)
    eta = np.full(n, 1.5, np.float32)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    a, b = (rng.normal(size=n).astype(np.float32) for _ in range(2))
    b[:8] = 0.0
    t = lambda x: torch.as_tensor(x)
    j = jnp.asarray
    pairs = [
        (tvm.sample_concentric_disc(t(u)), jvm.sample_concentric_disc(j(u))),
        (tvm.refract(t(wi), t(nrm), t(ct), t(eta), t(1 / eta)),
         jvm.refract(j(wi), j(nrm), j(ct), j(eta), j(1 / eta))),
        (tvm.tent(t(u)), jvm.tent(j(u))),
        (tvm.xform_vector(t(m), t(wi)), jvm.xform_vector(j(m), j(wi))),
        (tvm.safe_div(t(a), t(b), 7.0), jvm.safe_div(j(a), j(b), 7.0)),
        (tvm.lerp(t(a), t(wi[:, 0]), t(wi[:, 1])),
         jvm.lerp(j(a), j(wi[:, 0]), j(wi[:, 1])))]
    for k, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=f'pair {k}')


_SCENE_HEAD = '''<?xml version='1.0' encoding='utf-8'?>
<scene version="0.5.0">
    {dpt}
    <sensor type="perspective">
        <float name="fov" value="60"/>
        {cam}
        <film type="hdrfilm">
            <integer name="width" value="16"/>
            <integer name="height" value="12"/>
        </film>
    </sensor>
    {extra}
    <shape type="obj">
        <string name="filename" value="floor.obj"/>
        {toworld}
    </shape>
</scene>
'''
_LOOKAT = '<lookat target="0, 0, 0" origin="0, -6, 2" up="0, 0, 1"/>'
_CAM = '<transform name="toWorld">' + _LOOKAT + '</transform>'
_ANIM_CAM = ('<animation name="toWorld"><transform>' + _LOOKAT +
             '</transform><transform><lookat target="0, 0, 0" '
             'origin="0, -5, 2" up="0, 0, 1"/></transform></animation>')
_ANIM_SHAPE = ('<animation name="toWorld"><transform><translate z="0"/>'
               '</transform><transform><translate z="1"/></transform>'
               '</animation>')
_ENV_ANIM = ('<emitter type="envmap"><string name="filename" value="sky.exr"/>'
             '<animation name="toWorld"><transform><rotate x="1" angle="90"/>'
             '</transform><transform><rotate x="1" angle="80"/></transform>'
             '</animation></emitter>')
_MALA = '<dpt><boolean name="mala" value="true"/>{}</dpt>'


@pytest.mark.parametrize('case, words', [
    (dict(toworld=_ANIM_SHAPE), 'moving geometry'),
    (dict(cam=_ANIM_CAM), 'camera motion'),
    (dict(extra=_ENV_ANIM), 'env map motion'),
    (dict(dpt=_MALA.format(
        '<boolean name="largestepmultiplexed" value="true"/>')),
     'multiplexed large steps'),
    (dict(dpt=_MALA.format('<boolean name="samplecache" value="true"/>')),
     'cache-seeded large steps'),
    (dict(dpt=_MALA.format(
        '<boolean name="uselightcoordinatesampling" value="true"/>')),
     'light-coordinate sampling'),
    (dict(dpt='<dpt><string name="integrator" value="mcmc"/></dpt>'),
     'isotropic-only small steps'),
])
def test_unported_features_still_raise(open_xml, tmp_path, case, words):
    """Each feature the port once cut now parses and sets what the JAX
    parser sets: the options, has_motion, both keyframes of the camera,
    the env map and the triangles."""
    d = os.path.dirname(open_xml)
    for f in ('floor.obj', 'sky.exr'):
        os.symlink(os.path.join(d, f), tmp_path / f)
    kw = dict(dpt=_MALA.format(''), cam=_CAM, extra='', toworld='')
    kw.update(case)
    xml = tmp_path / 'scene.xml'
    xml.write_text(_SCENE_HEAD.format(**kw))
    host, opts, _ = parse_scene_host(str(xml))
    js, jo, _ = jax_parse(str(xml))
    assert dataclasses.asdict(opts) == dataclasses.asdict(jo)
    assert host['has_motion'] == js.has_motion
    for k in ('tri_p', 'tri_n', 'env_to_world_t', 'env_to_world_q',
              'env_to_light_q'):
        np.testing.assert_allclose(np.asarray(host[k], np.float64),
                                   np.asarray(getattr(js, k), np.float64),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    for k in ('c2w_trans', 'c2w_quat', 'w2c_quat'):
        np.testing.assert_allclose(np.asarray(host['camera'][k]),
                                   np.asarray(getattr(js.camera, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    moving = lambda a: not np.allclose(np.asarray(a)[0], np.asarray(a)[1])
    if words == 'moving geometry':
        assert host['has_motion'] and moving(host['tri_p'])
    elif words == 'camera motion':
        assert moving(host['camera']['c2w_quat'])
    elif words == 'env map motion':
        assert moving(host['env_to_world_q'])
    elif words == 'isotropic-only small steps':
        assert opts.integrator == 'mcmc' and not (opts.mala or opts.h2mc)
    else:
        assert getattr(opts, _PORTED_SINCE[words]) and opts.mala


_PORTED_SINCE = {'multiplexed large steps': 'large_step_multiplexed',
                 'cache-seeded large steps': 'sample_from_global_cache',
                 'light-coordinate sampling':
                 'use_light_coordinate_sampling'}


def test_ported_features_parse(open_xml):
    """The point light, the env map, both textures (inline and by id) and
    the rough dielectric of the open scene parse without raising."""
    ts, opts, _ = parse_scene(open_xml, device='cpu')
    assert opts.mala and ts.num_tris > 0


def test_nested_emitter_of_any_type_is_an_area_light(open_xml, tmp_path):
    """An <emitter> nested in a <shape> is an area light whatever its
    type, as the JAX parser takes it: a quad with a nested point emitter
    gives the JAX package's light arrays and triangle light ids."""
    d = os.path.dirname(open_xml)
    os.symlink(os.path.join(d, 'floor.obj'), tmp_path / 'floor.obj')
    nested = ('<emitter type="point"><rgb name="radiance" '
              'value="3, 2, 1"/></emitter>')
    xml = tmp_path / 'scene.xml'
    xml.write_text(_SCENE_HEAD.format(dpt=_MALA.format(''), cam=_CAM,
                                      extra='', toworld=nested))
    host, _, _ = parse_scene_host(str(xml))
    js, _, _ = jax_parse(str(xml))
    assert host['light_type'].tolist() == [LIGHT_AREA] and js.num_lights == 1
    np.testing.assert_array_equal(host['light_emission'], [[3, 2, 1]])
    for k in ('light_type', 'light_emission', 'light_weight', 'light_cdf',
              'light_tri', 'light_tri_cdf', 'light_ntri', 'light_inv_area',
              'tri_light'):
        np.testing.assert_array_equal(np.asarray(host[k]),
                                      np.asarray(getattr(js, k)),
                                      err_msg=k)
    assert (np.asarray(host['tri_light']) == 0).all()
