"""The port's scene parser against the JAX parser.

Host-built tables (Woop frames, chunk-walk pack, chunk AABBs) must match
bitwise: both packages build them with the same float64 numpy code. The
other SceneData arrays must match within 1e-6 (they are parsed, converted
to f32 and carried over unchanged)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.ops import chunkwalk as jax_cw
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.scene.parse import parse_scene, parse_scene_host
from langevin_mcmc_tpu_torch.scene.scenedata import HOST_FIELDS, build_scene
from torch_parity import LCBOX, to_np

torch.set_num_threads(1)

BITWISE = ('isect_B', 'isect_C', 'isect_ok')


@pytest.fixture(scope='module')
def small_xml(tmp_path_factory):
    return testscenes.write_scene(str(tmp_path_factory.mktemp('small')),
                                  small=True, width=64, height=48,
                                  max_depth=4)


@pytest.fixture(scope='module', params=['lcbox', 'small'])
def both(request, small_xml):
    xml = LCBOX if request.param == 'lcbox' else small_xml
    js, jo, jname = jax_parse(xml)
    host, opts, name = parse_scene_host(xml)
    return js, jo, jname, host, opts, name


def test_scene_arrays_match_jax(both):
    js, jo, jname, host, opts, name = both
    assert dataclasses.asdict(opts) == dataclasses.asdict(jo)
    assert name == jname
    for k in HOST_FIELDS:
        want = np.asarray(getattr(js, k))
        got = np.asarray(host[k])
        assert got.shape == want.shape, k
        if k in BITWISE:
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got.astype(np.float64),
                                       want.astype(np.float64), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    for k, v in host['camera'].items():
        np.testing.assert_allclose(np.asarray(v, np.float64),
                                   np.asarray(getattr(js.camera, k),
                                              np.float64),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert host['num_lights'] == js.num_lights


def test_chunkwalk_tables_bitwise(both):
    js, _, _, host, _, _ = both
    pack_j, lo_j, hi_j, T, K = jax_cw._prep_tables(js)
    cw = build_scene(host, 'cpu').cw
    pack = to_np(cw.pack)
    np.testing.assert_array_equal(pack[:, :13], pack_j[:, :13])
    # the JAX package keeps the ids as f32 in row 13; the port as int32
    ids_j = pack_j[:, 13].astype(np.int64)
    np.testing.assert_array_equal(to_np(cw.ids).astype(np.int64), ids_j)
    np.testing.assert_array_equal(to_np(cw.chunk_lo), lo_j)
    np.testing.assert_array_equal(to_np(cw.chunk_hi), hi_j)
    assert pack.shape == (K, 16, 128) and T == js.num_tris


def test_generated_scene_sizes(tmp_path):
    """The flagship torus is 192 x 64 x 2 triangles (about 193 chunks with
    the box and light); the small one stays in the 600-2,000 range."""
    v, t = testscenes.torus_mesh(*testscenes.TORUS_SEGMENTS)
    assert t.shape == (24576, 3) and v.shape == (192 * 64, 3)
    xml = testscenes.write_scene(str(tmp_path), small=True)
    host = parse_scene_host(xml)[0]
    assert 600 <= host['tri_p'].shape[1] <= 2000


_CUT = {
    # features the port once cut; every one is ported since and now parses
    # (see test_cut_features_raise)
    'roughdielectric BSDF': '<shape type="obj"><string name="filename" '
    'value="f.obj"/><bsdf type="roughdielectric"/></shape>',
    'bitmap textures': '<texture type="bitmap" id="t"><string '
    'name="filename" value="t.exr"/></texture>',
    'point emitters': '<emitter type="point"/>',
    'envmap emitters': '<emitter type="envmap"><string name="filename" '
    'value="t.exr"/></emitter>',
    'moving geometry': '<shape type="obj"><string name="filename" '
    'value="f.obj"/><animation name="toWorld"><transform><translate '
    'z="0"/></transform><transform><translate z="1"/></transform>'
    '</animation></shape>',
    # an MCMC block with neither MALA nor H2MC
    'isotropic-only small steps': '<dpt><string name="integrator" '
    'value="mcmc"/></dpt>',
    'multiplexed large steps': '<dpt><boolean name="mala" value="true"/>'
    '<boolean name="largestepmultiplexed" value="true"/></dpt>',
    'light-coordinate sampling': '<dpt><boolean name="mala" value="true"/>'
    '<boolean name="uselightcoordinatesampling" value="true"/></dpt>',
}


@pytest.mark.parametrize('feature', sorted(_CUT))
def test_cut_features_raise(tmp_path, feature):
    """A feature the port once cut parses, in a scene with a sensor and a
    quad, and sets what the JAX parser sets: the options, has_motion, the
    triangles of both keyframes and the light count."""
    from langevin_mcmc_tpu_torch.utils.image_io import write_exr
    xml = os.path.join(tmp_path, 's.xml')
    testscenes._write_obj(os.path.join(tmp_path, 'f.obj'),
                          *testscenes._FLOOR)
    write_exr(os.path.join(tmp_path, 't.exr'),
              np.full((4, 8, 3), 0.5, np.float32))
    with open(xml, 'w') as f:
        f.write('<scene version="0.5.0"><dpt><boolean name="mala" '
                'value="true"/></dpt><sensor type="perspective">'
                '<film type="hdrfilm"><integer name="width" value="8"/>'
                '<integer name="height" value="6"/></film></sensor>'
                f'{_CUT[feature]}<shape type="obj"><string name="filename" '
                'value="f.obj"/></shape></scene>')
    scene, opts, _ = parse_scene(xml, device='cpu')
    js, jo, _ = jax_parse(xml)
    assert scene.num_tris == js.num_tris >= 2
    assert scene.num_lights == js.num_lights
    assert scene.has_motion == js.has_motion
    assert dataclasses.asdict(opts) == dataclasses.asdict(jo)
    np.testing.assert_allclose(to_np(scene.tri_p), np.asarray(js.tri_p),
                               rtol=1e-6, atol=1e-6)
    if feature == 'moving geometry':
        assert scene.has_motion
    if feature == 'isotropic-only small steps':
        assert opts.integrator == 'mcmc' and not (opts.mala or opts.h2mc)
