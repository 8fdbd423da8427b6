"""Two-keyframe motion in the port's parser and scene against the JAX
package, on the small generated box and open scenes with --motion (the
torus and the quad light turn and move, the camera pans, the open scene's
env map turns).

* every host array the port's parser builds equals the JAX SceneData's
  (rtol 1e-6; the Woop tables bit for bit): both keyframes of the
  vertices and normals, the camera's and the env map's two keyframes;
* has_motion is set as the JAX parser sets it, on the scene the port
  builds and through interop; the moving shapes' triangles differ between
  the keyframes, the static ones do not;
* a moving scene routes every ray query to brute force whatever
  LMCMC_ISECT_BACKEND names, as the JAX package does; the port still
  refuses the backend it does not have.
"""

import dataclasses

import numpy as np
import pytest
import torch

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.ops import intersect
from langevin_mcmc_tpu_torch.scene.parse import parse_scene, parse_scene_host
from langevin_mcmc_tpu_torch.scene.scenedata import HOST_FIELDS
from torch_parity import port_scene, to_np

torch.set_num_threads(1)

BITWISE = ('isect_B', 'isect_C', 'isect_ok')


@pytest.fixture(scope='module', params=['box', 'open'])
def moving(request, tmp_path_factory):
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('motion')),
                                 small=True, width=64, height=48,
                                 max_depth=4, scene=request.param,
                                 motion=True)
    js, jo, jname = jax_parse(xml)
    host, opts, name = parse_scene_host(xml)
    return request.param, xml, js, jo, jname, host, opts, name


def test_motion_host_arrays_match_jax(moving):
    _, _, js, jo, jname, host, opts, name = moving
    assert dataclasses.asdict(opts) == dataclasses.asdict(jo)
    assert name == jname
    for k in HOST_FIELDS:
        want = np.asarray(getattr(js, k))
        got = np.asarray(host[k])
        assert got.shape == want.shape, k
        if k in BITWISE:
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


def test_keyframes_and_has_motion(moving):
    kind, xml, js, _, _, host, _, _ = moving
    assert js.has_motion and host['has_motion']
    tp = host['tri_p']
    moved = np.abs(tp[0] - tp[1]).max((1, 2)) > 1e-6
    # the torus and the two light triangles move, the walls / floor and
    # the sphere stay
    torus = 2 * np.prod(testscenes.SMALL_TORUS_SEGMENTS)
    assert moved[:torus].all()
    assert moved.sum() == torus + 2
    # the camera pans: it turns about a fixed origin
    cam = host['camera']
    assert not np.allclose(cam['c2w_quat'][0], cam['c2w_quat'][1])
    np.testing.assert_allclose(cam['c2w_trans'][0], cam['c2w_trans'][1])
    env_moves = not np.allclose(host['env_to_world_q'][0],
                                host['env_to_world_q'][1])
    assert env_moves == (kind == 'open')
    for scene in (parse_scene(xml, device='cpu')[0], port_scene(js)):
        assert scene.has_motion
        assert scene.tri_p.shape == (2,) + tp.shape[1:]
        np.testing.assert_allclose(to_np(scene.tri_p), tp, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize('backend', ['', 'chunkwalk', 'pallas', 'brute'])
def test_moving_scene_routes_to_brute_force(moving, monkeypatch, backend):
    _, xml, _, _, _, _, _, _ = moving
    scene = parse_scene(xml, device='cpu')[0]
    monkeypatch.setenv('LMCMC_ISECT_BACKEND', backend)
    isect, occl = intersect.make_intersect_fns(scene)
    assert isect.func is intersect.intersect_bruteforce
    assert occl.func is intersect.occluded_bruteforce
    # as in the JAX package, 'matmul' is checked before motion: the matmul
    # sweep, at keyframe 0; a name the switch does not know is refused
    monkeypatch.setenv('LMCMC_ISECT_BACKEND', 'matmul')
    isect, occl = intersect.make_intersect_fns(scene)
    assert isect.func is intersect.intersect_matmul
    assert occl.func is intersect.occluded_matmul
    monkeypatch.setenv('LMCMC_ISECT_BACKEND', 'mxu')
    with pytest.raises(ValueError, match='mxu'):
        intersect.make_intersect_fns(scene)
