"""The matmul intersection backend (ops/intersect.py intersect_matmul /
occluded_matmul, LMCMC_ISECT_BACKEND=matmul) and its Woop tables against
the JAX package.

* intersect_matmul / occluded_matmul against JAX's on lcbox, the small
  generated box and the small moving open scene (both packages intersect
  keyframe 0 and ignore the ray's time), with test_torch_intersect.py's
  tolerances for the Woop arithmetic: equal hit sets and triangle ids, t
  within rtol 1e-4 / atol 5e-4 and u, v within atol 2e-3 (XLA and torch
  round the [R, 3] x [3, 3T] products and the u, v recomputation apart);
  occlusion equal to the closest hit's hit set on both sides.
* A scene of 1,030 triangles (not a multiple of the 1024-triangle chunk)
  with exact copies planted within chunk 0 and across the chunk boundary:
  the tie goes to the first copy, as in the JAX package; rays parallel
  to the floor (Q_w == 0 on its triangles) never hit it.
* The port's build_matmul_tables against the JAX package's
  woop_tables_native (atol 1e-5, as tests/test_intersect.py holds the JAX
  package's own tables).
* The backend switch against the JAX package's for every backend name on
  a static, a moving and a BVH-attached scene: each choice the port's
  counterpart of JAX's but for '' on a static scene without a BVH (the
  port's CPU default is the chunk walk's plain version, JAX's the matmul
  sweep); an unknown name is refused.
* Bidirectional generation on lcbox from one tape with
  LMCMC_ISECT_BACKEND=matmul on both sides: test_torch_trace.py's bound
  (rtol 2e-3 a lane, at most 1% of lanes beyond 10x). The diverged share
  is printed beside the share of the port's default (the chunk walk)
  against JAX's matmul sweep, the comparison test_torch_trace.py makes.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.ops import bvh as jbvh
from langevin_mcmc_tpu.ops import intersect as jisect
from langevin_mcmc_tpu.path import trace as jtrace
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.ops import bvh, intersect
from langevin_mcmc_tpu_torch.path import trace
from torch_parity import LCBOX, port_scene, to_np

torch.set_num_threads(1)
R = 600
RTOL, ATOL_T, ATOL_UV = 1e-4, 5e-4, 2e-3
TRACE_RTOL = 2e-3


def _scene_case(name, tmp):
    if name == 'lcbox':
        js = jax_parse(LCBOX)[0]
    else:
        js = jax_parse(testscenes.write_scene(
            str(tmp), small=True, width=64, height=48, max_depth=3,
            scene='box' if name == 'small' else 'open',
            motion=name == 'motion'))[0]
    return js, port_scene(js)


@pytest.fixture(scope='module', params=['lcbox', 'small', 'motion'])
def case(request, tmp_path_factory):
    js, ts = _scene_case(request.param, tmp_path_factory.mktemp('s'))
    assert js.has_motion == (request.param == 'motion')
    return request.param, js, ts


def _rays(tri_p0, n, seed):
    """Rays leaving random points of random triangles (keyframe 0) in
    random directions, 30% dead (max_t = 0 < min_t), at random times.
    min_t = 1e-2 keeps the grazing self-hits of curved meshes, whose f32
    t is noise, out of the comparison."""
    rng = np.random.default_rng(seed)
    tri = rng.integers(0, tri_p0.shape[0], n)
    b = rng.dirichlet((1.0, 1.0, 1.0), n)
    org = np.einsum('rk,rkc->rc', b, tri_p0[tri])
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    time = rng.random(n)
    mn = np.full(n, 1e-2)
    mx = np.where(rng.random(n) < 0.7, np.inf, 0.0)
    return [x.astype(np.float32) for x in (org, d, time, mn, mx)]


def _port(ts, rays):
    with torch.no_grad():
        t = [torch.as_tensor(x) for x in rays]
        return ([to_np(x) for x in intersect.intersect_matmul(ts, *t)],
                to_np(intersect.occluded_matmul(ts, *t)))


def _jax(js, rays):
    j = [jnp.asarray(x) for x in rays]
    return ([np.asarray(x) for x in jax.jit(
        lambda *r: jisect.intersect_matmul(js, *r))(*j)],
            np.asarray(jax.jit(lambda *r: jisect.occluded_matmul(js, *r))(
                *j)))


def _assert_matches(got, want):
    (hp, ip, tp, up, vp), occ = got
    (hj, ij, tj, uj, vj), occ_j = want
    np.testing.assert_array_equal(hp, hj)
    np.testing.assert_array_equal(ip[hp], ij[hj])
    np.testing.assert_allclose(tp[hp], tj[hj], rtol=RTOL, atol=ATOL_T)
    np.testing.assert_allclose(up[hp], uj[hj], atol=ATOL_UV)
    np.testing.assert_allclose(vp[hp], vj[hj], atol=ATOL_UV)
    # a miss is t, u, v 0 and id 0 on both sides
    for x in (ip, tp, up, vp):
        assert not x[~hp].any()
    np.testing.assert_array_equal(occ, hp)
    np.testing.assert_array_equal(occ_j, hj)


def test_matmul_matches_jax(case):
    name, js, ts = case
    rays = _rays(np.asarray(js.tri_p)[0], R, seed=3)
    got, want = _port(ts, rays), _jax(js, rays)
    dead = rays[4] < rays[3]
    assert not got[0][0][dead].any()
    assert got[0][0].sum() > R // 4, f'{name}: too few hits'
    _assert_matches(got, want)


def test_matmul_ignores_time_and_blocks(case, monkeypatch):
    """The answer depends neither on the rays' times (keyframe 0 on a
    moving scene, as in the JAX package) nor on the ray block."""
    _, js, ts = case
    rays = _rays(np.asarray(js.tri_p)[0], R, seed=4)
    want = _port(ts, rays)
    rays[2] = np.zeros_like(rays[2])
    monkeypatch.setattr(intersect, 'MATMUL_RAYS', 7)
    got = _port(ts, rays)
    for a, b in zip(got[0] + [got[1]], want[0] + [want[1]]):
        np.testing.assert_array_equal(a, b)


def _with_triangles(js, ts, tri_p0):
    """The JAX and port scenes with static triangles tri_p0 [T, 3, 3] and
    their Woop tables (what intersect_matmul reads)."""
    tp = np.stack([tri_p0, tri_p0]).astype(np.float32)
    B, C, ok = jisect.build_matmul_tables(tp[0])
    T = tp.shape[1]
    jn = dataclasses.replace(js, tri_p=jnp.asarray(tp), isect_B=B,
                             isect_C=C, isect_ok=ok, num_tris=T)
    B, C, ok = intersect.build_matmul_tables(tp[0])
    tn = dataclasses.replace(
        ts, tri_p=torch.as_tensor(tp), isect_B=torch.as_tensor(B),
        isect_C=torch.as_tensor(C), isect_ok=torch.as_tensor(ok),
        num_tris=T)
    return jn, tn


def test_matmul_planted_ties_and_parallel_rays():
    """lcbox's 12 triangles, filler triangles far below the box up to
    T = 1030, a copy of triangle A at id 1024 (chunk 1) and of triangle B
    at id 20 (chunk 0). Rays onto A's and B's interiors hit the first
    copy (the earlier chunk wins; within a chunk the first triangle), on
    both sides. Rays along x and y (the floor and ceiling lie in z
    planes) have Q_w == 0 exactly on those and hit only walls."""
    js = jax_parse(LCBOX)[0]
    ts = port_scene(js)
    tp0 = np.asarray(js.tri_p)[0].astype(np.float64)
    T0, T = tp0.shape[0], 1030
    filler = (np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float64)
              + np.array([0, 0, -100.0]))
    tris = np.concatenate([tp0, np.repeat(filler[None], T - T0, 0)])
    tris[T0:, :, 0] += 2.0 * np.arange(T - T0)[:, None]
    a, b = 2, 7
    tris[1024], tris[20] = tp0[a], tp0[b]
    jn, tn = _with_triangles(js, ts, tris)

    rng = np.random.default_rng(9)
    n = 400
    tri = np.where(np.arange(n) < n // 2, a, b)
    bc = rng.uniform(0.15, 0.4, (n, 2))
    v = tris[tri]
    p = v[:, 0] + bc[:, :1] * (v[:, 1] - v[:, 0]) + bc[:, 1:] * (
        v[:, 2] - v[:, 0])
    nrm = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    side = np.where(rng.random((n, 1)) < 0.5, -1.0, 1.0)
    org_t, d_t = p + 0.5 * side * nrm, -side * nrm
    # rays parallel to the floor and ceiling, from inside the box
    m = 200
    org_p = rng.uniform([-4, -4, 0.5], [4, 4, 5.5], (m, 3))
    d_p = np.eye(3)[rng.integers(0, 2, m)] * np.where(
        rng.random((m, 1)) < 0.5, -1.0, 1.0)
    rays = [np.concatenate(x).astype(np.float32) for x in (
        (org_t, org_p), (d_t, d_p), (np.zeros(n), np.zeros(m)),
        (np.full(n, 1e-4), np.full(m, 1e-4)),
        (np.full(n, np.inf), np.full(m, np.inf)))]
    got, want = _port(tn, rays), _jax(jn, rays)
    _assert_matches(got, want)
    hit, ids = got[0][0], got[0][1]
    assert hit[:n].all()
    np.testing.assert_array_equal(ids[:n], tri)

    # Q_w == 0 exactly for the parallel rays on every z-plane triangle
    B = to_np(tn.isect_B).reshape(3, T, 3)[:, :, 2]
    qw = rays[1][n:] @ B
    flat = np.abs(nrm_z := np.cross(tris[:, 1] - tris[:, 0],
                                    tris[:, 2] - tris[:, 0]))[:, 2] > 0
    planes = flat & (np.abs(tris[:, :, 2] - tris[:, :1, 2]).max(1) == 0)
    planes[T0:] = False
    assert planes.sum() >= 4
    assert (qw[:, planes] == 0.0).all()
    assert hit[n:].all()
    assert not np.isin(ids[n:], np.nonzero(planes)[0]).any()
    del nrm_z


def test_native_woop_tables():
    """The port's build_matmul_tables against the JAX package's
    woop_tables_native (atol 1e-5, as tests/test_intersect.py holds the
    JAX package's own tables)."""
    from langevin_mcmc_tpu.native import woop_tables_native
    js = jax_parse(LCBOX)[0]
    rng = np.random.default_rng(2)
    tri = np.concatenate([np.asarray(js.tri_p)[0],
                          rng.normal(size=(1500, 3, 3)) * 3.0,
                          np.zeros((2, 3, 3))]).astype(np.float32)
    want = woop_tables_native(tri)
    if want is None:
        pytest.skip("the JAX package's native library is unavailable")
    B, C, ok = intersect.build_matmul_tables(tri)
    assert [a.dtype for a in (B, C, ok)] == [a.dtype for a in want]
    np.testing.assert_allclose(B, want[0], atol=1e-5)
    np.testing.assert_allclose(C, want[1], atol=1e-5)
    np.testing.assert_array_equal(ok, want[2])
    assert not ok[-2:].any() and ok[:-2].all()


# the port's counterpart of each JAX query function
COUNTERPART = {'intersect_pallas': 'intersect_sweep'}


@pytest.fixture(scope='module')
def switch_scenes(tmp_path_factory):
    out = {}
    for name in ('small', 'motion'):
        js, ts = _scene_case(name, tmp_path_factory.mktemp(name))
        out[name] = (js, ts)
    js, ts = out['small']
    out['bvh'] = (jbvh.attach_bvh(js), bvh.attach_bvh(ts))
    return out


@pytest.mark.parametrize('backend', ['', 'chunkwalk', 'pallas', 'brute',
                                     'matmul'])
@pytest.mark.parametrize('kind', ['small', 'motion', 'bvh'])
def test_switch_matches_jax(switch_scenes, monkeypatch, backend, kind):
    js, ts = switch_scenes[kind]
    monkeypatch.setenv('LMCMC_ISECT_BACKEND', backend)
    monkeypatch.delenv('LMC_CW_VMEM_BYTES', raising=False)
    jf, jo = jisect.make_intersect_fns(js)
    tf, to = intersect.make_intersect_fns(ts)
    want = COUNTERPART.get(jf.func.__name__, jf.func.__name__)
    if backend == '' and kind == 'small':
        # the documented difference: the port's CPU default
        assert (jf.func.__name__, tf.func.__name__) == (
            'intersect_matmul', 'intersect_chunkwalk')
    else:
        assert tf.func.__name__ == want
    assert to.func.__name__ == tf.func.__name__.replace('intersect',
                                                        'occluded')
    if backend == 'matmul':
        assert tf.func is intersect.intersect_matmul


def test_switch_refuses_unknown_names(switch_scenes, monkeypatch):
    for name in ('mxu', 'MATMUL', 'bvh'):
        monkeypatch.setenv('LMCMC_ISECT_BACKEND', name)
        for _, ts in switch_scenes.values():
            with pytest.raises(ValueError, match=repr(name)):
                intersect.make_intersect_fns(ts)


SLOTS = ('ls_score', 'ss_score', 'mis_weight', 'contrib', 'screen_pos')
INT_RECORDS = ('cam_tri', 'lgt_tri', 'cam_nee_light', 'cam_nee_lprim',
               'lgt_light_id', 'lgt_lprim', 'cam_use_abs', 'lgt_use_abs')


def _diverged(tcon, trec, jcon, jrec, B):
    """Lanes whose integer records differ or some contribution slot is
    beyond 10x the trace tests' rtol."""
    tflat, jflat = tcon.flatten()[0], jcon.flatten()[0]
    bad = np.zeros(B, bool)
    for k in SLOTS:
        g = to_np(tflat[k]).astype(np.float64).reshape(B, -1)
        w = np.asarray(jflat[k]).astype(np.float64).reshape(B, -1)
        rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-9 / TRACE_RTOL)
        bad |= rel.max(1) > 10 * TRACE_RTOL
    for k in INT_RECORDS:
        bad |= (to_np(getattr(trec, k)) != np.asarray(getattr(jrec, k))
                ).reshape(B, -1).any(1)
    return bad


def test_generation_under_matmul_matches_jax(monkeypatch, capsys):
    js, jo, _ = jax_parse(LCBOX)
    D = 4
    jo = jo.replace(max_depth=D)
    ts = port_scene(js)
    B = 512
    u = np.random.default_rng(5).random((B, jtrace.Tape.size(D)),
                                        dtype=np.float32)
    monkeypatch.setenv('LMCMC_ISECT_BACKEND', 'matmul')
    jrec, jcon, _, _ = jax.jit(lambda u: jtrace.generate_path_bidir(
        js, jo, jtrace.Tape(u, D), min_depth=-1, max_depth=D))(
            jnp.asarray(u))
    shares = {}
    for backend in ('matmul', ''):
        monkeypatch.setenv('LMCMC_ISECT_BACKEND', backend)
        with torch.no_grad():
            trec, tcon, _, _ = trace.generate_path_bidir(
                ts, jo, trace.Tape(torch.as_tensor(u), D), min_depth=-1,
                max_depth=D)
        bad = _diverged(tcon, trec, jcon, jrec, B)
        shares[backend or 'chunkwalk'] = bad.mean()
        if backend == 'matmul':
            assert bad.sum() <= B // 100, f'{bad.sum()} of {B} lanes diverge'
    with capsys.disabled():
        print(f'\ngeneration on lcbox, {B} lanes, against JAX under matmul: '
              f'diverged share {shares["matmul"]:.4f} with the port under '
              f'matmul, {shares["chunkwalk"]:.4f} with the port\'s chunk '
              f'walk')
