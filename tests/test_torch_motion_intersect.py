"""Ray queries, hit geometry and light sampling on a moving scene (the
small generated open scene with --motion: the torus and the quad light
turn and move, the env map turns) in the port against the JAX package, on
the same seeded numpy rays, times and sample parameters.

The JAX package answers every query of a moving scene by brute force on
the CPU too, so the two packages compute the same Moller-Trumbore tests on
the same lerped vertices:
* closest hit and any hit: the hit sets and triangle ids equal on all but
  1% of the rays (a ray through a shared edge or a vertex can take either
  triangle: XLA and torch round the lerp and the test apart), t within
  rtol 1e-5 on 99% of the others and 1e-4 on all, the barycentrics u and
  v within 1e-4 (they are differences of products ~15x larger than
  themselves, so f32 rounding moves them by up to ~5e-5); dead rays never
  hit;
* the port's brute force gives the same answer bit for bit whatever its
  block of ray-triangle pairs (PAIR_BLOCK), and on a static scene it
  agrees with the chunk walk's plain version (hits and ids on 99% of the
  rays, t within rtol 1e-5);
* hit attributes at the ray's time, the frozen-triangle intersection
  (the port's frozen_from_row of the row at time against JAX's
  intersect_frozen_triangle) and the triangle vertices at time: rtol
  1e-5;
* area-light sampling of the moving quad (sample_tri, its inverse
  get_sample_param, sample_direct, emit), and the turning env map's
  sampling and emission at time: rtol 1e-5 per lane, at most 1% of lanes
  beyond (an env CDF bin).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.ops import intersect as jisect
from langevin_mcmc_tpu.ops import lights as jlights
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.ops import intersect, lights
from langevin_mcmc_tpu_torch.scene.scenedata import LIGHT_AREA, LIGHT_ENV
from torch_parity import port_scene, to_np, assert_close_most

torch.set_num_threads(1)
R = 600
RTOL = 1e-5
# u and v are differences of products ~|org - p0| / |edge| times larger
# than themselves: an f32 rounding of the vertices (XLA contracts the lerp
# into an fma, torch does not) moves them by up to ~5e-5
BARY_ATOL = 1e-4


@pytest.fixture(scope='module')
def case(tmp_path_factory):
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('motion')),
                                 small=True, width=64, height=48,
                                 max_depth=3, scene='open', motion=True)
    js, jo, _ = jax_parse(xml)
    assert js.has_motion
    ts = port_scene(js)
    rng = np.random.default_rng(31)
    time = rng.random(R).astype(np.float32)
    # rays from random points around the scene aimed at a random point of
    # a random triangle at the ray's time: most hit, some graze
    tri = rng.integers(0, js.num_tris, R)
    tp = np.asarray(js.tri_p, np.float64)
    tt = time[:, None, None].astype(np.float64)
    verts = (1 - tt) * tp[0, tri] + tt * tp[1, tri]
    b = rng.dirichlet((1.0, 1.0, 1.0), R)
    aim = np.einsum('rk,rkc->rc', b, verts)
    org = aim + rng.normal(size=(R, 3)) * 3.0
    d = aim - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mn = np.full(R, 1e-4)
    mx = np.full(R, np.inf)
    mx[::7] = 0.0                                   # dead rays
    mx[1::11] = rng.random(len(mx[1::11])) * 2.0    # short rays
    rays = [x.astype(np.float32) for x in (org, d, time, mn, mx)]
    return js, jo, ts, rays


def _jax_isect(js, rays):
    return [np.asarray(x) for x in jax.jit(
        lambda *r: jisect.intersect_bruteforce(js, *r))(
            *(jnp.asarray(x) for x in rays))]


def _port_isect(ts, rays):
    with torch.no_grad():
        return [to_np(x) for x in intersect.intersect_bruteforce(
            ts, *(torch.as_tensor(x) for x in rays))]


def test_bruteforce_matches_jax(case):
    js, _, ts, rays = case
    jh, jid, jt, ju, jv = _jax_isect(js, rays)
    th, tid, tt, tu, tv = _port_isect(ts, rays)
    dead = rays[4] < rays[3]
    assert not th[dead].any() and not jh[dead].any()
    assert jh.sum() > R // 2
    same = (jh == th) & (~jh | (jid == tid))
    assert (~same).sum() <= R // 100, f'{(~same).sum()} rays differ'
    m = same & jh
    rel = np.abs(tt[m] - jt[m]) / np.abs(jt[m])
    assert (rel > RTOL).mean() <= 0.01 and rel.max() < 10 * RTOL, \
        f't: {(rel > RTOL).sum()} hits beyond rtol, max {rel.max():.3g}'
    for got, want in ((tu, ju), (tv, jv)):
        np.testing.assert_allclose(got[m], want[m], rtol=0, atol=BARY_ATOL)
    with torch.no_grad():
        occ = to_np(intersect.occluded_bruteforce(
            ts, *(torch.as_tensor(x) for x in rays)))
    jocc = np.asarray(jax.jit(lambda *r: jisect.occluded_bruteforce(
        js, *r))(*(jnp.asarray(x) for x in rays)))
    assert (occ != jocc).sum() <= R // 100


@pytest.mark.parametrize('pairs', [1, 3 * intersect.TRI_CHUNK,
                                   64 * intersect.TRI_CHUNK])
def test_bruteforce_blocks_do_not_change_the_answer(case, monkeypatch,
                                                    pairs):
    _, _, ts, rays = case
    want = _port_isect(ts, rays)
    monkeypatch.setattr(intersect, 'PAIR_BLOCK', pairs)
    for a, b in zip(_port_isect(ts, rays), want):
        np.testing.assert_array_equal(a, b)


def test_static_bruteforce_agrees_with_the_walk(case, tmp_path):
    """The same rays on the scene without motion: brute force (Moller-
    Trumbore) and the chunk walk's plain version (Woop frames) find the
    same hits and triangles but on 1% of the rays, t within rtol 1e-5."""
    from langevin_mcmc_tpu_torch.ops import chunkwalk
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    xml = testscenes.write_scene(str(tmp_path), small=True, width=64,
                                 height=48, max_depth=3, scene='open')
    ss = parse_scene(xml, device='cpu')[0]
    assert not ss.has_motion
    rays = [torch.as_tensor(x) for x in case[3]]
    with torch.no_grad():
        bh, bid, bt, _, _ = intersect.intersect_bruteforce(ss, *rays)
        wh, wid, wt, _, _ = chunkwalk.intersect_chunkwalk(ss, *rays)
    same = (bh == wh) & (~bh | (bid == wid))
    assert (~same).sum() <= R // 100 and bh.sum() > R // 4
    m = same & bh
    np.testing.assert_allclose(to_np(bt[m]), to_np(wt[m]), rtol=RTOL)


def test_hit_geometry_and_frozen_triangle_match_jax(case):
    js, _, ts, rays = case
    jh, jid, jt, ju, jv = _jax_isect(js, rays)
    org, d, time = (jnp.asarray(x) for x in rays[:3])
    m = np.nonzero(jh)[0]
    args = (jnp.asarray(jid[m]), org[m], d[m], jnp.asarray(jt[m]),
            jnp.asarray(ju[m]), jnp.asarray(jv[m]), time[m])
    jout = jax.jit(lambda *a: jisect.hit_attrs_full(js, *a))(*args)
    targs = [torch.as_tensor(np.asarray(a)) for a in args]
    targs[0] = targs[0].long()
    with torch.no_grad():
        tout = intersect.hit_attrs_full(ts, *targs)
    for k, (a, b) in enumerate(zip(tout, jout)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=RTOL,
                                   atol=1e-6, err_msg=f'output {k}')
    tri_j, time_j = args[0], args[6]
    jtp = jisect.tri_vertices_at_time(js, tri_j, time_j)
    jtn = jisect.tri_normals_at_time(js, tri_j, time_j)
    ttp = intersect.tri_vertices_at_time(ts, targs[0], targs[6])
    ttn = intersect.tri_normals_at_time(ts, targs[0], targs[6])
    np.testing.assert_allclose(to_np(ttp), np.asarray(jtp), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(to_np(ttn), np.asarray(jtn), rtol=RTOL,
                               atol=1e-6)
    # the frozen replay's intersection: JAX's intersect_frozen_triangle on
    # the vertices at time, the port's frozen_from_row on the row at time
    jtst = js.tri_st[tri_j]
    jfz = jax.jit(jisect.intersect_frozen_triangle)(jtp, jtn, jtst, args[1],
                                                    args[2])
    with torch.no_grad():
        tfz = intersect.frozen_from_row(
            intersect.gather_tri_row(ts, targs[0], targs[6]), targs[1],
            targs[2])
    for k, (a, b) in enumerate(zip(tfz, jfz)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=RTOL,
                                   atol=1e-5, err_msg=f'frozen output {k}')


def _light_inputs(js, kind, n=256, seed=41):
    rng = np.random.default_rng(seed)
    lid = int(np.nonzero(np.asarray(js.light_type) == kind)[0][0])
    light = np.full(n, lid, np.int32)
    if kind == LIGHT_AREA:
        row = np.asarray(js.light_tri)[lid]
        lprim = row[rng.integers(0, int(js.light_ntri[lid]), n)]
    else:
        lprim = np.zeros(n, np.int32)
    u = rng.random((n, 4)).astype(np.float32)
    time = rng.random(n).astype(np.float32)
    pos = (rng.normal(size=(n, 3)) + [0.0, 0.0, 1.5]).astype(np.float32)
    return light, lprim.astype(np.int32), u, time, pos


def test_area_light_sampling_matches_jax(case):
    js, _, ts, _ = case
    light, lprim, u, time, pos = _light_inputs(js, LIGHT_AREA)
    J = lambda x: jnp.asarray(x)
    T = lambda x: torch.as_tensor(x)
    jpos, jn = jlights._sample_tri(js, J(lprim), J(u[:, :2]), J(time))
    with torch.no_grad():
        tpos, tn = lights.sample_tri(ts, T(lprim), T(u[:, :2]), T(time))
    np.testing.assert_allclose(to_np(tpos), np.asarray(jpos), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(to_np(tn), np.asarray(jn), rtol=RTOL,
                               atol=1e-6)
    # the moving light's samples move with it
    with torch.no_grad():
        p0, _ = lights.sample_tri(ts, T(lprim), T(u[:, :2]),
                                  torch.zeros(len(time)))
    assert (torch.abs(tpos - p0).amax(1) > 1e-3).float().mean() > 0.9
    jpar = jlights.get_sample_param(js, J(lprim), jpos, J(time))
    with torch.no_grad():
        tpar = lights.get_sample_param(ts, T(lprim), tpos, T(time))
    np.testing.assert_allclose(to_np(tpar), np.asarray(jpar), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(to_np(tpar), u[:, :2], atol=1e-3)
    jdir = jax.jit(lambda *a: jlights.sample_direct(js, *a))(
        J(light), J(lprim), J(u[:, :2]), J(pos), J(time))
    jem = jax.jit(lambda *a: jlights.emit(js, *a))(
        J(light), J(lprim), J(u[:, :2]), J(u[:, 2:]), J(time))
    with torch.no_grad():
        tdir = lights.sample_direct(ts, T(light), T(lprim), T(u[:, :2]),
                                    T(pos), T(time))
        tem = lights.emit(ts, T(light), T(lprim), T(u[:, :2]), T(u[:, 2:]),
                          T(time))
    for name, got, want in (('sample_direct', tdir, jdir),
                            ('emit', tem, jem)):
        for k, v in got.items():
            assert_close_most(to_np(v), np.asarray(want[k]), RTOL,
                              atol=1e-6, err_msg=f'{name} {k}')


def test_turning_env_map_matches_jax(case):
    js, _, ts, _ = case
    light, _, u, time, pos = _light_inputs(js, LIGHT_ENV, seed=43)
    J = lambda x: jnp.asarray(x)
    T = lambda x: torch.as_tensor(x)
    assert not np.allclose(np.asarray(js.env_to_world_q)[0],
                           np.asarray(js.env_to_world_q)[1])
    jl, jd, jv, jp = jax.jit(lambda *a: jlights.env_sample_direction(
        js, *a))(J(u[:, :2]), J(time))
    with torch.no_grad():
        tl, td, tv, tp = lights.env_sample_direction(ts, T(u[:, :2]),
                                                     T(time))
    assert (to_np(tl) != np.asarray(jl)).sum() <= len(time) // 100
    for got, want in ((td, jd), (tv, jv), (tp, jp)):
        assert_close_most(to_np(got), np.asarray(want), RTOL, atol=1e-6,
                          err_msg='env_sample_direction')
    # emission of the sampled directions at the same times
    jout = jax.jit(lambda *a: jlights.env_emission(js, *a))(jd, J(time))
    with torch.no_grad():
        tout = lights.env_emission(ts, T(np.asarray(jd)), T(time))
    for got, want in zip(tout, jout):
        assert_close_most(to_np(got), np.asarray(want), RTOL, atol=1e-6,
                          err_msg='env_emission')
    jdir = jax.jit(lambda *a: jlights.sample_direct(js, *a))(
        J(light), J(np.zeros_like(light)), J(u[:, :2]), J(pos), J(time))
    with torch.no_grad():
        tdir = lights.sample_direct(ts, T(light), T(np.zeros_like(light)),
                                    T(u[:, :2]), T(pos), T(time))
    for k, v in tdir.items():
        assert_close_most(to_np(v), np.asarray(jdir[k]), RTOL, atol=1e-6,
                          err_msg=f'env sample_direct {k}')
