"""The BVH backend in the port (ops/bvh.py, csrc/bvh.cu) against the JAX
package:

* build_bvh equals JAX's ops.bvh.build_bvh array for array from the same
  [2, T, 3, 3] vertices, on the small box and the small moving open scene;
* the plain traversal equals JAX's intersect_bvh / occluded_bvh on seeded
  numpy rays, static and moving: hit flags on every lane; t, u, v at rtol
  1e-5 on all but a bounded few lanes (torch_parity.assert_close_most:
  XLA contracts the Moller-Trumbore products into fmas, torch rounds each,
  and t differs by up to ~5e-5 relative on grazing hits); ids on >= 99%
  of the hit lanes (a ray on a shared edge may take either triangle);
* the traversal's wavefront keeps each ray's answer whatever other rays
  are queried with it, and counts the work it did; a tree deeper than
  its stack is refused however it reached the scene;
* pack_bvh and the traversal on a tree of the JAX package's native
  binned-SAH builder (a tree shape build_bvh never makes) give the brute
  force's hits, and scene/mesh.compute_vertex_normals equals the JAX
  package's native vertex normals;
* make_intersect_fns takes the BVH when one is attached and
  LMCMC_ISECT_BACKEND is unset, as JAX's does;
* a short MALA render of the small moving scene with a BVH attached.
The kernel's card test (bit for bit with the plain traversal) is in
test_torch_kernel.py, which runs without JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from langevin_mcmc_tpu import native as jnative
from langevin_mcmc_tpu.ops import bvh as jbvh
from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.integrators import mlt
from langevin_mcmc_tpu_torch.ops import bvh, intersect, tracing
from langevin_mcmc_tpu_torch.scene.mesh import compute_vertex_normals
from torch_parity import assert_close_most, left_chain_nodes, port_scene

torch.set_num_threads(1)
R = 1024


@pytest.fixture(scope='module', params=['static', 'motion'])
def scenes(request, tmp_path_factory):
    """(JAX scene with its BVH, the port's scene with its own BVH) of the
    small box (static) or the small moving open scene."""
    motion = request.param == 'motion'
    kw = dict(scene='open', motion=True) if motion else {}
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('bvh')),
                                 small=True, width=32, height=24,
                                 max_depth=3, **kw)
    js = jax_parse(xml)[0]
    assert js.has_motion == motion
    return jbvh.attach_bvh(js), bvh.attach_bvh(port_scene(js))


def _rays(scene, n, seed):
    """Seeded numpy rays: from near random triangles towards others, a
    fifth with a finite max_t, a tenth dead, random shutter times."""
    rng = np.random.default_rng(seed)
    tp = scene.tri_p[0].numpy()
    T = tp.shape[0]
    org = (tp[rng.integers(0, T, n)].mean(1)
           + rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    d = tp[rng.integers(0, T, n)].mean(1) - org
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    time = rng.random(n).astype(np.float32)
    mn = np.full(n, 1e-2, np.float32)
    mx = np.where(rng.random(n) < 0.2, rng.random(n) * 2.0,
                  np.inf).astype(np.float32)
    mx[rng.random(n) < 0.1] = 0.0
    return org, d, time, mn, mx


def test_build_bvh_matches_jax(scenes):
    js, ts = scenes
    tri_p = np.asarray(js.tri_p)
    nodes, prims = bvh.build_bvh(tri_p)
    jn, jp = jbvh.build_bvh(tri_p)
    np.testing.assert_array_equal(nodes, jn)
    np.testing.assert_array_equal(prims, jp)
    np.testing.assert_array_equal(ts.bvh_nodes.numpy(), jn)
    np.testing.assert_array_equal(ts.bvh_prim_ids.numpy(), jp)
    assert ts.use_bvh and bvh.tree_depth(nodes) <= bvh.STACK_DEPTH
    assert sorted(prims.tolist()) == list(range(tri_p.shape[1]))


def test_traversal_matches_jax(scenes):
    js, ts = scenes
    rays = _rays(ts, R, seed=5)
    hj, ij, tj, uj, vj = (np.asarray(x) for x in jbvh.intersect_bvh(
        js, *(jnp.asarray(x) for x in rays)))
    oj = np.asarray(jbvh.occluded_bvh(js, *(jnp.asarray(x) for x in rays)))
    trays = [torch.as_tensor(x) for x in rays]
    h, i, t, u, v = (x.numpy() for x in bvh.intersect_bvh(ts, *trays))
    o = bvh.occluded_bvh(ts, *trays).numpy()
    np.testing.assert_array_equal(h, hj)
    np.testing.assert_array_equal(o, oj)
    np.testing.assert_array_equal(o, h)
    assert 0.2 * R < h.sum() < R
    for name, a, b in (('t', t, tj), ('u', u, uj), ('v', v, vj)):
        assert_close_most(a[h], b[h], rtol=1e-5, atol=1e-6, err_msg=name)
    assert (i[h] == ij[h]).mean() >= 0.99
    assert (i[~h] == 0).all() and (t[~h] == 0).all()


def test_traversal_is_per_ray_and_counts_work(scenes):
    _, ts = scenes
    rays = [torch.as_tensor(x) for x in _rays(ts, 600, seed=8)]
    tabs = (ts.bvh_nodes, ts.bvh_prim_ids, ts.tri_p)
    stats = {}
    whole = bvh.traverse_reference(*tabs, *rays, False, ts.has_motion,
                                   stats=stats)
    perm = torch.randperm(600, generator=torch.Generator().manual_seed(1))
    half = bvh.traverse_reference(*tabs, *(x[perm[:300]] for x in rays),
                                  False, ts.has_motion)
    for a, b in zip(whole, half):
        assert torch.equal(a[perm[:300]], b)
    live = rays[4] >= rays[3]
    assert (stats['inner'][~live] <= 1).all() and (stats['tests'][~live]
                                                  == 0).all()
    assert stats['inner'][live].float().mean() > 2
    assert stats['tests'][live].float().mean() > 1
    # an occluded ray stops at its first hit: never more work than closest
    occ_stats = {}
    bvh.traverse_reference(*tabs, *rays, True, ts.has_motion,
                           stats=occ_stats)
    assert (occ_stats['tests'] <= stats['tests']).all()
    assert (occ_stats['inner'] <= stats['inner']).all()


def test_traversal_equals_bruteforce_hits(scenes):
    _, ts = scenes
    rays = [torch.as_tensor(x) for x in _rays(ts, R, seed=9)]
    hb, ib, tb, _, _ = intersect.intersect_bruteforce(ts, *rays)
    hv, iv, tv, _, _ = bvh.intersect_bvh(ts, *rays)
    assert torch.equal(hb, hv)
    # both torch, and both run intersect.tri_test_ordered
    np.testing.assert_allclose(tv[hv].numpy(), tb[hb].numpy(), rtol=1e-5)


def _jax_native(result):
    if result is None:
        pytest.skip("the JAX package's native library is unavailable")
    return result


def test_native_bvh_hits_equal_bruteforce(scenes):
    _, ts = scenes
    tp = ts.tri_p.numpy()
    nodes, prims = _jax_native(jnative.build_bvh_native(
        tp.min(axis=(0, 2)), tp.max(axis=(0, 2))))
    assert nodes.dtype == np.float32 and prims.dtype == np.int32
    assert sorted(prims.tolist()) == list(range(ts.num_tris))
    nodes, prims = torch.as_tensor(nodes), torch.as_tensor(prims)
    sn = dataclasses.replace(ts, bvh_nodes=nodes, bvh_prim_ids=prims,
                             bvh_packed=bvh.pack_bvh(nodes, prims, ts.tri_p))
    rays = [torch.as_tensor(x) for x in _rays(ts, 256, seed=13)]
    hb, _, tb, _, _ = intersect.intersect_bruteforce(ts, *rays)
    hv, _, tv, _, _ = bvh.intersect_bvh(sn, *rays)
    assert torch.equal(hb, hv) and hb.any()
    np.testing.assert_allclose(tv[hb].numpy(), tb[hb].numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize('flip', [False, True])
def test_vertex_normals_native(flip):
    verts, idx = testscenes.torus_mesh(24, 12)
    want = _jax_native(jnative.vertex_normals_native(verts, idx, flip))
    got = compute_vertex_normals(verts, idx, flip)
    assert got.shape == verts.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_make_intersect_fns_takes_the_bvh(scenes, monkeypatch):
    _, ts = scenes
    monkeypatch.delenv('LMCMC_ISECT_BACKEND', raising=False)
    fns = intersect.make_intersect_fns(ts)
    assert [f.func for f in fns] == [bvh.intersect_bvh, bvh.occluded_bvh]
    no_bvh = dataclasses.replace(ts, use_bvh=False)
    want = intersect.intersect_bruteforce if ts.has_motion else None
    f = intersect.make_intersect_fns(no_bvh)[0].func
    assert f is not bvh.intersect_bvh
    if want is not None:
        assert f is want
    monkeypatch.setenv('LMCMC_ISECT_BACKEND', 'brute')
    f = intersect.make_intersect_fns(ts)[0].func
    assert f is intersect.intersect_bruteforce


def test_cpu_wrapper_counts_no_launch(scenes):
    _, ts = scenes
    tracing.reset_launches()
    rays = [torch.as_tensor(x) for x in _rays(ts, 128, seed=3)]
    occ = bvh.traverse(ts.bvh_nodes, ts.bvh_prim_ids, ts.tri_p, *rays, True,
                       ts.has_motion)
    assert occ.dtype == torch.bool
    assert not any(bvh.launch_counts.values())


def test_attach_bvh_refuses_a_tree_too_deep(scenes, monkeypatch):
    _, ts = scenes
    monkeypatch.setattr(bvh, 'STACK_DEPTH', 4)
    with pytest.raises(ValueError):
        bvh.attach_bvh(ts)


@pytest.mark.parametrize('extra', [0, 1])
def test_traversal_refuses_a_tree_deeper_than_its_stack(scenes, extra):
    """However a tree reaches the scene (here set by hand, without the
    tables of pack_bvh, which checks too), the traversal checks its depth
    before it walks."""
    _, ts = scenes
    nodes = left_chain_nodes(bvh.STACK_DEPTH - 1 + extra, ts.tri_p.shape[1])
    assert bvh.tree_depth(nodes.numpy()) == bvh.STACK_DEPTH + extra
    scene = dataclasses.replace(ts, bvh_nodes=nodes, bvh_packed=None,
                                use_bvh=True)
    rays = [torch.as_tensor(x) for x in _rays(ts, 64, seed=5)]
    isect, occluded = intersect.make_intersect_fns(scene)
    if extra:
        for fn in (isect, occluded):
            with pytest.raises(ValueError, match='levels'):
                fn(*rays)
    else:
        hit = isect(*rays)[0]
        assert hit.any() and torch.equal(occluded(*rays), hit)


def test_mala_render_moving_scene_with_bvh(tmp_path):
    xml = testscenes.write_scene(str(tmp_path), small=True, width=16,
                                 height=12, max_depth=3, scene='open',
                                 motion=True, num_init_samples=512,
                                 num_chains=64)
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    scene, opts, _ = parse_scene(xml, device='cpu')
    scene = bvh.attach_bvh(scene)
    calls = []
    orig = intersect.intersect_bruteforce
    intersect.intersect_bruteforce = lambda *a: calls.append(1) or orig(*a)
    try:
        with torch.no_grad():
            film, b = mlt.render_mlt(scene, opts,
                                     torch.Generator().manual_seed(0),
                                     num_steps=3, chunk=256)
    finally:
        intersect.intersect_bruteforce = orig
    f = film.numpy()
    assert np.isfinite(f).all() and f.min() >= 0.0 and f.sum() > 0.0
    assert b > 0.0 and not calls
