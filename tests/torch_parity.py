"""Shared helpers of the tests/test_torch_*.py parity tests: carry a scene
parsed by the JAX package across to the port (langevin_mcmc_tpu_torch),
and compare outputs with bounded divergent-lane counts."""

import dataclasses
import os

import numpy as np
import torch

from langevin_mcmc_tpu_torch import interop

LCBOX = os.path.join(os.path.dirname(__file__), 'data', 'lcbox.xml')


def jax_scene_to_numpy(scene):
    """The JAX SceneData fields the port reads, as numpy arrays."""
    from langevin_mcmc_tpu_torch.scene.scenedata import HOST_FIELDS
    d = {k: np.asarray(getattr(scene, k)) for k in HOST_FIELDS}
    d['num_lights'] = scene.num_lights
    d['env_light_id'] = scene.env_light_id
    d['has_motion'] = scene.has_motion
    d['use_bvh'] = scene.use_bvh
    d['bvh_nodes'] = np.asarray(scene.bvh_nodes)
    d['bvh_prim_ids'] = np.asarray(scene.bvh_prim_ids)
    d['camera'] = {k: np.asarray(getattr(scene.camera, k))
                   for k in interop.CAMERA_FIELDS}
    tex = scene.textures
    d['textures'] = {k: None if getattr(tex, k) is None
                     else np.asarray(getattr(tex, k))
                     for k in interop.TEXTURE_FIELDS}
    return d


def port_scene(jax_scene):
    """The port's SceneData (CPU) built from a JAX-parsed scene."""
    return interop.scene_from_numpy(jax_scene_to_numpy(jax_scene), 'cpu')


def jax_tree_to_numpy(obj):
    """JAX dataclass pytree (PathRecord, Contribs, ChainState, ...) -> dict
    of numpy arrays, recursively."""
    if dataclasses.is_dataclass(obj):
        return {f.name: jax_tree_to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None:
        return None
    return np.asarray(obj)


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_close_most(got, want, rtol, frac=0.01, atol=1e-9, err_msg=''):
    """allclose for all but a bounded number of lanes.

    The two packages run the same f32 formulas through different
    compilers (XLA fuses and reorders; torch rounds op by op), so a few
    lanes sitting exactly on a discrete threshold (BSDF lobe pick, Russian
    roulette, a triangle edge) take the other branch and diverge by orders
    of magnitude. At most floor(frac * n) lanes may differ by more than
    10x rtol (none below 1/frac lanes), and at most max(1, 2% of n) may
    sit between rtol and 10x rtol."""
    got = to_np(got).astype(np.float64).reshape(len(to_np(got)), -1)
    want = to_np(want).astype(np.float64).reshape(len(got), -1)
    rel = (np.abs(got - want) / np.maximum(np.abs(want), atol / rtol)
           ).max(1)
    n = rel.size
    divergent = int((rel > 10 * rtol).sum())
    near_miss = int(((rel > rtol) & (rel <= 10 * rtol)).sum())
    assert divergent <= int(frac * n), (
        f'{err_msg}: {divergent}/{n} lanes diverged (> 10x rtol={rtol}, '
        f'max rel {rel.max():.3g}; allowed {int(frac * n)})')
    assert near_miss <= max(1, int(0.02 * n)), (
        f'{err_msg}: {near_miss}/{n} lanes in (rtol, 10x rtol], rtol={rtol}')


def planted_tie_case(scene, tables=None, n_alive=700, n_dead=300, seed=11):
    """Chunk tables of `scene` (CPU: the chunk walk's scene.cw, the default,
    or the sweep's scene.sweep) with exact ties planted, and rays that hit
    them.

    The first valid triangle of chunk 0, which lies in the chunk's first
    128-triangle tile, is copied, rows and AABB, into another column of
    chunk 0 under the id -2 (in another 128-triangle tile where the chunk
    has several, as the sweep's 512-triangle chunks do) and into column 0
    of the last chunk under the id -3, both smaller than its own id. So its
    closest hit must be the chunk-0 copy with id -2: within a chunk a tie
    of t goes to the smaller id, whichever tile holds it; across chunks the
    earlier chunk wins. n_alive rays run along the triangle's normal, from
    0.01 away on either side, onto points inside it: each is occluded
    within the first tile of chunk 0, the first chunk of its block's list.
    n_dead more rays are dead; the total is not a multiple of 256.
    Returns (pack, ids, chunk_lo, chunk_hi, (org, d, min_t, max_t))."""
    cw = scene.cw if tables is None else tables
    pack, ids = cw.pack.clone(), cw.ids.clone()
    lo, hi = cw.chunk_lo.clone(), cw.chunk_hi.clone()
    last = pack.shape[0] - 1
    valid = torch.nonzero(pack[0, 12] > 0.5)[:, 0]
    a = int(valid[0])
    later = valid[valid >= 128]
    b = int(later[0] if len(later) else valid[1])
    assert a < 128
    pack[0, :, b] = pack[0, :, a]
    ids[0, b] = -2
    pack[last, :, 0] = pack[0, :, a]
    ids[last, 0] = -3
    lo[last] = torch.minimum(lo[last], lo[0])
    hi[last] = torch.maximum(hi[last], hi[0])

    v = scene.tri_p[0][int(cw.ids[0, a])].double().numpy()
    e1, e2 = v[1] - v[0], v[2] - v[0]
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n)
    rng = np.random.default_rng(seed)
    bc = rng.uniform(0.15, 0.45, (n_alive, 2))
    p = v[0] + bc[:, :1] * e1 + bc[:, 1:] * e2
    side = np.where(rng.uniform(size=(n_alive, 1)) < 0.5, -1.0, 1.0)
    org = np.concatenate([p + 0.01 * side * n,
                          rng.normal(size=(n_dead, 3))])
    d = np.concatenate([-side * n, rng.normal(size=(n_dead, 3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mn = np.full(n_alive + n_dead, 1e-4)
    mx = np.concatenate([np.full(n_alive, np.inf), np.zeros(n_dead)])
    rays = tuple(torch.as_tensor(x, dtype=torch.float32)
                 for x in (org, d, mn, mx))
    return pack, ids, lo, hi, rays


def left_chain_nodes(m, T):
    """BVH nodes of a tree of m + 1 levels: m inner nodes down the left
    side, each with a leaf of one triangle (of T) on its right, every box
    around the whole scene, so that a depth-first walk stacks one node a
    level."""
    nodes = np.zeros((2 * m + 1, 8), np.float32)
    nodes[:, 0:3], nodes[:, 3:6] = -1e3, 1e3
    for i in range(m):
        nodes[i, 6] = i + 1
        nodes[i, 7] = -(m + 1 if i == m - 1 else 2 * m - i)
    nodes[m:, 6] = np.arange(m + 1) % T
    nodes[m:, 7] = 1.0
    return torch.as_tensor(nodes)


def with_triangles(scene, tri_p):
    """scene (with a BVH) whose triangles are tri_p [2, T, 3, 3] (numpy),
    with the BVH and kernel tables of those (ops/bvh.attach_bvh)."""
    from langevin_mcmc_tpu_torch.ops import bvh
    return bvh.attach_bvh(dataclasses.replace(
        scene, tri_p=torch.as_tensor(tri_p, device=scene.device),
        num_tris=tri_p.shape[1]))


def coincident_copies(scene, tie, k):
    """scene with k exact copies of triangle `tie` appended (ids T..T+k-1)
    and its BVH rebuilt: the copies share one centroid, so the build
    splits them across leaves. Returns (scene, ids of tie and its
    copies)."""
    tp = scene.tri_p.cpu().numpy()
    T = tp.shape[1]
    sc = with_triangles(scene, np.concatenate([tp] + [tp[:, tie:tie + 1]]
                                              * k, 1))
    return sc, [tie] + list(range(T, T + k))
