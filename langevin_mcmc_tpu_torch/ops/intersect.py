"""Ray/triangle intersection over the whole scene (port of ops/intersect.py).

* ``intersect_bruteforce`` — Moller-Trumbore over every triangle in chunks;
  exact, the test oracle, and the query of every moving scene: each
  (ray, triangle) pair tests the triangle's vertices lerped between the
  two keyframes at the ray's time.
* ``make_intersect_fns`` — the backend switch of the queries: an attached
  BVH (``ops/bvh.py``), the chunk walk (``ops/chunkwalk.py``), the culled
  sweep (``ops/sweep_isect.py``) or brute force; each kernel launches for
  CUDA tensors and runs its plain torch version for CPU tensors.
* triangle rows (packed keyframe-0 rows on a static scene, rows lerped at
  the lane's time on a moving one), hit attributes and the frozen-triangle
  replay intersection used under differentiation.
"""

import os
from functools import partial

import numpy as np
import torch

from ..utils import vecmath as vm

TRI_CHUNK = 1024
# ray-triangle pairs one block of the brute force holds: a moving scene
# materialises [rays, TRI_CHUNK, 3, 3] lerped vertices a block
PAIR_BLOCK = 1 << 22


def tri_vertices_at_time(scene, tri_idx, time):
    """Triangle vertices [..., 3, 3] at shutter `time` [...] (keyframe 0
    on a static scene)."""
    p = scene.tri_p
    if scene.has_motion:
        return vm.lerp(time[..., None, None], p[0, tri_idx], p[1, tri_idx])
    return p[0, tri_idx]


def tri_normals_at_time(scene, tri_idx, time):
    n = scene.tri_n
    if scene.has_motion:
        return vm.lerp(time[..., None, None], n[0, tri_idx], n[1, tri_idx])
    return n[0, tri_idx]


def moller_trumbore(org, d, p0, e1, e2):
    """Batched ray-triangle test. Returns (t, u, v, divisor)."""
    s1 = vm.cross(d, e2)
    divisor = vm.dot(s1, e1)
    inv_div = 1.0 / vm.clamp_abs(divisor)
    s = org - p0
    u = vm.dot(s, s1) * inv_div
    s2 = vm.cross(s, e1)
    v = vm.dot(d, s2) * inv_div
    t = vm.dot(e2, s2) * inv_div
    return t, u, v, divisor


def intersect_bruteforce(scene, org, d, time, min_t, max_t):
    """Closest hit over all triangles. org/d [R,3]; time, min_t, max_t [R].
    Returns (hit, tri_id, t, u, v). A hit is the smallest t; a tie goes to
    the first triangle within a chunk of TRI_CHUNK and to the earlier chunk
    across chunks. Only live rays (max_t >= min_t: no other can hit) are
    tested, in blocks of PAIR_BLOCK // TRI_CHUNK rays."""
    R = org.shape[0]
    dev = org.device
    best_t = torch.full((R,), float('inf'), device=dev)
    best_id = torch.zeros(R, dtype=torch.int32, device=dev)
    best_u = torch.zeros(R, device=dev)
    best_v = torch.zeros(R, device=dev)
    live = torch.nonzero(max_t >= min_t)[:, 0]
    rb = max(PAIR_BLOCK // TRI_CHUNK, 1)
    for r0 in range(0, live.numel(), rb):
        lanes = live[r0:r0 + rb]
        out = _bruteforce_block(scene, org[lanes], d[lanes], time[lanes],
                                min_t[lanes], max_t[lanes])
        for full, part in zip((best_t, best_id, best_u, best_v), out):
            full[lanes] = part
    hit = torch.isfinite(best_t)
    return hit, best_id, torch.where(hit, best_t, torch.zeros_like(best_t)), \
        best_u, best_v


def _bruteforce_block(scene, org, d, time, min_t, max_t):
    """intersect_bruteforce's scan over the triangle chunks for one block
    of rays. Returns (t, tri_id, u, v), t = inf where nothing is hit."""
    T = scene.num_tris
    R = org.shape[0]
    dev = org.device
    best_t = torch.full((R,), float('inf'), device=dev)
    best_id = torch.zeros(R, dtype=torch.int32, device=dev)
    best_u = torch.zeros(R, device=dev)
    best_v = torch.zeros(R, device=dev)
    rows = torch.arange(R, device=dev)
    o, dd = org[:, None, :], d[:, None, :]
    for start in range(0, T, TRI_CHUNK):
        end = min(start + TRI_CHUNK, T)
        if scene.has_motion:
            tp = vm.lerp(time[:, None, None, None],
                         scene.tri_p[0, None, start:end],
                         scene.tri_p[1, None, start:end])
            p0 = tp[..., 0, :]
            e1 = tp[..., 1, :] - p0
            e2 = tp[..., 2, :] - p0
        else:
            tp = scene.tri_p[0, start:end]
            p0 = tp[None, :, 0, :]
            e1 = (tp[:, 1, :] - tp[:, 0, :])[None]
            e2 = (tp[:, 2, :] - tp[:, 0, :])[None]
        t, u, v, divisor = moller_trumbore(o, dd, p0, e1, e2)
        ok = ((divisor != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t >= min_t[:, None]) & (t <= max_t[:, None]))
        t = torch.where(ok, t, torch.full_like(t, float('inf')))
        amin = torch.argmin(t, 1)
        ct, cu, cv = t[rows, amin], u[rows, amin], v[rows, amin]
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_id = torch.where(better, (amin + start).to(torch.int32),
                              best_id)
        best_u = torch.where(better, cu, best_u)
        best_v = torch.where(better, cv, best_v)
    return best_t, best_id, best_u, best_v


def occluded_bruteforce(scene, org, d, time, min_t, max_t):
    """Any-hit query; returns bool [R]."""
    return intersect_bruteforce(scene, org, d, time, min_t, max_t)[0]


def make_intersect_fns(scene):
    """Return (intersect, occluded) for the backend LMCMC_ISECT_BACKEND
    names, read on each call as the JAX package's switch reads it. A
    scene with a BVH attached (ops/bvh.attach_bvh, static or moving) takes
    the BVH when the variable is unset. Otherwise '' or 'chunkwalk' the
    chunk walk (its resident form when the pack is at most
    LMC_CW_VMEM_BYTES bytes), 'pallas' the culled sweep (the JAX package's
    Pallas sweep, ported as ops/sweep_isect.py), 'brute' brute force. A
    scene with moving shapes takes brute force whatever the variable names
    (unless a BVH is attached), as in the JAX package: the walk tables
    hold keyframe 0 only. The XLA matmul sweep ('matmul') is not ported."""
    backend = os.environ.get('LMCMC_ISECT_BACKEND', '')
    if backend not in ('', 'chunkwalk', 'pallas', 'brute'):
        raise ValueError(f'LMCMC_ISECT_BACKEND={backend!r}: the port has the '
                         f"backends 'chunkwalk', 'pallas' and 'brute' (the "
                         f'XLA matmul sweep is not ported)')
    if scene.use_bvh and backend == '':
        from .bvh import intersect_bvh, occluded_bvh
        return (partial(intersect_bvh, scene), partial(occluded_bvh, scene))
    if backend == 'brute' or scene.has_motion:
        return (partial(intersect_bruteforce, scene),
                partial(occluded_bruteforce, scene))
    if backend in ('', 'chunkwalk'):
        from .chunkwalk import (intersect_chunkwalk, occluded_chunkwalk,
                                use_resident)
        resident = use_resident(scene.cw.pack)
        return (partial(intersect_chunkwalk, scene, resident=resident),
                partial(occluded_chunkwalk, scene, resident=resident))
    from .sweep_isect import intersect_sweep, occluded_sweep
    return (partial(intersect_sweep, scene), partial(occluded_sweep, scene))


# ---------------------------------------------------------------------------
# per-triangle rows
# ---------------------------------------------------------------------------

def gather_tri_row_raw(scene, tri_id, time=None):
    """One [..., 24] geometry row per triangle, laid out as
    scenedata.build_tri_geom: the packed keyframe-0 row on a static scene;
    on a moving one the row of the vertices and normals lerped at `time`
    [...] (edges from the lerped vertices, as the JAX package's motion
    branches compute them)."""
    if not scene.has_motion:
        return scene.tri_geom[tri_id]
    tp = tri_vertices_at_time(scene, tri_id, time)
    tn = tri_normals_at_time(scene, tri_id, time)
    p0 = tp[..., 0, :]
    return torch.cat([p0, tp[..., 1, :] - p0, tp[..., 2, :] - p0,
                      tn.flatten(-2), scene.tri_st[tri_id].flatten(-2)], -1)


def row_dict_from_raw(row, mat_id=None, light_id=None):
    """Unpack a raw [..., 24] row (gather_tri_row_raw or a bake slice)."""
    return dict(p0=row[..., 0:3], e1=row[..., 3:6], e2=row[..., 6:9],
                tn=row[..., 9:18].reshape(row.shape[:-1] + (3, 3)),
                tst=row[..., 18:24].reshape(row.shape[:-1] + (3, 2)),
                mat_id=mat_id, light_id=light_id)


def gather_tri_row(scene, tri_id, time=None):
    """dict(p0, e1, e2, tn [...,3,3], tst [...,3,2], mat_id, light_id) of
    triangle tri_id at `time` (needed on a moving scene only)."""
    return row_dict_from_raw(gather_tri_row_raw(scene, tri_id, time),
                             scene.tri_mat[tri_id], scene.tri_light[tri_id])


def hit_attrs_from_row(row, org, d, t, u, v):
    """Hit position, shading normal, geometric normal (flipped to the
    shading side) and st from a packed row."""
    geom_n = vm.normalize(vm.cross(row['e1'], row['e2']))
    w = 1.0 - u - v
    position = org + t[..., None] * d
    tn = row['tn']
    shading_n = vm.normalize(w[..., None] * tn[..., 0, :]
                             + u[..., None] * tn[..., 1, :]
                             + v[..., None] * tn[..., 2, :])
    flip = vm.dot(geom_n, shading_n) < 0.0
    geom_n = torch.where(flip[..., None], -geom_n, geom_n)
    sts = row['tst']
    st = (w[..., None] * sts[..., 0, :] + u[..., None] * sts[..., 1, :]
          + v[..., None] * sts[..., 2, :])
    return position, shading_n, geom_n, st


def hit_attrs_full(scene, tri_id, org, d, t, u, v, time):
    """Hit attributes of a confirmed hit, the triangle at the ray's time.
    Returns (pos, shading_n, geom_n, st, mat_id, light_id)."""
    row = gather_tri_row(scene, tri_id, time)
    pos, sn, gn, st = hit_attrs_from_row(row, org, d, t, u, v)
    return pos, sn, gn, st, row['mat_id'], row['light_id']


def frozen_from_row(row, org, d):
    """Differentiable intersection against a known (frozen) triangle: a
    ray/plane solve with no validity checks. Returns
    (position, shading_n, geom_n, st, t)."""
    t, u, v, _ = moller_trumbore(org, d, row['p0'], row['e1'], row['e2'])
    # near-parallel rays (masked lanes, padding steps) give ~1e12 positions
    # whose reverse-mode partials overflow and reach every lane's gradient
    # through the masking wheres
    t = torch.clamp(t, -1e6, 1e6)
    u = torch.clamp(u, -1e3, 1e3)
    v = torch.clamp(v, -1e3, 1e3)
    geom_n = vm.normalize(vm.cross(row['e1'], row['e2']))
    w = 1.0 - u - v
    position = org + t[..., None] * d
    tn = row['tn']
    shading_n = vm.normalize(w[..., None] * tn[..., 0, :]
                             + u[..., None] * tn[..., 1, :]
                             + v[..., None] * tn[..., 2, :])
    # the geomNormal sign fix is not differentiated
    flip = (vm.dot(geom_n, shading_n) < 0.0).detach()
    geom_n = torch.where(flip[..., None], -geom_n, geom_n)
    sts = row['tst']
    st = (w[..., None] * sts[..., 0, :] + u[..., None] * sts[..., 1, :]
          + v[..., None] * sts[..., 2, :])
    return position, shading_n, geom_n, st, t


def build_matmul_tables(tri_p0):
    """Woop inverse frames from [T,3,3] keyframe-0 vertices, in float64
    numpy exactly as the JAX package builds them: (B [3,3T], C [3T],
    valid [T]) as f32/f32/bool host arrays."""
    p0 = np.asarray(tri_p0[:, 0, :], np.float64)
    e1 = np.asarray(tri_p0[:, 1, :], np.float64) - p0
    e2 = np.asarray(tri_p0[:, 2, :], np.float64) - p0
    n = np.cross(e1, e2)
    A = np.stack([e1, e2, n], axis=-1)
    det = np.linalg.det(A)
    ok = np.abs(det) > 1e-18
    A_safe = np.where(ok[:, None, None], A, np.eye(3))
    Ainv = np.linalg.inv(A_safe)
    T_ = p0.shape[0]
    B = np.transpose(Ainv, (2, 0, 1)).reshape(3, T_ * 3)
    C = np.einsum('tij,tj->ti', Ainv, p0).reshape(T_ * 3)
    return B.astype(np.float32), C.astype(np.float32), ok
