"""Ray/triangle intersection over the whole scene (port of ops/intersect.py).

* ``intersect_bruteforce`` — Moller-Trumbore over every triangle; exact,
  the test oracle, and the query of every moving scene: each (ray,
  triangle) pair tests the triangle's vertices lerped between the two
  keyframes at the ray's time. CUDA tensors launch the hand kernel of
  ``csrc/brute.cu``; CPU tensors run its plain version,
  ``_bruteforce_block`` over the live rays.
* ``intersect_matmul`` — the JAX package's XLA matmul sweep: keyframe-0
  Woop frames (``SceneData.isect_B/C/ok``) against every ray as two
  ``torch.matmul`` products a 1024-triangle chunk; plain torch, no kernel.
* ``make_intersect_fns`` — the backend switch of the queries: an attached
  BVH (``ops/bvh.py``), the chunk walk (``ops/chunkwalk.py``), the culled
  sweep (``ops/sweep_isect.py``), the matmul sweep or brute force; each
  kernel launches for CUDA tensors and runs its plain torch version for
  CPU tensors.
* triangle rows (packed keyframe-0 rows on a static scene, rows lerped at
  the lane's time on a moving one), hit attributes and the frozen-triangle
  replay intersection used under differentiation.
"""

import os
from functools import partial

import numpy as np
import torch

from ..utils import vecmath as vm
from . import cuda_build
from .graphs import launch_counter

TRI_CHUNK = 1024
# ray-triangle pairs one block of the plain brute force holds: a moving
# scene materialises [rays, TRI_CHUNK, 3, 3] lerped vertices a block
PAIR_BLOCK = 1 << 22
# rays a block of the brute-force kernel (csrc/brute.cu kRays, also the
# triangles of a tile: brute_tiles.TILE), the CTAs its tile ranges aim at
# (a query of the large step's few thousand rays still fills the H100's
# 132 SMs; chip_smoke.py times S at 65,536 and 4,260 rays) and the most
# tiles one range may hold (kMaxTiles)
BRUTE_RAYS = 128
BRUTE_CTAS = 4096
BRUTE_MAX_TILES = 512
# rays of one block of the matmul sweep: each 1024-triangle chunk makes two
# [rays, 3072] f32 products, 0.8 GB at this many rays, so a chunk's
# temporaries stay near 1.3 GB at the flagship's 65,536-ray queries (two
# blocks) and a captured step's pool does not grow by more
MATMUL_RAYS = 1 << 15

# launches of the brute-force kernel, per variant; the plain version never
# counts
launch_counts = launch_counter(('closest_hit', 'any_hit'))


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


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
    """Batched ray-triangle test through torch's cross product and sum,
    as the JAX package's (jnp.cross, jnp.sum). Returns (t, u, v,
    divisor). The frozen replay and the matmul sweep's u, v use it, and
    the kernels' plain versions use tri_test_ordered: the replay in the
    kernels' order misses JAX's at rtol 1e-5 (one shading normal in
    1,410, 6.1e-5 relative, tests/test_torch_motion_intersect.py
    test_hit_geometry_and_frozen_triangle_match_jax), and no kernel
    built with --fmad=false rounds as this form does."""
    s1 = vm.cross(d, e2)
    divisor = vm.dot(s1, e1)
    inv_div = 1.0 / vm.clamp_abs(divisor)
    s = org - p0
    u = vm.dot(s, s1) * inv_div
    s2 = vm.cross(s, e1)
    v = vm.dot(d, s2) * inv_div
    t = vm.dot(e2, s2) * inv_div
    return t, u, v, divisor


def _cross(a, b):
    """a x b over the last axis, each product and difference rounded on
    its own (csrc/tri.cuh's order). Returns the three components."""
    return (a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0])


def _dot(a, b):
    """a . b summed left to right; a, b tuples of 3 components."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cols(x):
    return x[..., 0], x[..., 1], x[..., 2]


def tri_test_ordered(org, d, p0, e1, e2):
    """moller_trumbore (broadcasting [..., 3] operands) with every product
    and sum rounded on its own in the order of the kernels' test
    (csrc/tri.cuh tri_test_edges): the test of the brute-force and BVH
    kernels' plain versions, equal to the kernels bit for bit (torch's
    cross product and sum round in another order, and on the CPU its
    cross fuses a product into the difference; moller_trumbore says why
    both forms stay). Returns (t, u, v, divisor)."""
    s1 = _cross(d, e2)
    divisor = _dot(s1, _cols(e1))
    clamped = torch.where(torch.abs(divisor) < 1e-12,
                          torch.where(divisor < 0,
                                      torch.full_like(divisor, -1e-12),
                                      torch.full_like(divisor, 1e-12)),
                          divisor)
    inv_div = 1.0 / clamped
    s = org - p0
    u = _dot(_cols(s), s1) * inv_div
    s2 = _cross(s, e1)
    v = _dot(_cols(d), s2) * inv_div
    t = _dot(_cols(e2), s2) * inv_div
    return t, u, v, divisor


def intersect_bruteforce(scene, org, d, time, min_t, max_t):
    """Closest hit over all triangles. org/d [R,3]; time, min_t, max_t [R].
    Returns (hit, tri_id, t, u, v). A hit is the smallest t; a tie goes to
    the first triangle within a chunk of TRI_CHUNK and to the earlier chunk
    across chunks: the smallest id among the minimal t. Only live rays
    (max_t >= min_t: no other can hit) are tested. CUDA tensors launch the
    brute-force kernel (csrc/brute.cu; no host read, so a captured step
    holds the query as graph nodes); CPU tensors run the plain version
    over the live rays, gathered into blocks of PAIR_BLOCK // TRI_CHUNK
    rays. Like the kernel backends, the query is not differentiated."""
    args = [x.detach() for x in (org, d, time, min_t, max_t)]
    if org.is_cuda:
        t, tid, u, v = brute_force(scene, *args, any_hit=False)
    else:
        t, tid, u, v = _bruteforce_live(scene, *args)
    hit = torch.isfinite(t)
    return hit, tid, torch.where(hit, t, torch.zeros_like(t)), u, v


def occluded_bruteforce(scene, org, d, time, min_t, max_t):
    """Any-hit query; returns bool [R]: the closest hit's hit set (the
    kernel stops each ray at its first hit)."""
    if org.is_cuda:
        return brute_force(scene, *(x.detach() for x in
                                     (org, d, time, min_t, max_t)),
                           any_hit=True)
    return intersect_bruteforce(scene, org, d, time, min_t, max_t)[0]


def _bruteforce_live(scene, org, d, time, min_t, max_t):
    """The plain version over every ray: _bruteforce_block over the live
    rays, gathered on the host. Returns (t, tri_id, u, v), t = inf and
    the rest 0 where nothing is hit."""
    R = org.shape[0]
    dev = org.device
    best_t = torch.full((R,), float('inf'), device=dev)
    best_id = torch.zeros(R, dtype=torch.int32, device=dev)
    best_u = torch.zeros(R, device=dev)
    best_v = torch.zeros(R, device=dev)
    live = torch.nonzero(max_t >= min_t)[:, 0]
    rb = max(PAIR_BLOCK // TRI_CHUNK, 1)
    with torch.no_grad():
        for r0 in range(0, live.numel(), rb):
            lanes = live[r0:r0 + rb]
            out = _bruteforce_block(scene, org[lanes], d[lanes], time[lanes],
                                    min_t[lanes], max_t[lanes])
            for full, part in zip((best_t, best_id, best_u, best_v), out):
                full[lanes] = part
    return best_t, best_id, best_u, best_v


def _bruteforce_block(scene, org, d, time, min_t, max_t):
    """intersect_bruteforce's scan over the triangle chunks for one block
    of rays (the kernel's plain version; tri_test_ordered, on vm.lerp's
    vertices on a moving scene). Returns (t, tri_id, u, v), t = inf where
    nothing is hit."""
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
        t, u, v, divisor = tri_test_ordered(o, dd, p0, e1, e2)
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


def brute_splits(num_rays, num_tris):
    """S, the tile ranges of the brute-force kernel: about BRUTE_CTAS
    CTAs at any ray count, at most BRUTE_MAX_TILES tiles a range, none
    empty."""
    tiles = max(-(-num_tris // BRUTE_RAYS), 1)
    blocks = max(-(-num_rays // BRUTE_RAYS), 1)
    s = max(-(-BRUTE_CTAS // blocks), -(-tiles // BRUTE_MAX_TILES))
    return max(1, min(s, tiles))


def brute_force(scene, org, d, time, min_t, max_t, any_hit, splits=None):
    """The brute-force kernel (csrc/brute.cu) on CUDA tensors: (t, id, u,
    v) per ray (t = inf, the rest 0 where nothing is hit) or, with
    any_hit, occluded (bool); counted once in launch_counts, and no
    host read. splits: the tile ranges S (default brute_splits; the
    answer does not depend on it). Reads scene.brute, the tables of
    scene.tri_p (ops/brute_tiles.py; build_scene builds them for a moving
    scene, and for a static one when LMCMC_ISECT_BACKEND=brute); raises
    without them or on tables of other triangles, on inputs the kernel
    does not take and on a failed launch."""
    bt = scene.brute
    if bt is None or bt.tri_p is not scene.tri_p:
        raise ValueError('scene.brute does not hold the tables of '
                         'scene.tri_p: build them (brute_tiles.attach)')
    dev = org.device
    R, T = org.shape[0], scene.num_tris
    K = bt.tiles.shape[0]
    nb = bt.screen.shape[0]
    rows = 6 if bt.motion else 3
    check = cuda_build.check
    check(scene.tri_p, 'tri_p', torch.float32, (2, T, 3, 3), dev)
    check(bt.tris, 'tris', torch.float32, (K * BRUTE_RAYS, rows, 4), dev)
    check(bt.screen, 'screen', torch.float32, (nb, K * BRUTE_RAYS, 4), dev)
    check(bt.tiles, 'tiles', torch.float32, (K, 3, 4), dev)
    check(bt.bands, 'bands', torch.float32, (nb, K, 4, 4), dev)
    if bt.motion != scene.has_motion or T < 1:
        raise ValueError(f'brute tables of motion={bt.motion} for a scene '
                         f'of motion={scene.has_motion}, {T} triangles')
    org, d, time, min_t, max_t = (x.contiguous() for x in
                                  (org, d, time, min_t, max_t))
    check(org, 'org', torch.float32, (R, 3), dev)
    check(d, 'dir', torch.float32, (R, 3), dev)
    for x, name in ((time, 'time'), (min_t, 'min_t'), (max_t, 'max_t')):
        check(x, name, torch.float32, (R,), dev)
    S = brute_splits(R, T) if splits is None else splits
    if not 1 <= S <= K or S * BRUTE_MAX_TILES < K:
        raise ValueError(f'{S} tile ranges of {K} tiles')
    if any_hit:
        flags = torch.zeros(R, dtype=torch.int32, device=dev)
        part = res = (None,) * 4
    else:
        flags = None
        res = (torch.empty(R, dtype=torch.float32, device=dev),
               torch.empty(R, dtype=torch.int32, device=dev),
               torch.empty(R, dtype=torch.float32, device=dev),
               torch.empty(R, dtype=torch.float32, device=dev))
        # the ranges' partials; the kernel writes res itself when S = 1
        part = [torch.empty((S if S > 1 else 0, R), dtype=x.dtype,
                            device=dev) for x in res]
    ptr = lambda x: None if x is None else x.data_ptr()
    err = cuda_build.load_library().brute_force(
        *map(ptr, (bt.tris, bt.screen, bt.tiles, bt.bands, scene.tri_p)),
        T, K, nb, bt.kappa, bt.mu,
        *map(ptr, (org, d, time, min_t, max_t)), R, S,
        int(bt.motion), int(any_hit), *map(ptr, part), *map(ptr, res),
        ptr(flags), cuda_build.stream_of(dev))
    cuda_build.raise_on_error(err, f'brute_force (any_hit={any_hit})')
    launch_counts['any_hit' if any_hit else 'closest_hit'] += 1
    # bit 0: a finite hit; bit 1: one at t = -inf (then the least t is
    # not finite: no hit)
    return flags == 1 if any_hit else res


def intersect_matmul(scene, org, d, time, min_t, max_t):
    """Closest hit by the JAX package's matmul sweep: per 1024-triangle
    chunk, O = org @ Bc - Cc and Q = d @ Bc (torch.matmul, TF32 off) map
    the rays into each triangle's Woop frame (keyframe 0:
    scene.isect_B/C/ok), t = -O_w / Q_w (Q_w == 0 divides by 1e-12 and
    fails the test), u = O_u + t Q_u, v = O_v + t Q_v. A tie goes to the
    first triangle within a chunk and to the earlier chunk across chunks.
    u and v are recomputed for the winner by moller_trumbore on
    keyframe-0 vertices; a miss gives t, u, v 0 and id 0. time is
    ignored, as in the JAX package: a moving scene is intersected at
    keyframe 0. The rays go in blocks of MATMUL_RAYS; the
    last chunk is cut at T rather than padded (a padded triangle never
    wins). No host read: a captured step holds the query as graph nodes.
    Returns (hit, tri_id, t, u, v)."""
    T = scene.num_tris
    B3 = scene.isect_B.reshape(3, T, 3)
    C3 = scene.isect_C.reshape(T, 3)
    ok_tri = scene.isect_ok
    R = org.shape[0]
    dev = org.device
    t_out = torch.empty(R, device=dev)
    id_out = torch.empty(R, dtype=torch.int32, device=dev)
    for r0 in range(0, R, MATMUL_RAYS):
        o, dd = org[r0:r0 + MATMUL_RAYS], d[r0:r0 + MATMUL_RAYS]
        mn = min_t[r0:r0 + MATMUL_RAYS, None]
        mx = max_t[r0:r0 + MATMUL_RAYS, None]
        n = o.shape[0]
        rows = torch.arange(n, device=dev)
        best_t = torch.full((n,), float('inf'), device=dev)
        best_id = torch.zeros(n, dtype=torch.int32, device=dev)
        for s in range(0, T, TRI_CHUNK):
            e = min(s + TRI_CHUNK, T)
            Bc = B3[:, s:e].reshape(3, -1)
            O = (o @ Bc - C3[s:e].reshape(-1)).reshape(n, e - s, 3)
            Q = (dd @ Bc).reshape(n, e - s, 3)
            qw = Q[..., 2]
            t = -O[..., 2] / torch.where(qw == 0.0, torch.full_like(qw, 1e-12),
                                         qw)
            u = O[..., 0] + t * Q[..., 0]
            v = O[..., 1] + t * Q[..., 1]
            hit_ok = ((qw != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                      & (t >= mn) & (t <= mx) & ok_tri[None, s:e])
            t = torch.where(hit_ok, t, torch.full_like(t, float('inf')))
            amin = torch.argmin(t, 1)
            ct = t[rows, amin]
            better = ct < best_t
            best_t = torch.where(better, ct, best_t)
            best_id = torch.where(better, (amin + s).to(torch.int32),
                                  best_id)
        t_out[r0:r0 + n] = best_t
        id_out[r0:r0 + n] = best_id
    hit = torch.isfinite(t_out)
    tp = scene.tri_p[0][id_out.long()]
    _, u, v, _ = moller_trumbore(org, d, tp[:, 0], tp[:, 1] - tp[:, 0],
                                 tp[:, 2] - tp[:, 0])
    zero = torch.zeros_like(t_out)
    return (hit, id_out, torch.where(hit, t_out, zero),
            torch.where(hit, u, zero), torch.where(hit, v, zero))


def occluded_matmul(scene, org, d, time, min_t, max_t):
    """The closest hit's hit set (the JAX package's occluded_matmul runs
    the closest hit too: its any_hit flag is ignored)."""
    return intersect_matmul(scene, org, d, time, min_t, max_t)[0]


BACKENDS = ('', 'chunkwalk', 'pallas', 'brute', 'matmul')


def make_intersect_fns(scene):
    """Return (intersect, occluded) for the backend LMCMC_ISECT_BACKEND
    names, read on each call as the JAX package's switch reads it, in its
    order: a scene with a BVH attached (ops/bvh.attach_bvh, static or
    moving) takes the BVH when the variable is unset; 'matmul' the matmul
    sweep (keyframe-0 tables, so a moving scene is intersected at
    keyframe 0, as in the JAX package); 'brute', or any scene with moving
    shapes, brute force (the walk tables hold keyframe 0 only); 'pallas'
    the culled sweep (the JAX package's Pallas sweep, ported as
    ops/sweep_isect.py); '' or 'chunkwalk' the chunk walk (its resident
    form when the pack is at most LMC_CW_VMEM_BYTES bytes).
    Two differences from the JAX switch: '' on the CPU takes the chunk
    walk's plain version, where the JAX package takes its matmul sweep
    (the port's CPU tests of the kernels' plain versions stand on it);
    and a name outside BACKENDS is refused, where the JAX package falls
    through to its default."""
    backend = os.environ.get('LMCMC_ISECT_BACKEND', '')
    if backend not in BACKENDS:
        raise ValueError(f'LMCMC_ISECT_BACKEND={backend!r}: the backends '
                         f'are {", ".join(map(repr, BACKENDS[1:]))} (unset: '
                         f'the default)')
    if scene.use_bvh and backend == '':
        from .bvh import intersect_bvh, occluded_bvh
        return (partial(intersect_bvh, scene), partial(occluded_bvh, scene))
    if backend == 'matmul':
        return (partial(intersect_matmul, scene),
                partial(occluded_matmul, scene))
    if backend == 'brute' or scene.has_motion:
        return (partial(intersect_bruteforce, scene),
                partial(occluded_bruteforce, scene))
    if backend == 'pallas':
        from .sweep_isect import intersect_sweep, occluded_sweep
        return (partial(intersect_sweep, scene),
                partial(occluded_sweep, scene))
    from .chunkwalk import (intersect_chunkwalk, occluded_chunkwalk,
                            use_resident)
    resident = use_resident(scene.cw.pack)
    return (partial(intersect_chunkwalk, scene, resident=resident),
            partial(occluded_chunkwalk, scene, resident=resident))


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
