"""Ray/triangle intersection of the benchmark's plain reference: a frozen
copy of the port's plain brute force (Moller-Trumbore over every triangle,
the vertices lerped at the ray's time on a moving scene), taken for every
query on every device, with the triangle rows, hit attributes and the
frozen-triangle intersection of the replay. It launches no kernel and
builds no acceleration table.
"""

from functools import partial

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
    the smallest id among the minimal t. Only live rays (max_t >= min_t)
    are tested. The query is not differentiated."""
    args = [x.detach() for x in (org, d, time, min_t, max_t)]
    t, tid, u, v = _bruteforce_live(scene, *args)
    hit = torch.isfinite(t)
    return hit, tid, torch.where(hit, t, torch.zeros_like(t)), u, v


def occluded_bruteforce(scene, org, d, time, min_t, max_t):
    """Any-hit query; returns bool [R]: the closest hit's hit set."""
    return intersect_bruteforce(scene, org, d, time, min_t, max_t)[0]


def make_intersect_fns(scene):
    """(intersect, occluded): the brute force, for every scene."""
    return (partial(intersect_bruteforce, scene),
            partial(occluded_bruteforce, scene))


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
