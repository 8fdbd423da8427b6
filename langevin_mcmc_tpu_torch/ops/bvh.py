"""Flattened BVH: host build and per-ray traversal (port of ops/bvh.py).

A binned-SAH BVH is built on the host (numpy, ``build_bvh``; the C++
build of ``native/`` gives the same layout faster), flattened into one
[N, 8] f32 node array, and traversed per ray with a stack of STACK_DEPTH
node indices. The traversal is the CUDA kernel of ``csrc/bvh.cu`` for
CUDA tensors and its plain torch version ``traverse_reference`` for CPU
tensors; both compute the JAX package's ``_traverse_one`` for every ray.

Node layout (f32 row of 8):
  [0:3] bbox min, [3:6] bbox max,
  [6]   left child index (inner) | first-primitive offset (leaf)
  [7]   > 0: leaf with that many primitives; <= 0: inner, -right child idx

Leaf primitives are contiguous in ``bvh_prim_ids`` order. For two-keyframe
motion, nodes bound the union of both keyframes and every triangle test
lerps the triangle's vertices to the ray's time.

The BVH's tie rule is the first strictly closer hit in its depth-first
order (right child pushed before the left, so the left is visited first);
the chunk walk's and the brute force's differ, so ``make_intersect_fns``
takes the BVH only when one is attached, as the JAX package does.

The kernel does not read the nodes: it walks the tables of ``pack_bvh``
(``PackedBVH``), built once per tree on the tree's device by
``attach_bvh`` (and ``build_scene`` for a scene that carries a BVH), which
also refuses a tree deeper than the stack. The tables keep the node tensor
they were packed from, and the traversal takes them only with that very
tensor, so a tree swapped into a scene without its tables raises:
  records [M, 16] f32, one an inner node, in breadth-first order:
        [0:6] the left child's box, [6:12] the right child's (both bit
        for bit nodes[child][0:6]), [12] / [13] the left / right child's
        reference (int32 bits), [14:16] zero;
  tris  [2, T, 3, 4] f32, tri_p[:, prim_ids] (leaf order), vertices as
        stored (not p0, e1, e2: one layout for static and moving scenes),
        lane 3 of vertex 0 the triangle's id (int32 bits).
A reference >= 0 is an inner node's record; < 0 is a leaf, ~ref =
first << 3 | count, its triangles tris[:, first:first + count].
"""

import dataclasses

import numpy as np
import torch

from . import cuda_build
from .graphs import launch_counter
from .intersect import tri_test_ordered

MAX_LEAF = 4
N_BUCKETS = 12
STACK_DEPTH = 64

# launches of the CUDA kernel, per variant; the plain version never counts
launch_counts = launch_counter(('closest_hit', 'any_hit'))


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def build_bvh(tri_p):
    """Build from [2, T, 3, 3] keyframe triangle vertices.

    Returns (nodes [N,8] float32, prim_ids [T] int32).
    Binned-SAH sweep, iterative with an explicit stack.
    """
    T = tri_p.shape[1]
    lo = tri_p.min(axis=(0, 2))   # [T, 3] over keyframes & corners
    hi = tri_p.max(axis=(0, 2))
    centers = 0.5 * (lo + hi)

    nodes = []
    order = np.arange(T)
    stack = [(order, -1, False)]  # (ids, parent_node, is_right)
    out_prims = []

    while stack:
        ids, parent, is_right = stack.pop()
        node_id = len(nodes)
        if parent >= 0:
            if is_right:
                nodes[parent][7] = -float(node_id)
            else:
                nodes[parent][6] = float(node_id)
        nlo = lo[ids].min(0)
        nhi = hi[ids].max(0)
        n = len(ids)
        if n <= MAX_LEAF:
            first = len(out_prims)
            out_prims.extend(ids.tolist())
            nodes.append([*nlo, *nhi, float(first), float(n)])
            continue

        c = centers[ids]
        cmin, cmax = c.min(0), c.max(0)
        axis = int(np.argmax(cmax - cmin))
        extent = cmax[axis] - cmin[axis]
        if extent <= 1e-12:
            # degenerate: split in half by order
            mid = n // 2
        else:
            # binned SAH
            b = np.minimum(((c[:, axis] - cmin[axis]) / extent * N_BUCKETS)
                           .astype(np.int32), N_BUCKETS - 1)
            counts = np.bincount(b, minlength=N_BUCKETS)
            bucket_lo = np.full((N_BUCKETS, 3), np.inf)
            bucket_hi = np.full((N_BUCKETS, 3), -np.inf)
            for k in range(3):
                np.minimum.at(bucket_lo[:, k], b, lo[ids][:, k])
                np.maximum.at(bucket_hi[:, k], b, hi[ids][:, k])

            def area(l, h):
                d = np.maximum(h - l, 0.0)
                return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                              + d[..., 2] * d[..., 0])

            # prefix/suffix sweeps
            pre_lo = np.minimum.accumulate(bucket_lo, 0)
            pre_hi = np.maximum.accumulate(bucket_hi, 0)
            suf_lo = np.minimum.accumulate(bucket_lo[::-1], 0)[::-1]
            suf_hi = np.maximum.accumulate(bucket_hi[::-1], 0)[::-1]
            pre_cnt = np.cumsum(counts)
            suf_cnt = np.cumsum(counts[::-1])[::-1]
            costs = np.full(N_BUCKETS - 1, np.inf)
            for s in range(N_BUCKETS - 1):
                if pre_cnt[s] == 0 or suf_cnt[s + 1] == 0:
                    continue
                costs[s] = (area(pre_lo[s], pre_hi[s]) * pre_cnt[s]
                            + area(suf_lo[s + 1], suf_hi[s + 1])
                            * suf_cnt[s + 1])
            s = int(np.argmin(costs))
            if not np.isfinite(costs[s]):
                mid = n // 2
                ids = ids[np.argsort(c[:, axis], kind='stable')]
            else:
                left_mask = b <= s
                ids = np.concatenate([ids[left_mask], ids[~left_mask]])
                mid = int(left_mask.sum())
                if mid == 0 or mid == n:
                    mid = n // 2
        if extent <= 1e-12:
            ids = ids[np.argsort(c[:, axis], kind='stable')]

        nodes.append([*nlo, *nhi, 0.0, 0.0])  # children patched later
        # push right first so left is processed next (contiguous DFS order)
        stack.append((ids[mid:], node_id, True))
        stack.append((ids[:mid], node_id, False))

    nodes = np.asarray(nodes, np.float32)
    prim_ids = np.asarray(out_prims, np.int32)
    return nodes, prim_ids


def tree_depth(nodes):
    """Levels of the flattened tree (1 for a root leaf)."""
    depth = np.zeros(len(nodes), np.int64)
    depth[0] = 1
    for i, row in enumerate(nodes):     # children follow their parent
        if row[7] <= 0.0:
            for c in (int(row[6]), int(-row[7])):
                depth[c] = depth[i] + 1
    return int(depth.max())


def _refuse_depth(depth):
    """Raise for a tree of more levels than the traversal's stack holds
    entries: a depth-first walk of a d-level tree holds at most d."""
    if depth > STACK_DEPTH:
        raise ValueError(f'BVH of {depth} levels or more; the traversal '
                         f'stack holds {STACK_DEPTH}')


def check_depth(nodes):
    """Raise when the tree of nodes (a tensor) is too deep for the
    traversal's stack."""
    _refuse_depth(tree_depth(nodes.cpu().numpy()))


@dataclasses.dataclass
class PackedBVH:
    """The tables the traversal kernel walks (pack_bvh; layout in the
    module's docstring)."""
    records: torch.Tensor   # [M, 16] f32, the inner nodes breadth first
    tris: torch.Tensor      # [2, T, 3, 4] f32, leaf-ordered triangles
    root: int               # the root's reference
    nodes: torch.Tensor     # the [N, 8] nodes packed (the traversal's tie)
    depth: int              # the tree's levels, at most STACK_DEPTH


def leaf_ref(first, count):
    """The reference of a leaf (ints or int64 tensors)."""
    return ~((first << 3) | count)


def pack_bvh(nodes, prim_ids, tri_p):
    """The kernel's tables of a flattened tree (nodes [N, 8], prim_ids [T]
    int32, tri_p [2, T, 3, 3]), built with torch on the tree's device.
    Every box and vertex is copied bit for bit. Raises for a tree deeper
    than the traversal's stack."""
    dev = nodes.device
    T = prim_ids.shape[0]
    if T >= 1 << 28:
        raise ValueError(f'{T} triangles: a leaf reference holds < 2^28')
    leaf = nodes[:, 7] > 0.0
    left = nodes[:, 6].long()
    right = (-nodes[:, 7]).long()
    # breadth-first order of the inner nodes, a level a round
    levels = []
    frontier = torch.zeros(1, dtype=torch.int64, device=dev)
    while True:
        frontier = frontier[~leaf[frontier]]
        if frontier.numel() == 0:
            break
        levels.append(frontier)
        # the inner levels and the leaves below the deepest of them
        _refuse_depth(len(levels) + 1)
        frontier = torch.stack([left[frontier], right[frontier]],
                               1).reshape(-1)
    order = torch.cat(levels) if levels else torch.zeros(
        0, dtype=torch.int64, device=dev)
    rec_of = torch.full((nodes.shape[0],), -1, dtype=torch.int64,
                        device=dev)
    rec_of[order] = torch.arange(order.numel(), device=dev)
    ref = torch.where(leaf, leaf_ref(left, nodes[:, 7].long()), rec_of)
    bits = nodes.contiguous().view(torch.int32)
    lc, rc = left[order], right[order]
    records = torch.cat(
        [bits[lc, 0:6], bits[rc, 0:6], ref[lc, None].int(),
         ref[rc, None].int(),
         torch.zeros((order.numel(), 2), dtype=torch.int32, device=dev)],
        1).view(torch.float32)
    tp = tri_p[:, prim_ids.long()].contiguous().view(torch.int32)
    lane = torch.zeros(tp.shape[:3] + (1,), dtype=torch.int32, device=dev)
    lane[:, :, 0, 0] = prim_ids.int()
    tris = torch.cat([tp, lane], -1).view(torch.float32)
    return PackedBVH(records=records, tris=tris,
                     root=int(ref[0]) if bool(leaf[0]) else 0,
                     nodes=nodes, depth=len(levels) + 1)


def attach_bvh(scene):
    """The scene with a BVH built by build_bvh over both keyframes of its
    triangles, on its device, its kernel tables (pack_bvh) and use_bvh
    set. Raises when the tree is too deep for the traversal (pack_bvh)."""
    nodes, prim_ids = build_bvh(scene.tri_p.cpu().numpy())
    nodes = torch.as_tensor(nodes, device=scene.device)
    prim_ids = torch.as_tensor(prim_ids, device=scene.device)
    return dataclasses.replace(
        scene, bvh_nodes=nodes, bvh_prim_ids=prim_ids,
        bvh_packed=pack_bvh(nodes, prim_ids, scene.tri_p), use_bvh=True)


# ---------------------------------------------------------------------------
# the traversal: plain version
# ---------------------------------------------------------------------------

def _tri_test(tri_p, pid, org, d, time, has_motion):
    """ops/intersect.tri_test_ordered against triangles pid at the rays'
    time (the kernel's order). Returns (t, u, v, divisor)."""
    if has_motion:
        tm = time[:, None, None]
        tp = (1.0 - tm) * tri_p[0][pid] + tm * tri_p[1][pid]
    else:
        tp = tri_p[0][pid]
    p0 = tp[:, 0]
    return tri_test_ordered(org, d, p0, tp[:, 1] - p0, tp[:, 2] - p0)


def _ray_box(inv_d, org, node, t_min, t_max):
    """Slab test of rays against node boxes [n, 8]: near <= far, with NaN
    propagating through the min / max as torch propagates it."""
    t0 = (node[:, 0:3] - org) * inv_d
    t1 = (node[:, 3:6] - org) * inv_d
    near = torch.maximum(torch.amax(torch.minimum(t0, t1), -1), t_min)
    far = torch.minimum(torch.amin(torch.maximum(t0, t1), -1), t_max)
    return near <= far


def traverse_reference(nodes, prim_ids, tri_p, org, d, time, min_t, max_t,
                       any_hit, has_motion, stats=None):
    """Plain torch version of the traversal kernel: each ray keeps
    _traverse_one's state (a stack of STACK_DEPTH node ids, the root
    pushed at sp = 1; the best (t, id, u, v)), and each round pops one
    node of every ray still walking, tests a leaf's triangles (strict t <
    best t) or pushes an inner node's hit children (right first), then
    drops the rays that are done (empty stack; with any_hit, a hit).

    Returns (t, id, u, v) per ray, t = inf and id 0 where nothing is hit,
    or, with any_hit, the best t (finite where occluded). stats: optional
    dict that receives per-ray int64 counts 'inner' (inner nodes visited),
    'leaves' (leaves visited) and 'tests' (triangles tested)."""
    R = org.shape[0]
    dev = org.device
    T = prim_ids.shape[0]
    inv_d = 1.0 / torch.where(d == 0.0, torch.full_like(d, 1e-20), d)
    stack = torch.zeros((R, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.ones(R, dtype=torch.int64, device=dev)
    best_t = torch.full((R,), float('inf'), device=dev)
    best_id = torch.zeros(R, dtype=torch.int32, device=dev)
    best_u = torch.zeros(R, device=dev)
    best_v = torch.zeros(R, device=dev)
    inner = torch.zeros(R, dtype=torch.int64, device=dev)
    leaves = torch.zeros(R, dtype=torch.int64, device=dev)
    tests = torch.zeros(R, dtype=torch.int64, device=dev)
    act = torch.arange(R, device=dev)
    while act.numel():
        sp[act] -= 1
        node = nodes[stack[act, sp[act]]]
        leaf = node[:, 7] > 0.0

        lr = act[leaf]
        if lr.numel():
            first = node[leaf, 6].to(torch.int64)
            n = node[leaf, 7].to(torch.int64)
            leaves[lr] += 1
            tests[lr] += n
            for k in range(MAX_LEAF):
                pid = prim_ids[torch.clamp(first + k, max=T - 1)].long()
                t, u, v, div = _tri_test(tri_p, pid, org[lr], d[lr],
                                         time[lr], has_motion)
                bt = best_t[lr]
                ok = ((div != 0.0) & (u >= 0.0) & (v >= 0.0)
                      & (u + v <= 1.0) & (t >= min_t[lr]) & (t <= max_t[lr])
                      & (t < bt) & (k < n))
                best_t[lr] = torch.where(ok, t, bt)
                best_id[lr] = torch.where(ok, pid.to(torch.int32),
                                          best_id[lr])
                best_u[lr] = torch.where(ok, u, best_u[lr])
                best_v[lr] = torch.where(ok, v, best_v[lr])

        ir = act[~leaf]
        if ir.numel():
            inner[ir] += 1
            left = node[~leaf, 6].to(torch.int64)
            right = (-node[~leaf, 7]).to(torch.int64)
            tmax = torch.minimum(max_t[ir], best_t[ir])
            o, iv, mn = org[ir], inv_d[ir], min_t[ir]
            lhit = _ray_box(iv, o, nodes[left], mn, tmax)
            rhit = _ray_box(iv, o, nodes[right], mn, tmax)
            # hit children pushed, the left last so that it is visited first
            s = sp[ir]
            stack[ir, s] = torch.where(rhit, right, stack[ir, s])
            s = s + rhit
            stack[ir, s] = torch.where(lhit, left, stack[ir, s])
            sp[ir] = s + lhit

        done = sp[act] <= 0
        if any_hit:
            done |= torch.isfinite(best_t[act])
        act = act[~done]
    if stats is not None:
        stats.update(inner=inner, leaves=leaves, tests=tests)
    if any_hit:
        return best_t
    return best_t, best_id, best_u, best_v


# ---------------------------------------------------------------------------
# the traversal: CUDA kernel
# ---------------------------------------------------------------------------

def _ptr(x):
    return None if x is None else x.data_ptr()


def traverse(nodes, prim_ids, tri_p, org, d, time, min_t, max_t, any_hit,
             has_motion, packed=None):
    """The traversal of every ray. CPU tensors run traverse_reference on
    the nodes; CUDA tensors launch the kernel on packed, pack_bvh's
    tables of this very node tensor (raises without them). Returns (t,
    id, u, v) per ray (t = inf, id 0 where nothing is hit) or, with
    any_hit, occluded (bool) per ray. Raises for tables packed from
    another node tensor, on either device, and for a tree deeper than
    the stack (pack_bvh checked the tables' tree; check_depth checks
    nodes walked without tables)."""
    if packed is not None and packed.nodes is not nodes:
        raise ValueError('these BVH tables were packed (pack_bvh) from '
                         'another node tensor: pack the tree the scene '
                         'holds (attach_bvh does)')
    if not org.is_cuda:
        if packed is None:
            check_depth(nodes)
        out = traverse_reference(nodes, prim_ids, tri_p, org, d, time, min_t,
                                 max_t, any_hit, has_motion)
        return torch.isfinite(out) if any_hit else out
    if packed is None:
        raise ValueError('the BVH kernel walks the tables that pack_bvh '
                         'built from these nodes (attach_bvh stores them on '
                         'the scene): none were given')
    dev = org.device
    R, T = org.shape[0], prim_ids.shape[0]
    check = cuda_build.check
    M = packed.records.shape[0]
    check(packed.records, 'records', torch.float32, (M, 16), dev)
    check(packed.tris, 'tris', torch.float32, (2, T, 3, 4), dev)
    check(org, 'org', torch.float32, (R, 3), dev)
    check(d, 'dir', torch.float32, (R, 3), dev)
    for x, name in ((time, 'time'), (min_t, 'min_t'), (max_t, 'max_t')):
        check(x, name, torch.float32, (R,), dev)
    for x, name in ((packed.records, 'records'), (packed.tris, 'tris')):
        if x.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned (float4 '
                             f'reads)')
    if any_hit:
        out = occ = torch.empty(R, dtype=torch.bool, device=dev)
        res = (None,) * 4
    else:
        out = res = (torch.empty(R, dtype=torch.float32, device=dev),
                     torch.empty(R, dtype=torch.int32, device=dev),
                     torch.empty(R, dtype=torch.float32, device=dev),
                     torch.empty(R, dtype=torch.float32, device=dev))
        occ = None
    err = cuda_build.load_library().bvh_traverse(
        _ptr(packed.records), packed.root, _ptr(packed.tris),
        packed.tris.shape[1], *map(_ptr, (org, d, time, min_t, max_t)), R,
        int(has_motion), int(any_hit), *map(_ptr, res), _ptr(occ),
        cuda_build.stream_of(dev))
    cuda_build.raise_on_error(err, f'bvh_traverse (any_hit={any_hit})')
    launch_counts['any_hit' if any_hit else 'closest_hit'] += 1
    return out


def intersect_bvh(scene, org, d, time, min_t, max_t):
    """Closest hit. Returns (hit, tri_id, t, u, v); t = 0 where nothing is
    hit."""
    t, tid, u, v = traverse(scene.bvh_nodes, scene.bvh_prim_ids, scene.tri_p,
                            org.contiguous(), d.contiguous(),
                            time.contiguous(), min_t.contiguous(),
                            max_t.contiguous(), False, scene.has_motion,
                            scene.bvh_packed)
    hit = torch.isfinite(t)
    return hit, tid, torch.where(hit, t, torch.zeros_like(t)), u, v


def occluded_bvh(scene, org, d, time, min_t, max_t):
    """Any hit. Returns occluded [R] bool."""
    return traverse(scene.bvh_nodes, scene.bvh_prim_ids, scene.tri_p,
                    org.contiguous(), d.contiguous(), time.contiguous(),
                    min_t.contiguous(), max_t.contiguous(), True,
                    scene.has_motion, scene.bvh_packed)
