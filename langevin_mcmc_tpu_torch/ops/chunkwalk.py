"""Chunk-walk ray/triangle intersection: per-ray-block dynamic chunk lists
(port of ops/chunkwalk.py).

1. Host tables (``prep_tables``, numpy, as in the JAX package): triangles
   Morton-ordered into 128-triangle chunks, each packed as [16, 128] f32
   rows (Woop inverse frame 0-8, translation 9-11, valid 12) with its
   int32 ids beside it, plus per-chunk AABBs.
2. Torch stage (``sort_rays``): pad to 256-ray blocks and sort rays
   dead-last by (origin Morton cell, direction octant).
3. The walk (``csrc/chunkwalk.cu`` on CUDA tensors): the kernel slab-tests
   each block's rays against the chunk AABBs itself, splits each block's
   hit chunks into ranges walked by separate CTAs and merges them, in one
   of two forms:
   * staged (``walk_staged``, the default): rows pass through a ring of
     shared-memory buffers;
   * resident (``walk_resident``): rows are read straight from global
     memory, the pack staying in L2.
   Both compute one function, closest hit or any hit, whose plain torch
   version ``_block_chunk_lists`` + ``walk_reference`` runs for CPU
   tensors.

The resident form is used when the pack is at most ``LMC_CW_VMEM_BYTES``
bytes (default 0: never), the JAX package's switch between its two walk
kernels (``ops/chunkwalk.py:48,364`` there); ``make_intersect_fns`` reads
it on each call.
"""

import os

import numpy as np
import torch

from . import cuda_build

RAY_BLOCK = 256
TRI_CHUNK = 128
PACK_ROWS = 16
BIG = 3.0e38
# the walk kernel: CTAs it aims for (chunk ranges per ray block =
# ceil(SPLIT_CTAS / blocks)), and the most chunks one range may hold
SPLIT_CTAS = 8192
MAX_RANGE = 1024

# launches of the CUDA kernels, per variant; the plain version never counts
launch_counts = {'split_closest_hit': 0, 'split_any_hit': 0,
                 'closest_hit_resident': 0, 'any_hit_resident': 0}


def use_resident(pack):
    """The resident form for packs of at most LMC_CW_VMEM_BYTES bytes."""
    return pack.numel() * pack.element_size() <= int(
        os.environ.get('LMC_CW_VMEM_BYTES', '0'))


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# host tables
# ---------------------------------------------------------------------------

def _morton3(x, y, z, bits=10):
    out = np.zeros_like(x, dtype=np.int64)
    for b in range(bits):
        out |= ((x >> b) & 1) << (3 * b + 2)
        out |= ((y >> b) & 1) << (3 * b + 1)
        out |= ((z >> b) & 1) << (3 * b)
    return out


def prep_tables(B, C, ok, tp, chunk=TRI_CHUNK):
    """Morton-order triangles; pack Woop rows + valid (+ the f32 id row 13
    the JAX package keeps) into [K, 16, chunk]; int32 ids [K, chunk];
    per-chunk AABBs [K, 3] lo / hi. B [3,3T], C [3T], ok [T] are the Woop
    tables, tp [T,3,3] the keyframe-0 vertices."""
    T = ok.shape[0]
    cen = tp.mean(1)
    lo = cen.min(0)
    span = np.maximum(cen.max(0) - lo, 1e-12)
    q = np.clip(((cen - lo) / span * 1023).astype(np.int64), 0, 1023)
    order = np.argsort(_morton3(q[:, 0], q[:, 1], q[:, 2]), kind='stable')

    Tp = -(-T // chunk) * chunk
    K = Tp // chunk
    pack = np.zeros((PACK_ROWS, Tp), np.float32)
    for c in range(3):
        for j in range(3):
            pack[3 * c + j, :T] = B[j, c::3][order]
        pack[9 + c, :T] = C[c::3][order]
    pack[12, :T] = ok[order].astype(np.float32)
    pack[13, :T] = order.astype(np.float32)
    pack = pack.reshape(PACK_ROWS, K, chunk).transpose(1, 0, 2).copy()
    ids = np.zeros(Tp, np.int32)
    ids[:T] = order
    ids = ids.reshape(K, chunk)

    vs = tp[order].reshape(T, 9)
    lo3 = np.minimum(np.minimum(vs[:, 0:3], vs[:, 3:6]), vs[:, 6:9])
    hi3 = np.maximum(np.maximum(vs[:, 0:3], vs[:, 3:6]), vs[:, 6:9])
    chunk_lo = np.full((K, 3), np.inf, np.float32)
    chunk_hi = np.full((K, 3), -np.inf, np.float32)
    for k in range(K):
        s, e = k * chunk, min((k + 1) * chunk, T)
        if s < T:
            chunk_lo[k] = lo3[s:e].min(0)
            chunk_hi[k] = hi3[s:e].max(0)
    pad = 1e-4 * np.maximum(chunk_hi - chunk_lo, 1e-6)
    return pack, ids, chunk_lo - pad, chunk_hi + pad


# ---------------------------------------------------------------------------
# ray sort and per-block chunk lists
# ---------------------------------------------------------------------------

def _sort_rays(scene_lo, scene_hi, org, d, alive=None):
    """(dead-last, origin Morton cell (64^3), direction octant) order.
    Dead rays (max_t < min_t) sort behind every live ray, so they fill
    whole ray blocks with empty chunk lists; alive=None sorts without the
    dead-last key."""
    q = torch.clamp(((org - scene_lo) / torch.clamp(scene_hi - scene_lo,
                                                     min=1e-12)
                     * 63.0).to(torch.int32), 0, 63)
    m = torch.zeros(org.shape[0], dtype=torch.int32, device=org.device)
    for b in range(6):
        m = (m | (((q[:, 0] >> b) & 1) << (3 * b + 2))
             | (((q[:, 1] >> b) & 1) << (3 * b + 1))
             | (((q[:, 2] >> b) & 1) << (3 * b)))
    octant = ((d[:, 0] < 0).to(torch.int32) * 4
              + (d[:, 1] < 0).to(torch.int32) * 2
              + (d[:, 2] < 0).to(torch.int32))
    key = m * 8 + octant
    if alive is not None:
        key = torch.where(alive, key, torch.full_like(key, 0x3FFFFFFF))
    return torch.argsort(key, stable=True)


# rays per slab-test batch: bounds the [R, K, 3] temporaries
_SLAB_RAYS = 64 * RAY_BLOCK


def _block_chunk_lists(org, d, min_t, max_t, chunk_lo, chunk_hi):
    """Slab-test rays x chunk AABBs; per-RAY_BLOCK union; compact into
    ascending lists. Returns (chunk_idx [NB, K] i32, counts [NB] i32)."""
    safe_d = torch.where(torch.abs(d) < 1e-12,
                         torch.where(d < 0, torch.full_like(d, -1e-12),
                                     torch.full_like(d, 1e-12)), d)
    inv = 1.0 / safe_d
    alive = max_t >= min_t
    K = chunk_lo.shape[0]
    parts = []
    for s in range(0, org.shape[0], _SLAB_RAYS):
        e = s + _SLAB_RAYS
        t0 = (chunk_lo[None] - org[s:e, None]) * inv[s:e, None]   # [r, K, 3]
        t1 = (chunk_hi[None] - org[s:e, None]) * inv[s:e, None]
        tn = torch.amax(torch.minimum(t0, t1), -1)
        tf = torch.amin(torch.maximum(t0, t1), -1)
        hit = ((tn <= tf) & (tf >= min_t[s:e, None])
               & (tn <= max_t[s:e, None]) & alive[s:e, None])
        parts.append(hit.reshape(-1, RAY_BLOCK, K).any(1))
    bm = torch.cat(parts, 0)                                      # [NB, K]
    counts = bm.sum(-1).to(torch.int32)
    # a stable sort of ~hit puts the hit chunk ids first, ascending
    chunk_idx = torch.argsort((~bm).to(torch.int32), dim=-1,
                              stable=True).to(torch.int32)
    return chunk_idx, counts


# ---------------------------------------------------------------------------
# the walk: plain version
# ---------------------------------------------------------------------------

def _tile(p, ox, oy, oz, dx, dy, dz, mn, mx):
    """Woop-projection test of [NB, RB] rays against [NB, 16, TC] chunk
    rows (NB may be 1 to broadcast one chunk). Returns (ok, t, u, v) of
    shape [NB, RB, TC]; every product and sum is rounded in the kernel's
    order."""
    def proj(c):
        b0 = p[:, 3 * c + 0][:, None, :]
        b1 = p[:, 3 * c + 1][:, None, :]
        b2 = p[:, 3 * c + 2][:, None, :]
        O = ox * b0 + oy * b1 + oz * b2 - p[:, 9 + c][:, None, :]
        Q = dx * b0 + dy * b1 + dz * b2
        return O, Q

    Ou, Qu = proj(0)
    Ov, Qv = proj(1)
    Ow, Qw = proj(2)
    qw_safe = torch.where(torch.abs(Qw) < 1e-12,
                          torch.where(Qw < 0, torch.full_like(Qw, -1e-12),
                                      torch.full_like(Qw, 1e-12)), Qw)
    t = -Ow / qw_safe
    u = Ou + t * Qu
    v = Ov + t * Qv
    ok = ((torch.abs(Qw) >= 1e-12) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t >= mn) & (t <= mx)
          & (p[:, 12][:, None, :] > 0.5))
    return ok, t, u, v


def chunk_winner(ok, t, u, v, tid):
    """Closest hit within each ray's chunk tile [..., TC]: the smallest t,
    ties to the smallest id. Returns (t, id, u, v) of shape [...]; t = BIG
    where nothing is hit."""
    t_m = torch.where(ok, t, torch.full_like(t, BIG))
    chunk_min = t_m.amin(-1)
    is_min = ok & (t_m <= chunk_min[..., None])
    tid = torch.broadcast_to(tid, t.shape)
    win_id = torch.where(is_min, tid, torch.full_like(
        tid, torch.iinfo(torch.int32).max)).amin(-1)
    uniq = is_min & (tid == win_id[..., None])
    win_u = torch.where(uniq, u, torch.zeros_like(u)).sum(-1)
    win_v = torch.where(uniq, v, torch.zeros_like(v)).sum(-1)
    return chunk_min, win_id, win_u, win_v


def walk_reference(pack, ids, chunk_idx, counts, org, d, rng, any_hit):
    """Plain torch version of the chunk-walk kernel, vectorised over ray
    blocks: step j over the longest list, gather each block's j-th chunk
    and test [NB, 256, 128] tiles, masked by j < counts.

    Closest hit returns (t f32, id i32, u f32, v f32) per ray, t = BIG and
    id = -1 where nothing is hit; within a chunk the smallest t wins and
    ties go to the smallest id, across chunks a later chunk must be
    strictly closer. Any hit returns occluded (bool) per ray."""
    nb = counts.shape[0]
    dev = org.device
    o = org.reshape(nb, RAY_BLOCK, 3)
    dd = d.reshape(nb, RAY_BLOCK, 3)
    r = rng.reshape(nb, RAY_BLOCK, 2)
    cols = [x[..., None] for x in (o[..., 0], o[..., 1], o[..., 2],
                                   dd[..., 0], dd[..., 1], dd[..., 2],
                                   r[..., 0], r[..., 1])]
    best_t = torch.full((nb, RAY_BLOCK), BIG, device=dev)
    best_id = torch.full((nb, RAY_BLOCK), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((nb, RAY_BLOCK), device=dev)
    best_v = torch.zeros((nb, RAY_BLOCK), device=dev)
    occ = torch.zeros((nb, RAY_BLOCK), dtype=torch.bool, device=dev)
    max_count = int(counts.max()) if nb else 0
    for j in range(max_count):
        active = (j < counts)[:, None, None]
        cid = chunk_idx[:, j].long()
        ok, t, u, v = _tile(pack[cid], *cols)
        ok = ok & active
        if any_hit:
            occ |= ok.any(-1)
            continue
        chunk_min, win_id, win_u, win_v = chunk_winner(
            ok, t, u, v, ids[cid][:, None, :])
        better = chunk_min < best_t
        best_t = torch.where(better, chunk_min, best_t)
        best_id = torch.where(better, win_id, best_id)
        best_u = torch.where(better, win_u, best_u)
        best_v = torch.where(better, win_v, best_v)
    if any_hit:
        return occ.reshape(-1)
    return (best_t.reshape(-1), best_id.reshape(-1), best_u.reshape(-1),
            best_v.reshape(-1))


# ---------------------------------------------------------------------------
# the walk: CUDA kernels
# ---------------------------------------------------------------------------

def split_count(num_blocks, num_chunks):
    """S, the chunk ranges per ray block of the walk kernel (every form,
    the sweep's too): about SPLIT_CTAS CTAs at any ray count, at most
    MAX_RANGE chunks a range."""
    s = max(-(-SPLIT_CTAS // max(num_blocks, 1)),
            -(-num_chunks // MAX_RANGE))
    return max(1, min(s, num_chunks))


def _ptr(x):
    return None if x is None else x.data_ptr()


def launch(entry, tri_chunk, pack, ids, chunk_lo, chunk_hi, org, d, rng,
           any_hit, splits=None, chunk_mask=None):
    """Launch the C entry point `entry` (one form of the walk kernel of
    csrc/walk.cuh, over chunks of tri_chunk triangles) on padded, sorted
    rays on the card, with `splits` chunk ranges per block (default
    split_count). Returns what walk_reference returns; raises on inputs
    the kernel does not take and on a failed launch. chunk_mask is a test
    hook that no render path passes: a uint8 [blocks, K] tensor that
    receives each block's chunk hit set."""
    dev = org.device
    nb = org.shape[0] // RAY_BLOCK
    K = pack.shape[0]
    rp = nb * RAY_BLOCK
    check = cuda_build.check
    check(pack, 'pack', torch.float32, (K, PACK_ROWS, tri_chunk), dev)
    check(ids, 'ids', torch.int32, (K, tri_chunk), dev)
    check(chunk_lo, 'chunk_lo', torch.float32, (K, 3), dev)
    check(chunk_hi, 'chunk_hi', torch.float32, (K, 3), dev)
    check(org, 'org', torch.float32, (rp, 3), dev)
    check(d, 'dir', torch.float32, (rp, 3), dev)
    check(rng, 'rng', torch.float32, (rp, 2), dev)
    if pack.data_ptr() % 16 or ids.data_ptr() % 16:
        raise ValueError('pack and ids must be 16-byte aligned (float4 '
                         'reads, cp.async)')
    if chunk_mask is not None:
        check(chunk_mask, 'chunk_mask', torch.uint8, (nb, K), dev)
    splits = split_count(nb, K) if splits is None else splits
    if any_hit:
        out = torch.zeros(rp, dtype=torch.bool, device=dev)
        part = res = (None,) * 4
        occ = out
    else:
        out = res = (torch.empty(rp, dtype=torch.float32, device=dev),
                     torch.empty(rp, dtype=torch.int32, device=dev),
                     torch.empty(rp, dtype=torch.float32, device=dev),
                     torch.empty(rp, dtype=torch.float32, device=dev))
        # the ranges' partials; the kernel writes `out` itself when S = 1
        part = [torch.empty((splits if splits > 1 else 0, rp), dtype=x.dtype,
                            device=dev) for x in out]
        occ = None
    err = getattr(cuda_build.load_library(), entry)(
        *map(_ptr, (pack, ids, chunk_lo, chunk_hi, org, d, rng)),
        nb, K, splits, int(any_hit), *map(_ptr, part), *map(_ptr, res),
        _ptr(occ), _ptr(chunk_mask), cuda_build.stream_of(dev))
    cuda_build.raise_on_error(err, f'{entry} (any_hit={any_hit})')
    return out


def walk_staged(pack, ids, chunk_lo, chunk_hi, org, d, rng, any_hit,
                splits=None, chunk_mask=None):
    """The staged walk (K1/K2) over padded, sorted rays: the chunk lists
    are built from the AABBs chunk_lo / chunk_hi [K, 3]. CPU tensors run
    the plain version (_block_chunk_lists + walk_reference); CUDA tensors
    launch the kernel (or raise); `splits` and `chunk_mask` as in
    launch."""
    if not org.is_cuda:
        chunk_idx, counts = _block_chunk_lists(org, d, rng[:, 0], rng[:, 1],
                                               chunk_lo, chunk_hi)
        return walk_reference(pack, ids, chunk_idx, counts, org, d, rng,
                              any_hit)
    out = launch('chunkwalk_staged', TRI_CHUNK, pack, ids, chunk_lo,
                 chunk_hi, org, d, rng, any_hit, splits, chunk_mask)
    launch_counts['split_any_hit' if any_hit else 'split_closest_hit'] += 1
    return out


def walk_resident(pack, ids, chunk_lo, chunk_hi, org, d, rng, any_hit,
                  splits=None, chunk_mask=None):
    """The resident walk (K3): walk_staged's function and arguments, with
    the kernel reading rows from global memory instead of a shared-memory
    ring."""
    if not org.is_cuda:
        return walk_staged(pack, ids, chunk_lo, chunk_hi, org, d, rng,
                           any_hit)
    out = launch('chunkwalk_resident', TRI_CHUNK, pack, ids, chunk_lo,
                 chunk_hi, org, d, rng, any_hit, splits, chunk_mask)
    launch_counts['any_hit_resident' if any_hit
                  else 'closest_hit_resident'] += 1
    return out


# ---------------------------------------------------------------------------
# the queries
# ---------------------------------------------------------------------------

def pad_rays(org, d, min_t, max_t):
    """Pad to whole ray blocks (padding rays are dead) and map max_t = inf
    to BIG."""
    pad = -org.shape[0] % RAY_BLOCK
    if pad:
        org = torch.cat([org, org.new_zeros(pad, 3)])
        d = torch.cat([d, org.new_ones(pad, 3)])
        min_t = torch.cat([min_t, min_t.new_ones(pad)])
        max_t = torch.cat([max_t, max_t.new_zeros(pad)])
    max_t = torch.where(torch.isinf(max_t), torch.full_like(max_t, BIG),
                        max_t)
    return org, d, min_t, max_t


def sort_rays(cw, org, d, min_t, max_t):
    """Pad (pad_rays) and sort. Returns the walk's rays (org, d, rng =
    [min_t, max_t]) and the sort order (None for a single block)."""
    org, d, min_t, max_t = pad_rays(org, d, min_t, max_t)
    order = None
    if org.shape[0] > RAY_BLOCK:
        order = _sort_rays(cw.scene_lo, cw.scene_hi, org, d,
                           alive=max_t >= min_t)
        org, d = org[order], d[order]
        min_t, max_t = min_t[order], max_t[order]
    rng = torch.stack([min_t, max_t], -1)
    return (org.contiguous(), d.contiguous(), rng.contiguous()), order


def _unsort(x, order, R):
    if order is not None:
        out = torch.empty_like(x)
        out[order] = x
        x = out
    return x[:R]


def closest_result(t, tid, u, v, order, R):
    """A closest-hit walk's padded, sorted output as the query's result
    (hit, tri_id, t, u, v) over the R rays in their own order."""
    t, tid, u, v = (_unsort(x, order, R) for x in (t, tid, u, v))
    hit = t < BIG
    zero = torch.zeros_like(t)
    return (hit, torch.where(hit, tid, torch.zeros_like(tid)),
            torch.where(hit, t, zero), torch.where(hit, u, zero),
            torch.where(hit, v, zero))


def _walk(cw, org, d, min_t, max_t, any_hit, resident):
    """Either form of the walk over the query's rays; returns its padded,
    sorted output and the sort order."""
    (o, dd, rng), order = sort_rays(cw, org, d, min_t, max_t)
    walk = walk_resident if resident else walk_staged
    return walk(cw.pack, cw.ids, cw.chunk_lo, cw.chunk_hi, o, dd, rng,
                any_hit=any_hit), order


def intersect_chunkwalk(scene, org, d, time, min_t, max_t, resident=False):
    """Closest hit. Returns (hit, tri_id, t, u, v)."""
    out, order = _walk(scene.cw, org, d, min_t, max_t, False, resident)
    return closest_result(*out, order, org.shape[0])


def occluded_chunkwalk(scene, org, d, time, min_t, max_t, resident=False):
    """Any hit. Returns occluded [R] bool."""
    occ, order = _walk(scene.cw, org, d, min_t, max_t, True, resident)
    return _unsort(occ, order, org.shape[0])
