"""Culled-sweep ray/triangle intersection (port of ops/pallas_isect.py,
the JAX package's ``LMCMC_ISECT_BACKEND=pallas`` backend).

1. Host tables (``prep_tables``): triangles Morton-ordered into
   512-triangle chunks, packed as the chunk walk packs them ([K, 16, 512]
   f32 rows: Woop inverse frame 0-8, translation 9-11, valid 12) with int32
   ids beside them, plus per-chunk AABBs.
2. Torch stage (``prepare_rays``): pad to 256-ray blocks and sort rays by
   (origin Morton cell, direction octant).
3. The sweep (``walk``): for CUDA tensors the kernel ``csrc/sweep.cu``,
   closest hit or any hit, which slab-tests every (ray, chunk) AABB pair
   into its per-(block, chunk) visit mask itself and splits each block's
   chunks into ranges walked by separate CTAs; for CPU tensors its plain
   torch version with the same contract, ``_chunk_mask`` +
   ``sweep_reference``. Each block visits its unmasked chunks in ascending
   order; within a chunk the smallest t wins (ties to the smallest id),
   across chunks a later chunk must be strictly closer.
"""

import torch

from .chunkwalk import (BIG, RAY_BLOCK, _sort_rays, _tile, _unsort,
                        chunk_winner, closest_result, launch, pad_rays)
from .chunkwalk import prep_tables as _prep_chunks
from .tracing import launch_counter

TRI_CHUNK = 512

# launches of the CUDA kernel, per variant; the plain version never counts
launch_counts = launch_counter(('closest_hit', 'any_hit'), __name__)


def prep_tables(B, C, ok, tp):
    """(pack [K, 16, 512] f32, ids [K, 512] int32, chunk_lo, chunk_hi
    [K, 3]) in the Morton order of pallas_isect._prep_tables."""
    return _prep_chunks(B, C, ok, tp, chunk=TRI_CHUNK)


def _chunk_mask(org, d, min_t, max_t, chunk_lo, chunk_hi):
    """Conservative per-(ray-block, chunk) visibility: slab test of every
    ray segment against every chunk AABB, OR-reduced per RAY_BLOCK.
    org/d [Rp, 3]; returns [Rp / RAY_BLOCK, K] int32."""
    safe_d = torch.where(torch.abs(d) < 1e-12,
                         torch.where(d < 0, torch.full_like(d, -1e-12),
                                     torch.full_like(d, 1e-12)), d)
    inv = 1.0 / safe_d
    t0 = (chunk_lo[None] - org[:, None]) * inv[:, None]          # [Rp, K, 3]
    t1 = (chunk_hi[None] - org[:, None]) * inv[:, None]
    tn = torch.amax(torch.minimum(t0, t1), -1)
    tf = torch.amin(torch.maximum(t0, t1), -1)
    hit = (tn <= tf) & (tf >= min_t[:, None]) & (tn <= max_t[:, None])
    return hit.reshape(-1, RAY_BLOCK, chunk_lo.shape[0]).any(1).to(
        torch.int32)


def sweep_reference(pack, ids, mask, org, d, rng, any_hit):
    """Plain torch version of the sweep kernel: for each chunk in
    ascending order, test the [NB', 256, 512] tile of the blocks its mask
    column keeps. Closest hit returns (t f32, id i32, u f32, v f32) per
    ray, t = BIG and id = -1 where nothing is hit; any hit returns
    occluded (bool) per ray."""
    nb, K = mask.shape
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
    for j in range(K):
        blk = torch.nonzero(mask[:, j] > 0).squeeze(1)
        if blk.numel() == 0:
            continue
        ok, t, u, v = _tile(pack[j:j + 1], *(c[blk] for c in cols))
        if any_hit:
            occ[blk] |= ok.any(-1)
            continue
        c_t, c_id, c_u, c_v = chunk_winner(ok, t, u, v, ids[j][None, None])
        better = c_t < best_t[blk]
        best_t[blk] = torch.where(better, c_t, best_t[blk])
        best_id[blk] = torch.where(better, c_id, best_id[blk])
        best_u[blk] = torch.where(better, c_u, best_u[blk])
        best_v[blk] = torch.where(better, c_v, best_v[blk])
    if any_hit:
        return occ.reshape(-1)
    return (best_t.reshape(-1), best_id.reshape(-1), best_u.reshape(-1),
            best_v.reshape(-1))


def walk(pack, ids, chunk_lo, chunk_hi, org, d, rng, any_hit, splits=None,
         chunk_mask=None):
    """The sweep over padded, sorted rays, its visit mask built from the
    AABBs chunk_lo / chunk_hi [K, 3]. CPU tensors run the plain version
    (_chunk_mask + sweep_reference); CUDA tensors launch the kernel (or
    raise), with `splits` chunk ranges per block (default
    chunkwalk.split_count) and the test hook `chunk_mask` of
    chunkwalk.launch."""
    if not org.is_cuda:
        mask = _chunk_mask(org, d, rng[:, 0], rng[:, 1], chunk_lo, chunk_hi)
        return sweep_reference(pack, ids, mask, org, d, rng, any_hit)
    out = launch('sweep_walk', TRI_CHUNK, pack, ids, chunk_lo, chunk_hi, org,
                 d, rng, any_hit, splits, chunk_mask)
    launch_counts['any_hit' if any_hit else 'closest_hit'] += 1
    return out


def prepare_rays(tables, org, d, min_t, max_t):
    """Pad (chunkwalk.pad_rays) and sort (no dead-last key, as in the JAX
    sweep). Returns the sweep's rays (org, d, rng = [min_t, max_t]) and the
    sort order (None for a single block)."""
    org, d, min_t, max_t = pad_rays(org, d, min_t, max_t)
    order = None
    if org.shape[0] > RAY_BLOCK:
        order = _sort_rays(tables.scene_lo, tables.scene_hi, org, d)
        org, d = org[order], d[order]
        min_t, max_t = min_t[order], max_t[order]
    rng = torch.stack([min_t, max_t], -1)
    return (org.contiguous(), d.contiguous(), rng.contiguous()), order


def _sweep(sw, org, d, min_t, max_t, any_hit):
    """The sweep over the query's rays; returns its padded, sorted output
    and the sort order."""
    (o, dd, rng), order = prepare_rays(sw, org, d, min_t, max_t)
    return walk(sw.pack, sw.ids, sw.chunk_lo, sw.chunk_hi, o, dd, rng,
                any_hit), order


def intersect_sweep(scene, org, d, time, min_t, max_t):
    """Closest hit. Returns (hit, tri_id, t, u, v)."""
    out, order = _sweep(scene.sweep, org, d, min_t, max_t, False)
    return closest_result(*out, order, org.shape[0])


def occluded_sweep(scene, org, d, time, min_t, max_t):
    """Any hit. Returns occluded [R] bool."""
    occ, order = _sweep(scene.sweep, org, d, min_t, max_t, True)
    return _unsort(occ, order, org.shape[0])
