"""Culled-sweep ray/triangle intersection (port of ops/pallas_isect.py,
the JAX package's ``LMCMC_ISECT_BACKEND=pallas`` backend).

1. Host tables (``prep_tables``): triangles Morton-ordered into
   512-triangle chunks, packed as the chunk walk packs them ([K, 16, 512]
   f32 rows: Woop inverse frame 0-8, translation 9-11, valid 12) with int32
   ids beside them, plus per-chunk AABBs.
2. Torch stage: pad to 256-ray blocks, sort rays by (origin Morton cell,
   direction octant) and slab-test every (ray, chunk) AABB pair into a
   per-(block, chunk) visit mask (``_chunk_mask``).
3. The sweep (``walk``): the CUDA kernel ``csrc/sweep.cu`` for CUDA
   tensors — closest hit or any hit — and ``sweep_reference``, its plain
   torch version with the same contract, for CPU tensors. Each block
   visits its unmasked chunks in ascending order; within a chunk the
   smallest t wins (ties to the smallest id), across chunks a later chunk
   must be strictly closer.
"""

import torch

from . import cuda_build
from .chunkwalk import (BIG, PACK_ROWS, RAY_BLOCK, _sort_rays, _tile,
                        _unsort, chunk_winner, closest_result, pad_rays)
from .chunkwalk import prep_tables as _prep_chunks

TRI_CHUNK = 512

# launches of the CUDA kernel, per variant; the plain version never counts
launch_counts = {'closest_hit': 0, 'any_hit': 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


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


def walk(pack, ids, mask, org, d, rng, any_hit):
    """The sweep over padded, sorted rays. CPU tensors run sweep_reference;
    CUDA tensors launch the kernel (or raise)."""
    if not org.is_cuda:
        return sweep_reference(pack, ids, mask, org, d, rng, any_hit)
    dev = org.device
    nb, K = mask.shape
    rp = nb * RAY_BLOCK
    check = cuda_build.check
    check(pack, 'pack', torch.float32, (K, PACK_ROWS, TRI_CHUNK), dev)
    check(ids, 'ids', torch.int32, (K, TRI_CHUNK), dev)
    check(mask, 'mask', torch.int32, (nb, K), dev)
    check(org, 'org', torch.float32, (rp, 3), dev)
    check(d, 'dir', torch.float32, (rp, 3), dev)
    check(rng, 'rng', torch.float32, (rp, 2), dev)
    lib = cuda_build.load_library()
    stream = cuda_build.stream_of(dev)
    args = [x.data_ptr() for x in (pack, ids, mask, org, d, rng)]
    if any_hit:
        occ = torch.empty(rp, dtype=torch.bool, device=dev)
        err = lib.sweep_any(*args, nb, K, occ.data_ptr(), stream)
        variant, out = 'any_hit', occ
    else:
        t = torch.empty(rp, dtype=torch.float32, device=dev)
        tid = torch.empty(rp, dtype=torch.int32, device=dev)
        u = torch.empty(rp, dtype=torch.float32, device=dev)
        v = torch.empty(rp, dtype=torch.float32, device=dev)
        err = lib.sweep_closest(*args, nb, K, t.data_ptr(), tid.data_ptr(),
                                u.data_ptr(), v.data_ptr(), stream)
        variant, out = 'closest_hit', (t, tid, u, v)
    cuda_build.raise_on_error(err, f'sweep {variant}')
    launch_counts[variant] += 1
    return out


def prepare_rays(tables, org, d, min_t, max_t):
    """Pad (chunkwalk.pad_rays), sort (no dead-last key, as in the JAX
    sweep) and build the visit mask. Returns the sweep's inputs and the
    sort order (None for a single block)."""
    org, d, min_t, max_t = pad_rays(org, d, min_t, max_t)
    order = None
    if org.shape[0] > RAY_BLOCK:
        order = _sort_rays(tables.scene_lo, tables.scene_hi, org, d)
        org, d = org[order], d[order]
        min_t, max_t = min_t[order], max_t[order]
    mask = _chunk_mask(org, d, min_t, max_t, tables.chunk_lo,
                       tables.chunk_hi)
    rng = torch.stack([min_t, max_t], -1)
    return (mask, org.contiguous(), d.contiguous(), rng.contiguous()), order


def intersect_sweep(scene, org, d, time, min_t, max_t):
    """Closest hit. Returns (hit, tri_id, t, u, v)."""
    sw = scene.sweep
    (mask, o, dd, rng), order = prepare_rays(sw, org, d, min_t, max_t)
    out = walk(sw.pack, sw.ids, mask, o, dd, rng, any_hit=False)
    return closest_result(*out, order, org.shape[0])


def occluded_sweep(scene, org, d, time, min_t, max_t):
    """Any hit. Returns occluded [R] bool."""
    sw = scene.sweep
    (mask, o, dd, rng), order = prepare_rays(sw, org, d, min_t, max_t)
    occ = walk(sw.pack, sw.ids, mask, o, dd, rng, any_hit=True)
    return _unsort(occ, order, org.shape[0])
