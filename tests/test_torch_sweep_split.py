"""The culled sweep's split form (kernel K4: csrc/sweep.cu, the Sweep form
of csrc/walk.cuh) on the CPU, as plain torch mirrors of the rules the
kernel follows:

* the visit mask in the kernel: for each range of chunk ids
  [s K / S, (s + 1) K / S), the slab test of a block's rays against the
  range's AABBs, with no alive term, OR over the rays. The ranges' masks
  put together equal _chunk_mask and the JAX package's mask, blocks with
  padding and dead rays included;
* tiles and ranges: each range walks its visited chunks in ascending order
  as 128-triangle tiles, carrying the least (t, chunk, id): a tile's
  winner replaces the running best when it is closer, or as close, of the
  same chunk and of a smaller id. The ranges' closest hits, merged in
  ascending order with a strict < (any hit: OR), equal sweep_reference
  bit for bit, on planted exact ties between two tiles of one chunk (the
  smaller id wins) and between two chunks (the earlier chunk wins);
* the sweep on CPU tensors is the plain version and counts no launch.
The kernel itself is held against the plain version on the card by
tests/test_torch_kernel.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.ops import pallas_isect as jax_sweep
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.ops import sweep_isect as sw
from langevin_mcmc_tpu_torch.ops.chunkwalk import BIG, RAY_BLOCK, _tile, \
    chunk_winner
from torch_parity import planted_tie_case, port_scene, to_np

torch.set_num_threads(1)
TILE = 128  # triangles the kernel stages at a time


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('small')),
                                 small=True, width=64, height=48, max_depth=4)
    js, _, _ = jax_parse(xml)
    ts = port_scene(js)
    assert ts.sweep.pack.shape[0] >= 3
    return js, ts


def _scene_rays(ts, n=1500, seed=3):
    """Rays leaving random surface points in random directions, a quarter
    dead, made with numpy; n is not a multiple of 256, so the last block
    holds padding."""
    rng = np.random.default_rng(seed)
    tp = to_np(ts.tri_p[0]).astype(np.float64)
    p = tp[rng.integers(0, tp.shape[0], n)]
    b = rng.uniform(0, 1, (n, 2))
    b = np.where(b.sum(1, keepdims=True) > 1, 1 - b, b)
    org = p[:, 0] * (1 - b.sum(1))[:, None] + p[:, 1] * b[:, :1] \
        + p[:, 2] * b[:, 1:]
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mx = np.where(rng.uniform(size=n) < 0.25, 0.0, np.inf)
    return tuple(torch.as_tensor(x, dtype=torch.float32)
                 for x in (org, d, np.full(n, 1e-2), mx))


@pytest.fixture(scope='module', params=['scene', 'ties', 'dead'])
def case(request, scenes):
    """(pack, ids, chunk_lo, chunk_hi, sorted padded rays org, d, rng).
    'dead': every ray dead, leaving a surface point, so it lies inside a
    chunk's AABB and the mask, which has no alive term, keeps that chunk
    (the chunk walk's lists would be empty)."""
    _, ts = scenes
    sweep = ts.sweep
    tables = (sweep.pack, sweep.ids, sweep.chunk_lo, sweep.chunk_hi)
    if request.param == 'scene':
        rays = _scene_rays(ts)
    elif request.param == 'dead':
        org, d, mn, _ = _scene_rays(ts, n=600, seed=5)
        rays = (org, d, mn, torch.zeros(600))
    else:
        *tables, rays = planted_tie_case(ts, ts.sweep)
    (o, d, rng), _ = sw.prepare_rays(ts.sweep, *rays)
    return request.param, (*tables, o, d, rng)


def _range_masks(org, d, rng, lo, hi, S):
    """The kernel's mask rule: per range, [blocks, K] int32 holding, for
    each chunk of the range, whether some ray of the block crosses its
    AABB within [min_t, max_t] (dead rays too), and 0 outside the range."""
    nb, K = org.shape[0] // RAY_BLOCK, lo.shape[0]
    safe = torch.where(d.abs() < 1e-12,
                       torch.where(d < 0, torch.full_like(d, -1e-12),
                                   torch.full_like(d, 1e-12)), d)
    inv = 1.0 / safe
    masks = []
    for s in range(S):
        m = torch.zeros((nb, K), dtype=torch.int32)
        for c in range(s * K // S, (s + 1) * K // S):
            t0 = (lo[c] - org) * inv
            t1 = (hi[c] - org) * inv
            tn = torch.minimum(t0, t1).amax(1)
            tf = torch.maximum(t0, t1).amin(1)
            hit = (tn <= tf) & (tf >= rng[:, 0]) & (tn <= rng[:, 1])
            m[:, c] = hit.reshape(nb, RAY_BLOCK).any(1).to(torch.int32)
        masks.append(m)
    return masks


def _tile_walk(pack, ids, mask, org, d, rng, any_hit):
    """One range as the kernel walks it: the chunks its mask keeps, in
    ascending order, as 128-triangle tiles; each tile's winner (least t,
    then least id) replaces the running best when closer, or as close, of
    the same chunk and of a smaller id."""
    nb, K = mask.shape
    o = org.reshape(nb, RAY_BLOCK, 3)
    dd = d.reshape(nb, RAY_BLOCK, 3)
    r = rng.reshape(nb, RAY_BLOCK, 2)
    cols = [x[..., None] for x in (o[..., 0], o[..., 1], o[..., 2],
                                   dd[..., 0], dd[..., 1], dd[..., 2],
                                   r[..., 0], r[..., 1])]
    best = [torch.full((nb, RAY_BLOCK), BIG),
            torch.full((nb, RAY_BLOCK), -1, dtype=torch.int32),
            torch.zeros((nb, RAY_BLOCK)), torch.zeros((nb, RAY_BLOCK))]
    best_cid = torch.full((nb, RAY_BLOCK), -1)
    occ = torch.zeros((nb, RAY_BLOCK), dtype=torch.bool)
    for j in range(K):
        blk = torch.nonzero(mask[:, j] > 0).squeeze(1)
        if blk.numel() == 0:
            continue
        for q in range(pack.shape[2] // TILE):
            tile = slice(q * TILE, (q + 1) * TILE)
            ok, t, u, v = _tile(pack[j:j + 1, :, tile],
                                *(c[blk] for c in cols))
            if any_hit:
                occ[blk] |= ok.any(-1)
                continue
            win = chunk_winner(ok, t, u, v, ids[j, tile][None, None])
            bt, bi = best[0][blk], best[1][blk]
            take = (win[0] < bt) | ((win[0] == bt) & (best_cid[blk] == j)
                                    & (win[1] < bi))
            for x, w in zip(best, win):
                x[blk] = torch.where(take, w, x[blk])
            best_cid[blk] = torch.where(take, j, best_cid[blk])
    if any_hit:
        return occ.reshape(-1)
    return tuple(x.reshape(-1) for x in best)


def _split_sweep(pack, ids, org, d, rng, lo, hi, any_hit, S):
    """Each range walked on its own (_tile_walk over the range's mask),
    then merged: ascending ranges, strict < (any hit: OR)."""
    merged = None
    for m in _range_masks(org, d, rng, lo, hi, S):
        part = _tile_walk(pack, ids, m, org, d, rng, any_hit)
        if merged is None:
            merged = part
        elif any_hit:
            merged = merged | part
        else:
            better = part[0] < merged[0]
            merged = tuple(torch.where(better, p, x)
                           for p, x in zip(part, merged))
    return merged


@pytest.mark.parametrize('which', ['one', 'three', 'all'])
def test_range_masks_match_chunk_mask(case, which):
    name, (pack, ids, lo, hi, o, d, rng) = case
    K = pack.shape[0]
    S = {'one': 1, 'three': 3, 'all': K}[which]
    masks = _range_masks(o, d, rng, lo, hi, S)
    for s, m in enumerate(masks):
        outside = torch.ones(K, dtype=torch.bool)
        outside[s * K // S:(s + 1) * K // S] = False
        assert not m[:, outside].any()
    got = sum(masks)
    want = sw._chunk_mask(o, d, rng[:, 0], rng[:, 1], lo, hi)
    assert torch.equal(got, want)
    jmask = jax_sweep._chunk_mask(*(jnp.asarray(to_np(x)) for x in (
        o, d, rng[:, 0], rng[:, 1], lo, hi)))
    np.testing.assert_array_equal(to_np(got), np.asarray(jmask))
    # dead and padding rays are slab-tested too
    assert not (rng[:, 1] >= rng[:, 0]).all() and bool(got.any())
    if name == 'dead':
        assert bool(got.all())


@pytest.mark.parametrize('which', ['one', 'two', 'all'])
def test_split_sweep_matches_sweep_reference(case, which):
    name, (pack, ids, lo, hi, o, d, rng) = case
    K = pack.shape[0]
    S = {'one': 1, 'two': 2, 'all': K}[which]
    mask = sw._chunk_mask(o, d, rng[:, 0], rng[:, 1], lo, hi)
    want = sw.sweep_reference(pack, ids, mask, o, d, rng, False)
    got = _split_sweep(pack, ids, o, d, rng, lo, hi, False, S)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    occ = _split_sweep(pack, ids, o, d, rng, lo, hi, True, S)
    assert torch.equal(occ, sw.sweep_reference(pack, ids, mask, o, d, rng,
                                               True))
    hit = want[0] < BIG
    assert hit.any() != (name == 'dead') and (~hit).any()
    assert torch.equal(occ, hit)
    if name == 'ties':
        # the copy with id -2, in a later tile of chunk 0, beats its
        # original (tile 0, a larger id) and id -3 of the last chunk: the
        # tie rules decided these hits
        assert (want[1][hit] == -2).float().mean() > 0.9


def test_sweep_on_cpu_is_the_plain_version(case):
    _, (pack, ids, lo, hi, o, d, rng) = case
    sw.reset_launch_counts()
    mask = sw._chunk_mask(o, d, rng[:, 0], rng[:, 1], lo, hi)
    got = sw.walk(pack, ids, lo, hi, o, d, rng, False)
    want = sw.sweep_reference(pack, ids, mask, o, d, rng, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(sw.walk(pack, ids, lo, hi, o, d, rng, True),
                       sw.sweep_reference(pack, ids, mask, o, d, rng, True))
    assert not any(sw.launch_counts.values())
