"""The chunk walk's split form (kernels K1/K2 and K3: the Staged and
Resident forms of csrc/walk.cuh, in csrc/chunkwalk.cu) on the CPU, as
plain torch mirrors of the rules the kernels follow:

* split and merge: each ray block's chunk ids are cut into S contiguous
  ranges [s K / S, (s + 1) K / S); each range is walked on its own, and
  the ranges' closest hits are merged in ascending order with a strict <
  (any hit: OR). That equals walk_reference over the whole list bit for
  bit, ties included (the planted-tie pack);
* the in-kernel lists: per range, the slab test of the block's rays
  against the range's AABBs, OR over the rays, compacted in ascending
  order; the ranges' lists, concatenated, equal _block_chunk_lists,
  padded and dead rays included;
* both forms on CPU tensors are the plain version; intersect_chunkwalk
  (both forms) still agrees with JAX intersect_bruteforce as
  tests/test_torch_intersect.py requires, and the resident form with the
  JAX package's resident kernel (_walk_kernel_resident, in interpret
  mode).
The kernels themselves are held against the plain version on the card by
tests/test_torch_kernel.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from langevin_mcmc_tpu.scene.parse import parse_scene as jax_parse
from langevin_mcmc_tpu.ops import chunkwalk as jax_cw
from langevin_mcmc_tpu.ops import intersect as jax_isect
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
from langevin_mcmc_tpu_torch.ops import tracing
from torch_parity import planted_tie_case, port_scene, to_np

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('small')),
                                 small=True, width=64, height=48, max_depth=4)
    js, _, _ = jax_parse(xml)
    ts = port_scene(js)
    assert ts.cw.pack.shape[0] >= 4
    return js, ts


def _scene_rays(ts, n=1500, seed=3):
    """Rays between random triangle centroids, a quarter dead; n is not a
    multiple of 256, so the last block holds padding."""
    g = torch.Generator().manual_seed(seed)
    cen = ts.tri_p[0].mean(1)
    a = cen[torch.randint(0, ts.num_tris, (n,), generator=g)]
    b = cen[torch.randint(0, ts.num_tris, (n,), generator=g)]
    d = (b - a) / (b - a).norm(dim=1, keepdim=True).clamp(min=1e-6)
    mx = torch.where(torch.rand(n, generator=g) < 0.25, torch.zeros(n),
                     torch.full((n,), float('inf')))
    return a, d, torch.full((n,), 1e-2), mx


@pytest.fixture(scope='module', params=['scene', 'ties'])
def case(request, scenes):
    """(pack, ids, chunk_lo, chunk_hi, sorted padded rays org, d, rng)."""
    _, ts = scenes
    if request.param == 'scene':
        tables = (ts.cw.pack, ts.cw.ids, ts.cw.chunk_lo, ts.cw.chunk_hi)
        rays = _scene_rays(ts)
    else:
        *tables, rays = planted_tie_case(ts)
    (o, d, rng), _ = cw.sort_rays(ts.cw, *rays)
    return request.param, (*tables, o, d, rng)


def _bounds(K, S):
    return [(s * K // S, (s + 1) * K // S) for s in range(S)]


def _range_lists(org, d, rng, lo, hi, S):
    """The kernel's list rule: for each block and range, the slab test of
    the block's rays against each chunk of the range, OR over the rays,
    then the hit chunk ids in ascending order. Returns [blocks][ranges] of
    id lists."""
    nb = org.shape[0] // cw.RAY_BLOCK
    safe = torch.where(d.abs() < 1e-12,
                       torch.where(d < 0, torch.full_like(d, -1e-12),
                                   torch.full_like(d, 1e-12)), d)
    inv = 1.0 / safe
    mn, mx = rng[:, 0], rng[:, 1]
    out = []
    for blk in range(nb):
        r = slice(blk * cw.RAY_BLOCK, (blk + 1) * cw.RAY_BLOCK)
        per_range = []
        for c0, c1 in _bounds(lo.shape[0], S):
            hits = []
            for c in range(c0, c1):
                t0 = (lo[c] - org[r]) * inv[r]
                t1 = (hi[c] - org[r]) * inv[r]
                tn = torch.minimum(t0, t1).amax(1)
                tf = torch.maximum(t0, t1).amin(1)
                hit = ((tn <= tf) & (tf >= mn[r]) & (tn <= mx[r])
                       & (mx[r] >= mn[r]))
                if bool(hit.any()):
                    hits.append(c)
            per_range.append(hits)
        out.append(per_range)
    return out


def _split_walk(pack, ids, org, d, rng, lo, hi, any_hit, S):
    """Each range walked on its own (walk_reference over the range's
    lists), then merged: ascending ranges, strict < (any hit: OR)."""
    nb = org.shape[0] // cw.RAY_BLOCK
    K = pack.shape[0]
    lists = _range_lists(org, d, rng, lo, hi, S)
    merged = None
    for s in range(S):
        idx = torch.zeros((nb, K), dtype=torch.int32)
        counts = torch.zeros(nb, dtype=torch.int32)
        for blk in range(nb):
            ll = lists[blk][s]
            idx[blk, :len(ll)] = torch.tensor(ll, dtype=torch.int32)
            counts[blk] = len(ll)
        part = cw.walk_reference(pack, ids, idx, counts, org, d, rng,
                                 any_hit)
        if merged is None:
            merged = part
        elif any_hit:
            merged = merged | part
        else:
            better = part[0] < merged[0]
            merged = tuple(torch.where(better, p, m)
                           for p, m in zip(part, merged))
    return merged


@pytest.mark.parametrize('which', ['first', 'second', 'third', 'last'])
def test_split_merge_matches_walk_reference(case, which):
    name, (pack, ids, lo, hi, o, d, rng) = case
    K = pack.shape[0]
    S = {'first': 1, 'second': 2, 'third': 3, 'last': K}[which]
    chunk_idx, counts = cw._block_chunk_lists(o, d, rng[:, 0], rng[:, 1],
                                              lo, hi)
    want = cw.walk_reference(pack, ids, chunk_idx, counts, o, d, rng, False)
    got = _split_walk(pack, ids, o, d, rng, lo, hi, False, S)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    occ = _split_walk(pack, ids, o, d, rng, lo, hi, True, S)
    assert torch.equal(occ, cw.walk_reference(pack, ids, chunk_idx, counts,
                                              o, d, rng, True))
    hit = want[0] < cw.BIG
    assert hit.any() and (~hit).any()
    if name == 'ties':
        # the chunk-0 copy with id -2 beats id -3 of the last chunk and its
        # own original: the tie rules decided these hits
        assert (want[1][hit] == -2).float().mean() > 0.9


@pytest.mark.parametrize('which', ['one', 'three', 'all'])
def test_range_lists_match_block_chunk_lists(case, which):
    name, (pack, ids, lo, hi, o, d, rng) = case
    K = pack.shape[0]
    S = {'one': 1, 'three': 3, 'all': K}[which]
    chunk_idx, counts = cw._block_chunk_lists(o, d, rng[:, 0], rng[:, 1],
                                              lo, hi)
    lists = _range_lists(o, d, rng, lo, hi, S)
    assert len(lists) == counts.shape[0]
    for blk, per_range in enumerate(lists):
        flat = [c for ll in per_range for c in ll]
        assert flat == to_np(chunk_idx[blk, :counts[blk]]).tolist()
    # dead and padding rays sort last and leave a trailing empty list
    assert int(counts[-1]) == 0
    assert not (rng[-cw.RAY_BLOCK:, 1] >= rng[-cw.RAY_BLOCK:, 0]).any()


@pytest.mark.parametrize('form', ['staged', 'resident'])
def test_staged_walk_on_cpu_is_the_plain_version(case, form):
    _, (pack, ids, lo, hi, o, d, rng) = case
    walk = {'staged': cw.walk_staged, 'resident': cw.walk_resident}[form]
    tracing.reset_launches()
    chunk_idx, counts = cw._block_chunk_lists(o, d, rng[:, 0], rng[:, 1],
                                              lo, hi)
    got = walk(pack, ids, lo, hi, o, d, rng, False)
    want = cw.walk_reference(pack, ids, chunk_idx, counts, o, d, rng, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(walk(pack, ids, lo, hi, o, d, rng, True),
                       cw.walk_reference(pack, ids, chunk_idx, counts, o, d,
                                         rng, True))
    assert not any(cw.launch_counts.values())


@pytest.mark.parametrize('blocks,chunks', [(256, 193), (17, 193), (1, 7),
                                           (4, 5000), (3, 0)])
def test_split_count_fills_the_card_within_the_range_limit(blocks, chunks):
    S = cw.split_count(blocks, chunks)
    assert 1 <= S
    assert S * cw.MAX_RANGE >= chunks
    assert S <= max(chunks, 1)
    assert blocks * S >= min(cw.SPLIT_CTAS, blocks * max(chunks, 1))


@pytest.mark.parametrize('resident', [False, True])
def test_intersect_chunkwalk_matches_jax_bruteforce(scenes, resident):
    js, ts = scenes
    org, d, mn, mx = _scene_rays(ts, n=600, seed=9)
    z = torch.zeros(org.shape[0])
    with torch.no_grad():
        hp, tp, ttp, _, _ = (to_np(x) for x in cw.intersect_chunkwalk(
            ts, org, d, z, mn, mx, resident=resident))
        occ = to_np(cw.occluded_chunkwalk(ts, org, d, z, mn, mx,
                                          resident=resident))
    hb, tb, ttb, _, _ = (np.asarray(x) for x in jax_isect.intersect_bruteforce(
        js, *(jnp.asarray(to_np(x)) for x in (org, d, z, mn, mx))))
    np.testing.assert_array_equal(hp, hb)
    same = tp == tb
    assert same[hb].mean() >= 0.995
    sel = hb & same
    np.testing.assert_allclose(ttp[sel], ttb[sel], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(occ, hb)
    assert hb.any() and not hp[to_np(mx) == 0].any()


def test_resident_walk_matches_jax_resident_kernel(scenes, monkeypatch):
    """The resident form's CPU path against the JAX walk with the pack held
    resident (_walk_kernel_resident in interpret mode): equal hit sets,
    triangle ids and occlusion, t / u / v within the atol of
    tests/test_torch_intersect.py (XLA contracts and reorders the Woop
    projection's f32 products, torch rounds op by op)."""
    js, ts = scenes
    rng = np.random.default_rng(29)
    tp = to_np(ts.tri_p[0]).astype(np.float64)
    n = 600
    p = tp[rng.integers(0, tp.shape[0], n)]
    b = rng.uniform(0, 1, (n, 2))
    b = np.where(b.sum(1, keepdims=True) > 1, 1 - b, b)
    org = p[:, 0] * (1 - b.sum(1))[:, None] + p[:, 1] * b[:, :1] \
        + p[:, 2] * b[:, 1:]
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mx = np.where(rng.uniform(size=n) < 0.3, 0.0, np.inf)
    rays = [x.astype(np.float32) for x in (org, d, np.zeros(n),
                                           np.full(n, 1e-2), mx)]
    monkeypatch.setattr(jax_cw, 'VMEM_RESIDENT_BYTES', 6 * 1024 * 1024)
    jargs = [jnp.asarray(x) for x in rays]
    hj, tj, ttj, uj, vj = (np.asarray(x) for x in
                           jax_cw.intersect_chunkwalk(js, *jargs))
    occ_j = np.asarray(jax_cw.occluded_chunkwalk(js, *jargs))
    targs = [torch.as_tensor(x) for x in rays]
    tracing.reset_launches()
    with torch.no_grad():
        hp, tp_, ttp, up, vp = (to_np(x) for x in cw.intersect_chunkwalk(
            ts, *targs, resident=True))
        occ = to_np(cw.occluded_chunkwalk(ts, *targs, resident=True))
    assert not any(cw.launch_counts.values())
    np.testing.assert_array_equal(hp, hj)
    np.testing.assert_array_equal(tp_[hp], tj[hj])
    np.testing.assert_allclose(ttp[hp], ttj[hj], rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(up[hp], uj[hj], atol=2e-3)
    np.testing.assert_allclose(vp[hp], vj[hj], atol=2e-3)
    np.testing.assert_array_equal(occ, occ_j)
    assert hp.any() and not hp[mx == 0].any()
