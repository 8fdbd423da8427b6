"""The culled brute force: the tables of ops/brute_tiles.py, its plain
version culled_reference (per-block tile lists, the per-ray and
per-pair decisions, ranges merged by the least (t, id)) and the kernel
csrc/brute.cu (no JAX in this file, so it also runs on a machine with a
card and no JAX):

* the tables: ids a permutation whose tiles are runs of the Morton
  order of the box centres, rows as the plain version rounds them, every
  tile's box holding its triangles at any shutter time, every normal
  group's band at least its triangles' screens; build_scene builds them
  for a static scene only under LMCMC_ISECT_BACKEND=brute;
* on the CPU, culled_reference equals the plain brute force
  (_bruteforce_live) bit for bit, t, id, u, v, and so its occlusion, on
  lcbox, the small moving box and the small moving open scene, for one
  and three tile ranges, and every pair whose test passes lies in a tile
  on its ray's block list and is tested by its ray;
* the same on planted hard cases: rays along a triangle's plane, rays
  leaving a surface point (tangent ones too), rays with clamped divisors
  (in-plane rays at tiny triangles), zero direction components, dead,
  NaN and non-unit rays (and times outside the shutter), min_t = -inf,
  and exact ties (a triangle and a copy whose test rounds to the same t)
  with the larger id in an earlier Morton tile;
* on a card (marked `cuda`, skipped elsewhere): the kernel (brute_force)
  equals the plain version bit for bit on the same cases, closest and
  any hit, at every tile range count S, and as a query captured in a
  CUDA graph.
"""

import dataclasses

import numpy as np
import pytest
import torch

from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.ops import brute_tiles, intersect
from langevin_mcmc_tpu_torch.ops.chunkwalk import _morton3
from langevin_mcmc_tpu_torch.parallel.mesh import ChainMesh, replicate
from langevin_mcmc_tpu_torch.scene.parse import parse_scene

torch.set_num_threads(1)
LCBOX = 'tests/data/lcbox.xml'
PLANTED = ('grazing', 'surface', 'clamped', 'axis', 'awkward', 'neg_inf',
           'ties')


@pytest.fixture(scope='module', params=['lcbox', 'box_motion', 'open_motion'])
def scene(request, tmp_path_factory):
    """lcbox (static), the small moving box or the small moving open
    scene, on the CPU."""
    if request.param == 'lcbox':
        xml = LCBOX
    else:
        kw = dict(scene='open') if request.param == 'open_motion' else {}
        xml = testscenes.write_scene(str(tmp_path_factory.mktemp('cull')),
                                     small=True, width=32, height=24,
                                     motion=True, **kw)
    sc = parse_scene(xml, device='cpu')[0]
    assert sc.has_motion == (request.param != 'lcbox')
    return sc if sc.has_motion else brute_tiles.attach(sc)


def _rays(scene, n, seed):
    """Rays from triangle centroids (keyframe 0) towards others, at random
    shutter times, a quarter dead: (org, d, time, min_t, max_t)."""
    g = torch.Generator().manual_seed(seed)
    cen = scene.tri_p[0].mean(1)
    a = cen[torch.randint(0, scene.num_tris, (n,), generator=g)]
    b = cen[torch.randint(0, scene.num_tris, (n,), generator=g)]
    d = b - a
    d = d / d.norm(dim=1, keepdim=True).clamp(min=1e-6)
    time = torch.rand(n, generator=g)
    mn = torch.full((n,), 1e-2)
    mx = torch.where(torch.rand(n, generator=g) < 0.25, torch.zeros(n),
                     torch.full((n,), float('inf')))
    return [a, d, time, mn, mx]


def _verts(scene, tri, time):
    """Vertices [n, 3, 3] of triangles tri at `time`, as the test sees
    them (vm.lerp on a moving scene)."""
    return intersect.tri_vertices_at_time(scene, tri, time)


def _culled_equals_plain(scene, rays, splits=1):
    """culled_reference against _bruteforce_live, bit for bit, every
    valid pair tested. Returns (the plain version's (t, id, u, v), the
    stats)."""
    want = intersect._bruteforce_live(scene, *rays)
    stats = {}
    got = brute_tiles.culled_reference(scene, *rays, splits=splits,
                                       stats=stats)
    for a, b, f in zip(got, want, 'tiuv'):
        assert torch.equal(a, b), (f, int((a != b).sum()))
    assert stats['missed'] == 0
    return want, stats


def test_tables(scene):
    bt = scene.brute
    T = scene.num_tris
    K = bt.tiles.shape[0]
    assert bt.tri_p is scene.tri_p and bt.motion == scene.has_motion
    ids = bt.ids[:T].long()
    assert torch.equal(torch.sort(ids)[0], torch.arange(T))
    assert (bt.ids[T:] == -1).all()
    assert torch.equal(bt.tris[:T, 0, 3].view(torch.int32).long(), ids)
    tp = scene.tri_p[:, ids]
    if scene.has_motion:
        assert torch.equal(bt.tris[:T, 0:3, :3], tp[0])
        assert torch.equal(bt.tris[:T, 3:6, :3], tp[1])
        verts = tp
    else:
        assert torch.equal(bt.tris[:T, 0, :3], tp[0, :, 0])
        assert torch.equal(bt.tris[:T, 1, :3], tp[0, :, 1] - tp[0, :, 0])
        assert torch.equal(bt.tris[:T, 2, :3], tp[0, :, 2] - tp[0, :, 0])
        verts = tp[:1]
    # Morton order of the box centres (both keyframes on a moving scene)
    v = verts.double().numpy()
    cen = 0.5 * (v.min(axis=(0, 2)) + v.max(axis=(0, 2)))
    lo, span = cen.min(0), np.maximum(cen.max(0) - cen.min(0), 1e-12)
    q = np.clip(((cen - lo) / span * 1023).astype(np.int64), 0, 1023)
    codes = _morton3(q[:, 0], q[:, 1], q[:, 2])
    K_ = -(-T // brute_tiles.TILE)
    runs = [codes[k * brute_tiles.TILE:(k + 1) * brute_tiles.TILE]
            for k in range(K_)]
    assert all(a.max() <= b.min() for a, b in zip(runs, runs[1:]))
    # every tile's box holds its triangles' f32 lerps at any time
    g = torch.Generator().manual_seed(0)
    times = torch.cat([torch.tensor([0.0, 1.0]), torch.rand(30, generator=g)])
    tile = torch.arange(T) // brute_tiles.TILE
    lo3, hi3 = bt.tiles[tile, 0, :3], bt.tiles[tile, 1, :3]
    for tm in times if scene.has_motion else times[:1]:
        w = _verts(scene, ids, torch.full((T,), float(tm)))
        assert (w >= lo3[:, None]).all() and (w <= hi3[:, None]).all()
    # screens: unit normals, thresholds in (0, 1) or every ray's; bands at
    # least their triangles' screens
    sig = bt.screen[:, :T, 3]
    assert ((sig > 0) & (sig < 1) | (sig == brute_tiles.ALWAYS)).all()
    nrm = bt.screen[:, :T, :3].norm(dim=-1)
    assert torch.allclose(nrm, torch.ones_like(nrm), atol=1e-6)
    group = torch.arange(T) % brute_tiles.TILE // brute_tiles.GROUP
    tau = bt.bands[:, tile, group, 3]
    assert (tau >= sig).all()
    assert bt.tiles.shape == (K, 3, 4) and K == -(-T // brute_tiles.TILE)


def test_static_tables_only_for_the_brute_backend(monkeypatch):
    """build_scene builds the kernel's tables for a static scene only
    when LMCMC_ISECT_BACKEND=brute, and then the same as attach."""
    monkeypatch.delenv('LMCMC_ISECT_BACKEND', raising=False)
    assert parse_scene(LCBOX, device='cpu')[0].brute is None
    monkeypatch.setenv('LMCMC_ISECT_BACKEND', 'brute')
    sc = parse_scene(LCBOX, device='cpu')[0]
    bt, want = sc.brute, brute_tiles.attach(sc).brute
    assert bt.tri_p is sc.tri_p and not bt.motion
    # bit for bit (the padding slots' id -1 is a NaN in tris)
    for f in ('tris', 'ids', 'screen', 'tiles', 'bands'):
        assert torch.equal(getattr(bt, f).view(torch.int32),
                           getattr(want, f).view(torch.int32)), f
    assert (bt.kappa, bt.mu) == (want.kappa, want.mu)


@pytest.mark.parametrize('splits', [1, 3])
def test_culled_equals_plain(scene, splits):
    rays = _rays(scene, 2000, seed=splits)
    want, stats = _culled_equals_plain(scene, rays, splits)
    hit = torch.isfinite(want[0])
    assert hit.sum() > 500 and (~hit & (rays[4] >= rays[3])).any()
    # with more than one tile the culled query tests fewer pairs than
    # every live ray x triangle
    if scene.brute.tiles.shape[0] > 1:
        assert stats['tested'].sum() < stats['live'] * scene.num_tris
    # query_stats counts the same lists and pairs without the tests
    qs = brute_tiles.query_stats(scene, *rays, ray_chunk=700, tri_chunk=300)
    assert qs['tested'] == int(stats['tested'].sum())
    assert qs['list_mean'] == float(stats['lists'].sum(1).double().mean())
    assert (qs['live'], qs['full']) == (stats['live'], stats['full'])


def test_accepted_pairs_lie_on_the_lists(scene):
    """Every (ray, triangle) pair of the full brute force whose test
    passes lies in a tile on its ray's block list, and its ray needs the
    pair (the tile whole, or its normal group grazed and the pair
    screened in)."""
    org, d, time, mn, mx = _rays(scene, 1024, seed=11)
    bt = scene.brute
    T = scene.num_tris
    rt = brute_tiles.ray_terms(bt, org, d, time, mn, mx)
    hit, graze = brute_tiles.tile_need(bt, org, rt, mn, mx)
    lists = (hit | graze.any(-1)).reshape(-1, brute_tiles.TILE,
                                          bt.tiles.shape[0]).any(1)
    valid = brute_tiles._pair_tests(bt, org, d, time, mn, mx, 0, T)[0]
    r, j = torch.nonzero(valid, as_tuple=True)
    k, g = j // brute_tiles.TILE, j % brute_tiles.TILE // brute_tiles.GROUP
    assert r.numel() > 300
    assert lists[r // brute_tiles.TILE, k].all()
    scr = brute_tiles.screened(bt, rt, 0, T)
    assert (hit[r, k] | (graze[r, k, g] & scr[r, j])).all()


def _with_tris(scene, extra):
    """scene with the triangles extra [2, n, 3, 3] appended (ids T..),
    its brute-force tables rebuilt."""
    tp = torch.cat([scene.tri_p, extra.to(scene.tri_p)], 1)
    return brute_tiles.attach(dataclasses.replace(
        scene, tri_p=tp, num_tris=tp.shape[1]))


def _unit(x):
    return x / x.norm(dim=-1, keepdim=True)


def _grazing(scene, g):
    """Rays along the planes of random triangles at their time: a third
    from in-plane points inside the triangle, a third beside it, lifted
    off the plane by 0 to 1e-4 of its size and tilted by 0 to 1e-3, and a
    third in the plane up to 300 triangle sizes away (the test accepts
    some of these with a t far from the triangle: only the screen finds
    them)."""
    n = 3072
    tri = torch.randint(0, scene.num_tris, (n,), generator=g)
    time = torch.rand(n, generator=g)
    w = _verts(scene, tri, time)
    e1, e2 = w[:, 1] - w[:, 0], w[:, 2] - w[:, 0]
    nrm = _unit(torch.linalg.cross(e1, e2))
    size = e1.norm(dim=1)
    third = torch.arange(n) * 3 // n
    ab = torch.where((third == 0)[:, None],
                     torch.rand((n, 2), generator=g) * 0.5,
                     (torch.rand((n, 2), generator=g) * 2 - 1)
                     * torch.where(third == 1, 3.0, 300.0)[:, None])
    p = w[:, 0] + ab[:, :1] * e1 + ab[:, 1:] * e2
    c = torch.randn((n, 2), generator=g)
    d = _unit(c[:, :1] * e1 + c[:, 1:] * e2)
    lift = torch.tensor([0.0, 0.0, 1e-7, 1e-6, 1e-5, 1e-4])[
        torch.randint(0, 6, (n,), generator=g)] * (third == 1)
    tilt = torch.tensor([0.0, 0.0, 1e-7, 1e-5, 1e-3])[
        torch.randint(0, 5, (n,), generator=g)] * (third == 1)
    d = _unit(d + tilt[:, None] * nrm)
    back = torch.where(third == 2, 20.0, 2.0) * size
    org = p + (lift * size)[:, None] * nrm - d * back[:, None]
    mn = torch.tensor([0.0, 1e-4, -1.0])[torch.randint(0, 3, (n,),
                                                         generator=g)]
    return [org, d, time, mn, torch.full((n,), float('inf'))]


def _surface(scene, g):
    """Rays leaving surface points of random triangles at their time:
    random directions, tangent ones and near-tangent ones; min_t 0,
    1e-4 or -1e-3."""
    n = 2048
    tri = torch.randint(0, scene.num_tris, (n,), generator=g)
    time = torch.rand(n, generator=g)
    w = _verts(scene, tri, time)
    b = torch.rand((n, 2), generator=g)
    b = torch.where((b.sum(1) > 1)[:, None], 1 - b, b)
    e1, e2 = w[:, 1] - w[:, 0], w[:, 2] - w[:, 0]
    org = w[:, 0] + b[:, :1] * e1 + b[:, 1:] * e2
    nrm = _unit(torch.linalg.cross(e1, e2))
    d = _unit(torch.randn((n, 3), generator=g))
    tangent = _unit(d - (d * nrm).sum(1, keepdim=True) * nrm)
    kind = torch.randint(0, 3, (n,), generator=g)
    d = torch.where((kind == 1)[:, None], tangent, d)
    d = torch.where((kind == 2)[:, None], _unit(tangent + 1e-6 * nrm), d)
    mn = torch.tensor([0.0, 1e-4, -1e-3])[torch.randint(0, 3, (n,),
                                                          generator=g)]
    return [org, d, time, mn, torch.full((n,), float('inf'))]


def _tiny_triangles(scene, g, m=24):
    """m triangles with edges of 1e-4 of the scene's size at random
    points (both keyframes the same): their divisors for in-plane rays
    fall below the test's 1e-12 clamp."""
    v = scene.tri_p[0].reshape(-1, 3)
    lo, hi = v.min(0)[0], v.max(0)[0]
    c = lo + torch.rand((m, 3), generator=g) * (hi - lo)
    s = 1e-4 * (hi - lo).max()
    e = torch.randn((m, 2, 3), generator=g) * s
    t = torch.stack([c, c + e[:, 0], c + e[:, 1]], 1)
    return torch.stack([t, t]), c


def _clamped(scene, g):
    """Rays along the planes of tiny triangles (_tiny_triangles, planted
    at the end of the scene) from every side: clamped divisors."""
    extra, c = _tiny_triangles(scene, g)
    sc = _with_tris(scene, extra)
    m = extra.shape[1]
    n = m * 64
    tri = torch.arange(scene.num_tris, scene.num_tris + m).repeat(64)
    time = torch.where(torch.rand(n, generator=g) < 0.5, torch.zeros(n),
                       torch.rand(n, generator=g))
    w = _verts(sc, tri, time)
    e1, e2 = w[:, 1] - w[:, 0], w[:, 2] - w[:, 0]
    cc = torch.randn((n, 2), generator=g)
    d = _unit(cc[:, :1] * e1 + cc[:, 1:] * e2)
    ab = torch.rand((n, 2), generator=g) * 0.4 + 0.1
    org = w[:, 0] + ab[:, :1] * e1 + ab[:, 1:] * e2 - d * 0.5
    rays = [org, d, time, torch.zeros(n), torch.full((n,), float('inf'))]
    # the planted pairs' divisors: some nonzero ones under the clamp
    _, _, _, div = intersect.tri_test_ordered(org, d, w[:, 0], e1, e2)
    assert ((div != 0) & (div.abs() < 1e-12)).sum() > n // 8
    return sc, rays


def _axis(scene, g):
    """Directions with zero components (the axes, both signs, -0.0
    components, and unit vectors in the coordinate planes) from random
    points of the scene's box and from triangle centroids."""
    n = 2048
    v = scene.tri_p[0].reshape(-1, 3)
    lo, hi = v.min(0)[0], v.max(0)[0]
    org = lo + torch.rand((n, 3), generator=g) * (hi - lo)
    cen = scene.tri_p[0].mean(1)
    half = n // 2
    org[:half] = cen[torch.randint(0, scene.num_tris, (half,), generator=g)]
    axes = torch.cat([torch.eye(3), -torch.eye(3)])
    d = axes[torch.randint(0, 6, (n,), generator=g)]
    d = torch.where(d == 0, torch.where(torch.rand((n, 3), generator=g)
                                        < 0.5, -0.0, 0.0), d)
    plane = _unit(torch.randn((n, 3), generator=g)
                  * axes[torch.randint(0, 3, (n,), generator=g)].eq(0))
    d = torch.where((torch.arange(n) % 3 == 0)[:, None], plane, d)
    time = torch.rand(n, generator=g)
    return [org, d, time, torch.full((n,), 1e-4),
            torch.full((n,), float('inf'))]


def _awkward(scene, g):
    """Dead rays (max_t < min_t, NaN ranges) between live ones, NaN and
    infinite origins and directions, zero, short and long directions,
    and times outside the shutter."""
    org, d, time, mn, mx = _rays(scene, 2048, seed=int(
        torch.randint(0, 1 << 30, (1,), generator=g)))
    k = torch.arange(2048) % 12
    mx = torch.where(k == 0, torch.full_like(mx, -1.0), mx)
    mn = torch.where(k == 1, torch.full_like(mn, float('nan')), mn)
    mx = torch.where(k == 2, torch.full_like(mx, float('nan')), mx)
    org = torch.where((k == 3)[:, None], torch.full_like(org, float('nan')),
                      org)
    d = torch.where((k == 4)[:, None], torch.full_like(d, float('inf')), d)
    d = torch.where((k == 5)[:, None], torch.zeros_like(d), d)
    d = torch.where((k == 6)[:, None], d * 1e-3, d)
    d = torch.where((k == 7)[:, None], d * 10.0, d)
    org = torch.where((k == 8)[:, None], org - d * 1e30, org)
    time = torch.where(k == 9, torch.full_like(time, -0.25), time)
    time = torch.where(k == 10, torch.full_like(time, 1.5), time)
    # whole dead blocks (rays 1,536-2,047: four blocks of TILE)
    mx = torch.where(torch.arange(2048) >= 1500, torch.full_like(mx, -1.0),
                     mx)
    return [org, d, time, mn, mx]


def _neg_inf(scene, g):
    """min_t = -inf (and finite max_t) on random rays."""
    org, d, time, mn, mx = _rays(scene, 2048, seed=int(
        torch.randint(0, 1 << 30, (1,), generator=g)))
    mn = torch.where(torch.arange(2048) % 2 == 0,
                     torch.full_like(mn, float('-inf')), mn)
    mx = torch.where(torch.arange(2048) % 4 == 1, torch.full_like(mx, 2.0),
                     torch.full_like(mx, float('inf')))
    return [org, d, time, mn, mx]


def _exact_double(p0, p2):
    """p0 + 2 (p2 - p0) in f32 where its edge from p0 is exactly twice
    p2 - p0, else None."""
    e = p2 - p0
    q = p0 + 2.0 * e
    return q if torch.equal(q - p0, 2.0 * e) else None


def _ties(scene, g):
    """A copy of a triangle X whose second edge is doubled (exactly, in
    f32, at both keyframes) at a larger id: the test on it rounds to X's
    t and u (v halved), so rays onto X tie; the copy is chosen so that it
    sits in an earlier Morton tile than X. Rays at shutter times 0 and 1
    (the lerp is exact there). Returns (scene, rays, X, copy's id)."""
    if scene.brute.tiles.shape[0] == 1:
        # one tile (lcbox): 256 more triangles at random points first
        v = scene.tri_p[0].reshape(-1, 3)
        lo, hi = v.min(0)[0], v.max(0)[0]
        t = lo + torch.rand((256, 3, 3), generator=g) * (hi - lo)
        scene = _with_tris(scene, torch.stack([t, t]))
    T = scene.num_tris
    tp = scene.tri_p
    for x in torch.randperm(T, generator=g).tolist():
        q = [_exact_double(tp[k, x, 0], tp[k, x, 2]) for k in (0, 1)]
        if any(v is None for v in q):
            continue
        copy = tp[:, x].clone()
        copy[0, 2], copy[1, 2] = q
        sc = _with_tris(scene, copy[:, None])
        slot = torch.argsort(sc.brute.ids[:T + 1].long())
        if slot[T] // brute_tiles.TILE < slot[x] // brute_tiles.TILE:
            break
    else:
        pytest.skip('no triangle whose doubled copy sorts into an earlier '
                    'tile')
    n = 512
    time = (torch.arange(n) % 2).float() if scene.has_motion \
        else torch.zeros(n)
    w = _verts(sc, torch.full((n,), x), time)
    b = torch.rand((n, 2), generator=g) * 0.4 + 0.1
    e1, e2 = w[:, 1] - w[:, 0], w[:, 2] - w[:, 0]
    aim = w[:, 0] + b[:, :1] * e1 + b[:, 1:] * e2
    nrm = _unit(torch.linalg.cross(e1, e2))
    side = torch.where(torch.arange(n) % 4 < 2, 1.0, -1.0)[:, None]
    org = aim + 1e-2 * side * nrm
    rays = [org, -side * nrm, time, torch.full((n,), 1e-4),
            torch.full((n,), float('inf'))]
    return sc, rays, x, T


def planted(scene, kind, seed=0):
    """(scene, rays) of one planted case."""
    g = torch.Generator().manual_seed(seed)
    if kind == 'clamped':
        return _clamped(scene, g)
    if kind == 'ties':
        return _ties(scene, g)[:2]
    fn = dict(grazing=_grazing, surface=_surface, axis=_axis,
              awkward=_awkward, neg_inf=_neg_inf)[kind]
    return scene, fn(scene, g)


@pytest.mark.parametrize('kind', PLANTED)
def test_planted_culled_equals_plain(scene, kind):
    sc, rays = planted(scene, kind)
    want, stats = _culled_equals_plain(sc, rays, splits=2)
    hit = torch.isfinite(want[0])
    if kind != 'awkward':
        assert hit.any()
    if kind == 'awkward':
        assert stats['full'] > 0
    if kind == 'neg_inf':
        assert stats['full'] >= 1024
    if kind == 'grazing' and sc.brute.tiles.shape[0] > 1:
        # pairs that pass the test outside their ray's padded slab (with
        # one tile, lcbox's, every live ray's slab passes)
        assert stats['grazed'] > 0


def test_planted_ties_go_to_the_smaller_id(scene):
    """The tie case: the original (smaller id) wins on every ray that
    hits it, though its copy (larger id) sits in an earlier tile and
    passes its test at the same t."""
    sc, rays, x, copy = _ties(scene, torch.Generator().manual_seed(0))
    want, _ = _culled_equals_plain(sc, rays, splits=2)
    t, tid = want[0], want[1]
    on = torch.isfinite(t) & (tid == x)
    assert on.sum() > len(t) // 2 and not (tid == copy).any()
    bt = sc.brute
    r = torch.nonzero(on)[:5, 0]
    valid, tc, _, _ = brute_tiles._pair_tests(
        bt, *(z[r] for z in rays), 0, sc.num_tris)
    slot_x = int(torch.nonzero(bt.ids == x)[0, 0])
    slot_c = int(torch.nonzero(bt.ids == copy)[0, 0])
    assert valid[:, slot_c].all() and torch.equal(tc[:, slot_c],
                                                  tc[:, slot_x])


# ---------------------------------------------------------------------------
# the kernel, on a card
# ---------------------------------------------------------------------------

def _on_card(sc):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return replicate(ChainMesh((torch.device('cuda'),), 0, 1), sc)[0]


def _kernel_equals_plain(sc, rays, splits=None):
    """brute_force, closest and any hit, against _bruteforce_live on the
    card, bit for bit."""
    rays = [x.cuda() for x in rays]
    want = intersect._bruteforce_live(sc, *rays)
    got = intersect.brute_force(sc, *rays, any_hit=False, splits=splits)
    occ = intersect.brute_force(sc, *rays, any_hit=True, splits=splits)
    torch.cuda.synchronize()
    for a, b, f in zip(got, want, 'tiuv'):
        assert torch.equal(a, b), (f, int((a != b).sum()))
    assert torch.equal(occ, torch.isfinite(want[0]))
    return want


@pytest.mark.cuda
@pytest.mark.parametrize('kind', PLANTED)
def test_kernel_planted_on_card(scene, kind):
    sc, rays = planted(scene, kind)
    _kernel_equals_plain(_on_card(sc), rays)


@pytest.mark.cuda
def test_kernel_splits_on_card(scene):
    """Every tile range count S from 1 to the tiles gives the plain
    version's answer."""
    sc = _on_card(scene)
    rays = _rays(scene, 4260, seed=3)
    K = sc.brute.tiles.shape[0]
    for s in sorted({1, min(2, K), min(3, K), K,
                     intersect.brute_splits(4260, sc.num_tris)}):
        _kernel_equals_plain(sc, rays, splits=s)
    with pytest.raises(ValueError):
        intersect.brute_force(sc, *(x.cuda() for x in rays), any_hit=False,
                              splits=K + 1)


@pytest.mark.cuda
def test_kernel_refuses_stale_tables_on_card(scene):
    sc = _on_card(scene)
    rays = [x.cuda() for x in _rays(scene, 256, seed=4)]
    moved = dataclasses.replace(sc, tri_p=sc.tri_p.clone())
    with pytest.raises(ValueError):
        intersect.brute_force(moved, *rays, any_hit=False)


@pytest.mark.cuda
def test_kernel_captured_on_card(scene):
    """The query captured in a CUDA graph replays to the eager answer:
    nothing in it reads the host."""
    sc = _on_card(scene)
    rays = [x.cuda() for x in _rays(scene, 4260, seed=9)]
    for any_hit in (False, True):
        fn = lambda: intersect.brute_force(sc, *rays, any_hit=any_hit)
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            want = fn()
        torch.cuda.current_stream().wait_stream(s)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = fn()
        outs = out if isinstance(out, tuple) else (out,)
        for o in outs:
            o.zero_()
        g.replay()
        torch.cuda.synchronize()
        for a, b in zip(want if isinstance(want, tuple) else (want,), outs):
            assert torch.equal(a, b)
