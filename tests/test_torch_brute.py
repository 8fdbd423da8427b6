"""The brute-force queries (ops/intersect.py intersect_bruteforce /
occluded_bruteforce) and their kernel, csrc/brute.cu (no JAX in this
file, so it also runs on a machine with a card and no JAX):

* on CPU tensors the wrappers run the plain version (_bruteforce_block
  over the live rays) and count no launch; the plain version, written in
  the kernel's order (tri_test_ordered), finds the hits and triangles
  that Moller-Trumbore through torch's cross product and sum finds, t
  within rtol 1e-5 (the two round apart);
* on a card (marked `cuda`, skipped elsewhere): the kernel equals the
  plain version bit for bit (t, id, u, v; occluded), closest and any
  hit, on the small box and the small moving open scene at 65,536 and
  4,260 rays, whatever its number of tile ranges; on exact copies of a
  triangle planted 40 and 131 ids on (the smaller id wins); on rays that
  are all dead or dead by whole blocks; on rays from 1e37 away with
  max_t = inf; one launch counted per query; inputs the kernel does not
  take raise;
* on a card, a brute-force query and a matmul-sweep query captured in a
  CUDA graph and replayed equal the eager ones: neither reads the host.
"""

import dataclasses

import pytest
import torch

from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.ops import brute_tiles, intersect
from langevin_mcmc_tpu_torch.parallel.mesh import ChainMesh, replicate
from langevin_mcmc_tpu_torch.scene.parse import parse_scene
from langevin_mcmc_tpu_torch.utils import vecmath as vm

torch.set_num_threads(1)
LARGE_RAYS = 4260   # the large step's lanes at 65,536 chains


@pytest.fixture(scope='module', params=['static', 'motion'])
def scene(request, tmp_path_factory):
    """The small box or the small moving open scene, on the CPU."""
    kw = dict(scene='open', motion=True) if request.param == 'motion' \
        else {}
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('brute')),
                                 small=True, width=32, height=24, **kw)
    sc = parse_scene(xml, device='cpu')[0]
    assert sc.has_motion == (request.param == 'motion')
    assert sc.num_tris > 2 * intersect.BRUTE_RAYS
    # a static scene carries the kernel's tables only when built for
    # LMCMC_ISECT_BACKEND=brute
    return sc if sc.has_motion else brute_tiles.attach(sc)


def _rays(scene, n, device, seed=5):
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
    return [x.to(device) for x in (a, d, time, mn, mx)]


def _plain(scene, rays):
    """The plain version over every ray: (t, id, u, v), t = inf where
    nothing is hit."""
    return intersect._bruteforce_live(scene, *rays)


def test_cpu_runs_the_plain_version_without_launches(scene):
    intersect.reset_launch_counts()
    rays = _rays(scene, 1000, 'cpu')
    hit, tid, t, u, v = intersect.intersect_bruteforce(scene, *rays)
    occ = intersect.occluded_bruteforce(scene, *rays)
    pt, pid, pu, pv = _plain(scene, rays)
    assert torch.equal(hit, torch.isfinite(pt)) and torch.equal(occ, hit)
    assert hit.any() and (~hit).any()
    assert torch.equal(tid, pid) and torch.equal(u, pu) and torch.equal(v, pv)
    assert torch.equal(t, torch.where(hit, pt, torch.zeros_like(pt)))
    assert not (tid[~hit].any() or u[~hit].any() or v[~hit].any())
    assert not (hit & (rays[4] < rays[3])).any()
    assert not any(intersect.launch_counts.values())


def test_plain_version_agrees_with_torch_moller_trumbore(scene):
    """The kernel-order test against moller_trumbore (torch's cross and
    sum) on the same lerped vertices: the same hits and triangles, t, u, v
    to rounding."""
    org, d, time, mn, mx = _rays(scene, 600, 'cpu', seed=8)
    T = scene.num_tris
    ids = torch.arange(T)
    tp = intersect.tri_vertices_at_time(
        scene, ids[None].expand(600, T), time[:, None].expand(600, T))
    p0 = tp[..., 0, :]
    t, u, v, div = intersect.moller_trumbore(
        org[:, None], d[:, None], p0, tp[..., 1, :] - p0, tp[..., 2, :] - p0)
    ok = ((div != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= mn[:, None]) & (t <= mx[:, None]))
    t = torch.where(ok, t, torch.full_like(t, float('inf')))
    want_t, want_id = t.min(1)
    got_t, got_id, got_u, got_v = _plain(scene, (org, d, time, mn, mx))
    hit = torch.isfinite(want_t)
    assert torch.equal(torch.isfinite(got_t), hit) and hit.sum() > 100
    assert torch.equal(got_id[hit], want_id[hit].int())
    torch.testing.assert_close(got_t[hit], want_t[hit], rtol=1e-5, atol=0)
    rows = torch.arange(600)[hit]
    for got, w in ((got_u, u), (got_v, v)):
        torch.testing.assert_close(got[hit], w[rows, want_id[hit]],
                                   rtol=0, atol=1e-4)


def _on_card(scene):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return replicate(ChainMesh((torch.device('cuda'),), 0, 1), scene)[0]


def _kernel_equals_plain(sc, rays, any_hit, splits=None):
    """The kernel (one query, one launch counted) against the plain
    version on the card, bit for bit. Returns the plain version's (t, id,
    u, v)."""
    intersect.reset_launch_counts()
    got = intersect.brute_force(sc, *rays, any_hit=any_hit, splits=splits)
    want = _plain(sc, rays)
    torch.cuda.synchronize()
    if any_hit:
        assert torch.equal(got, torch.isfinite(want[0]))
    else:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    key = 'any_hit' if any_hit else 'closest_hit'
    assert intersect.launch_counts == {k: int(k == key)
                                       for k in intersect.launch_counts}
    return want


@pytest.mark.cuda
@pytest.mark.parametrize('n', [65536, LARGE_RAYS])
@pytest.mark.parametrize('any_hit', [False, True])
def test_kernel_matches_plain_on_card(scene, any_hit, n):
    sc = _on_card(scene)
    rays = _rays(sc, n, 'cuda')
    want = _kernel_equals_plain(sc, rays, any_hit)
    hit = torch.isfinite(want[0])
    assert hit.any() and (~hit & (rays[4] >= rays[3])).any()
    # the query wrappers: the same answer through intersect_bruteforce
    h, tid, t, u, v = intersect.intersect_bruteforce(sc, *rays)
    assert torch.equal(h, hit) and torch.equal(tid, want[1])
    assert torch.equal(intersect.occluded_bruteforce(sc, *rays), hit)
    with pytest.raises(ValueError):
        intersect.brute_force(sc, rays[0].double(), *rays[1:],
                              any_hit=any_hit)


@pytest.mark.cuda
@pytest.mark.parametrize('any_hit', [False, True])
def test_kernel_splits_on_card(scene, any_hit):
    """1, 2, 3 and every tile's triangle ranges, and the default, give the
    same answer."""
    sc = _on_card(scene)
    rays = _rays(sc, LARGE_RAYS, 'cuda', seed=3)
    tiles = -(-sc.num_tris // intersect.BRUTE_RAYS)
    for s in sorted({1, 2, 3, tiles, intersect.brute_splits(LARGE_RAYS,
                                                           sc.num_tris)}):
        _kernel_equals_plain(sc, rays, any_hit, splits=s)
    with pytest.raises(ValueError):
        intersect.brute_force(sc, *rays, any_hit=any_hit, splits=tiles + 1)


@pytest.mark.cuda
@pytest.mark.parametrize('where', ['one_tile', 'two_tiles'])
def test_kernel_planted_ties_on_card(scene, where):
    """Exact copies of a triangle (both keyframes) at a larger id, 40 or
    131 ids on (the same or the next 128-triangle range of ids), the
    kernel's tables rebuilt for the new triangles: rays onto it hit the
    original, the smallest id among the minimal t, in kernel and plain
    version alike."""
    sc = _on_card(scene)
    tie = 5
    at = tie + 40 if where == 'one_tile' else tie + intersect.BRUTE_RAYS + 3
    tp = sc.tri_p.clone()
    tp[:, at] = tp[:, tie]
    sc = brute_tiles.attach(dataclasses.replace(sc, tri_p=tp))
    n = 1000
    g = torch.Generator().manual_seed(4)
    b = torch.rand((n, 2), generator=g) * 0.4 + 0.1
    time = torch.rand(n, generator=g).cuda()
    v = vm.lerp(time[:, None, None], tp[0, tie], tp[1, tie])
    b = b.cuda()
    aim = v[:, 0] + b[:, :1] * (v[:, 1] - v[:, 0]) + b[:, 1:] * (
        v[:, 2] - v[:, 0])
    nrm = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    org = aim + 1e-2 * nrm
    rays = [org, -nrm, time, torch.full((n,), 1e-4, device='cuda'),
            torch.full((n,), float('inf'), device='cuda')]
    t, tid, _, _ = _kernel_equals_plain(sc, rays, False)
    _kernel_equals_plain(sc, rays, True)
    on = (tid == tie) & torch.isfinite(t)
    assert on.sum() > n // 2 and not (tid == at).any()


@pytest.mark.cuda
@pytest.mark.parametrize('any_hit', [False, True])
def test_kernel_dead_rays_on_card(scene, any_hit):
    """Every ray dead (no block tests a tile), and whole blocks of dead
    rays between live ones; NaN ranges are dead too."""
    sc = _on_card(scene)
    rays = _rays(sc, LARGE_RAYS, 'cuda', seed=6)
    dead = [x.clone() for x in rays]
    dead[4] = torch.zeros_like(dead[4])
    want = _kernel_equals_plain(sc, dead, any_hit)
    assert not torch.isfinite(want[0]).any()
    blocks = torch.arange(LARGE_RAYS, device='cuda') // intersect.BRUTE_RAYS
    rays[4] = torch.where(blocks % 3 == 1, torch.zeros_like(rays[4]),
                          rays[4])
    rays[3][::7] = float('nan')
    want = _kernel_equals_plain(sc, rays, any_hit)
    assert torch.isfinite(want[0]).any()
    assert not torch.isfinite(want[0][::7]).any()


@pytest.mark.cuda
@pytest.mark.parametrize('any_hit', [False, True])
def test_kernel_far_rays_on_card(scene, any_hit):
    """Rays from 1e37 away aimed at the scene, max_t = inf: products
    overflow to inf on the way; a t that is not finite is no hit."""
    sc = _on_card(scene)
    org, d, time, mn, mx = _rays(sc, LARGE_RAYS, 'cuda', seed=7)
    far = org - d * 1e37
    _kernel_equals_plain(sc, [far, d, time, mn,
                              torch.full_like(mx, float('inf'))], any_hit)


def _captured(fn):
    """fn() captured in a CUDA graph after an eager warm-up, and the
    graph's replay: (eager result, replayed result)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        want = fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    for o in out if isinstance(out, tuple) else (out,):
        o.zero_()
    g.replay()
    torch.cuda.synchronize()
    return want, out


@pytest.mark.cuda
def test_queries_capture_on_card(scene):
    """The brute-force kernel's queries and the matmul sweep hold no host
    read: each captured in a CUDA graph replays to the eager answer."""
    sc = _on_card(scene)
    rays = _rays(sc, LARGE_RAYS, 'cuda', seed=9)
    for fn in (intersect.intersect_bruteforce, intersect.occluded_bruteforce,
               intersect.intersect_matmul, intersect.occluded_matmul):
        want, got = _captured(lambda: fn(sc, *rays))
        for a, b in zip(*((x,) if torch.is_tensor(x) else x
                          for x in (want, got))):
            assert torch.equal(a, b), fn.__name__
