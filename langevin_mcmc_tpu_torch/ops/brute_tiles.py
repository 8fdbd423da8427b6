"""Tables of the brute-force kernel (csrc/brute.cu) and its culled plain
version.

The brute force (ops/intersect.py intersect_bruteforce) tests every live
ray against every triangle. The kernel computes the same function but
skips the (ray, triangle) pairs that cannot pass the test, so its tables
hold what that decision needs:

* triangles ordered by the Morton code of their box centre (over both
  keyframes on a moving scene), in tiles of TILE, each tile's triangles
  then put in GROUPS runs of GROUP like normals (a k-d split of their
  mid-shutter normals), with the original int32 ids beside them:
  ``tris`` [Tp, 3, 4] f32 (p0, e1 = p1 - p0, e2 = p2 - p0
  of keyframe 0, rounded as the plain version rounds them) on a static
  scene, [Tp, 6, 4] (v0, v1, v2 of keyframe 0, then of keyframe 1) on a
  moving one; lane 3 of row 0 holds the id's bits;
* per tile a box (``tiles`` [K, 3, 4]: lo and h1, hi and bmax, centre):
  the union over both keyframes of its vertices, padded so that it holds
  every triangle the test can see (the f32 lerp of the vertices at any
  time in [0, 1], the rounded edges);
* per triangle and shutter bin a normal and a threshold (``screen``
  [NB, Tp, 4]: n.xyz, sigma): a ray whose unit direction h has
  |h . n| >= sigma is not grazing the triangle (q >= Q_MIN below) at any
  time of the bin; sigma = 2 marks a triangle every ray must test;
* per tile, normal group and bin an axis and a threshold (``bands``
  [NB, K, GROUPS, 4]: a.xyz, tau): |h . a| >= tau proves that the ray
  grazes no triangle of the group.

Why a box alone is not enough, and what is. Let the test run in f32
(unit roundoff u = 2^-24) on s = o - p0, e1, e2 and the direction d, and
let q = |d . (e1 x e2)| / (|d|_1 |e1|_1 |e2|_1), the pair's conditioning
(zero for a ray in the triangle's plane). Every triple product of the
test is a cross product then a dot product, so each computed one is
within gamma6 |x|_1 |y|_1 |z|_1 of the exact one (gamma6 = 6u / (1 -
6u)), and the computed t, u, v are the quotients by the computed divisor
with two more roundings each. Cramer's identity then bounds the residual
of an accepted hit, the distance from o + t d to the triangle the test
sees:

    |o + t d - (p0 + u e1 + v e2)|_inf <= 32 u |o - p0|_1 / (q - gamma6)
                                          + u |o - p0|_inf,

and u, v >= 0, u + v <= 1 put p0 + u e1 + v e2 within 2u (|e1| + |e2|)
of the triangle. So for q >= Q_MIN an accepted hit lies within
kappa |o - p0|_1 of the tile's box (kappa = 2 x 32 u / (Q_MIN - gamma6)),
with t in [min_t, max_t]: the slab test against the box padded by
pad = kappa (|o - c|_1 + h1) + mu (|o|_inf + bmax) passes (mu = 16 u is
the slab test's own rounding; |o - p0|_1 <= |o - c|_1 + h1). For q <
Q_MIN the residual has no useful bound: a ray in the plane of a distant
triangle can pass its test with any t. The screen finds those pairs. For
a static triangle q >= |h . n| / (sqrt3 |e1|_1 |e2|_1 / |N|), so sigma
= sqrt3 Q_MIN |e1|_1 |e2|_1 / |N| (+ 1e-5 for the f32 dot product). On
a moving one the edges are linear in time, so over a bin e1 x e2 is a
quadratic with Bernstein coefficients A, B, C, and

    |d . N(t)| / |d|_2 >= min_k (|h . n| y_k - x_k - D)

with y_k the component of coefficient k along n, x_k the rest, and D a
bound on what the lerp's rounding (20 u of the vertices' size) does to
N; sigma is the least |h . n| that makes each term at least sqrt3 Q_MIN
times the Bernstein bound of |e1|_1 |e2|_1. A triangle gets sigma = 2
where no such bound exists (a coefficient not along n, a degenerate or
tiny triangle whose divisor could be clamped at 1e-12, one so large it
could overflow). The band is the group's bound on its screens:
|h . n_i| >= |h . a| - |n_i -+ a|, so tau = max_i (sigma_i + |n_i -+ a|);
like normals keep it tight.

A ray the argument does not cover takes every triangle (``full``): a
non-finite origin or direction, min_t = -inf (its t can be -inf, no
point), a direction whose largest component is outside [0.5, 2] (the
bounds above take |d|_inf there; the renderer's directions are unit), a
moving scene's ray outside the shutter [0, 1]. Dead rays (not max_t >=
min_t) test nothing, as in the plain version.

``culled_reference`` is the plain version of the kernel's whole query:
per-block tile lists (blocks of TILE rays as they come), the per-ray and
per-pair decisions in the kernel's f32 arithmetic, the test, ranges
merged by the least (t, id); ``query_stats`` counts its lists and pairs
without the tests.
"""

import dataclasses
import math

import numpy as np
import torch

from .chunkwalk import _morton3

TILE = 128              # triangles a tile, rays a block (csrc/brute.cu)
GROUP = 32              # triangles of a normal group (a warp's in the screen)
GROUPS = TILE // GROUP
NBINS_MOTION = 8        # shutter bins of a moving scene's screen
Q_MIN = 4e-3            # the least conditioning a culled pair may have
U = 2.0 ** -24          # f32 unit roundoff
GAMMA6 = 6 * U / (1 - 6 * U)
SLACK = 1e-5            # the kernel's f32 error in |h . n|, |h . a|
SQRT3 = math.sqrt(3.0)
ALWAYS = 2.0            # sigma of a triangle every ray tests


@dataclasses.dataclass
class BruteTables:
    """The brute-force kernel's tables (module docstring)."""
    tris: torch.Tensor      # [Tp, 3 or 6, 4] f32, Morton order
    ids: torch.Tensor       # [Tp] int32 original ids, -1 past the last
    screen: torch.Tensor    # [NB, Tp, 4] f32 n.xyz, sigma
    tiles: torch.Tensor     # [K, 3, 4] f32 (lo, h1), (hi, bmax), (c, 0)
    bands: torch.Tensor     # [NB, K, GROUPS, 4] f32 a.xyz, tau
    kappa: float            # the padding's slope (f32)
    mu: float               # the slab test's rounding margin (f32)
    motion: bool
    tri_p: torch.Tensor     # the [2, T, 3, 3] triangles built from (the tie)


def _l1(x):
    return np.abs(x).sum(-1)


def _l2(x):
    return np.sqrt((x * x).sum(-1))


def _f32_up(x):
    """float32 values >= x."""
    y = np.asarray(x, np.float64).astype(np.float32)
    return np.where(y < x, np.nextafter(y, np.float32(np.inf)), y)


def _f32_down(x):
    y = np.asarray(x, np.float64).astype(np.float32)
    return np.where(y > x, np.nextafter(y, np.float32(-np.inf)), y)


def _screen(e1a, e2a, e1b, e2b, delta):
    """(n [T, 3] f32, sigma [T] f32) of triangles whose edges run linearly
    from (e1a, e2a) to (e1b, e2b) [T, 3] (f64) over a bin, the test's
    edges within delta [T] of them per component."""
    A = np.cross(e1a, e2a)
    C = np.cross(e1b, e2b)
    Bm = 0.5 * (np.cross(e1a, e2b) + np.cross(e1b, e2a))
    mid = A + 2.0 * Bm + C
    nm = _l2(mid)
    n = (mid / np.where(nm > 0, nm, 1.0)[:, None]).astype(np.float32)
    nb = n.astype(np.float64)
    nb2 = (nb * nb).sum(-1)
    safe = np.where(nb2 > 0, nb2, 1.0)
    a0, a1 = _l1(e1a) + 3 * delta, _l1(e1b) + 3 * delta
    b0, b1 = _l1(e2a) + 3 * delta, _l1(e2b) + 3 * delta
    zs = (a0 * b0, 0.5 * (a0 * b1 + a1 * b0), a1 * b1)
    dn = (SQRT3 * delta * (np.maximum(_l2(e1a), _l2(e1b))
                           + np.maximum(_l2(e2a), _l2(e2b)))
          + 3 * delta * delta)
    ys, xs = [], []
    for K in (A, Bm, C):
        y = (K * nb).sum(-1) / safe
        ys.append(y)
        xs.append(_l2(K - y[:, None] * nb))
    with np.errstate(divide='ignore', invalid='ignore', over='ignore'):
        sig = np.max([(SQRT3 * Q_MIN * z + x + dn) / y
                      for z, x, y in zip(zs, xs, ys)], 0)
        # the least |d . N| / |d|_2 at |h . n| = sig: with |d|_2 >= 0.5
        # and |d|_1 <= 6 it keeps the computed divisor above the 1e-12
        # clamp
        g = np.min([sig * y - x - dn for x, y in zip(xs, ys)], 0)
        zmax = np.max(zs, 0)
        ok = ((nb2 > 0) & (np.min(ys, 0) > 0) & np.isfinite(sig)
              & (sig + SLACK < 1.0) & (0.5 * g - 6 * GAMMA6 * zmax > 2e-12)
              & (zmax < 1e30))
    sigma = np.where(ok, _f32_up(np.where(ok, sig, 0.0) + SLACK), ALWAYS)
    return n, sigma.astype(np.float32)


def _band(n, sigma):
    """(a [3] f32, tau) over one group's triangles (n [m, 3] f32, sigma
    [m] f32); tau = -1 for an empty group (no ray grazes it)."""
    if len(sigma) == 0:
        return np.zeros(3, np.float32), np.float32(-1.0)
    if (sigma >= ALWAYS).any():
        return np.array([0.0, 0.0, 1.0], np.float32), np.float32(3.0)
    nb = n.astype(np.float64)
    w, v = np.linalg.eigh(nb.T @ nb)
    a = v[:, -1].astype(np.float32)
    ab = a.astype(np.float64)
    chord = np.minimum(_l2(nb - ab), _l2(nb + ab))
    return a, _f32_up((sigma.astype(np.float64) + chord).max() + SLACK)


def _normal_groups(nrm):
    """A permutation of one tile's triangles (unit normals nrm [m, 3],
    f64) that makes each run of GROUP a group of like normals (either
    sign): a two-level k-d split along the normals' second and third
    principal directions."""
    w, v = np.linalg.eigh(nrm.T @ nrm)
    sgn = np.where(nrm @ v[:, 2] < 0, -1.0, 1.0)[:, None]
    u, t = (nrm * sgn) @ v[:, 1], (nrm * sgn) @ v[:, 0]
    perm = np.argsort(u, kind='stable')
    half = 2 * GROUP
    for h in range(0, len(perm), half):
        part = perm[h:h + half]
        perm[h:h + half] = part[np.argsort(t[part], kind='stable')]
    return perm


def build_tables(tri_p, has_motion):
    """The kernel's tables (host numpy, f64 where a bound is computed)
    from tri_p [2, T, 3, 3] f32: a dict of numpy arrays and scalars."""
    tri_p = np.asarray(tri_p, np.float32)
    T = tri_p.shape[1]
    nb_ = NBINS_MOTION if has_motion else 1
    V = tri_p.astype(np.float64)
    verts = V if has_motion else V[:1]                   # [k, T, 3, 3]
    tlo = verts.min(axis=(0, 2))
    thi = verts.max(axis=(0, 2))
    cen = 0.5 * (tlo + thi)
    lo = cen.min(0)
    span = np.maximum(cen.max(0) - lo, 1e-12)
    qc = np.clip(((cen - lo) / span * 1023).astype(np.int64), 0, 1023)
    order = np.argsort(_morton3(qc[:, 0], qc[:, 1], qc[:, 2]), kind='stable')
    K = max(-(-T // TILE), 1)
    Tp = K * TILE
    # within each tile, runs of GROUP like normals (mid-shutter normals on
    # a moving scene): a ray grazes few of a tile's groups
    W = 0.5 * (V[0] + V[1]) if has_motion else V[0]
    nrm = np.cross(W[:, 1] - W[:, 0], W[:, 2] - W[:, 0])
    nn = _l2(nrm)
    nrm = np.where(nn[:, None] > 0, nrm / np.where(nn > 0, nn, 1.0)[:, None],
                   np.array([0.0, 0.0, 1.0]))
    for k in range(K):
        sl = order[k * TILE:(k + 1) * TILE]
        order[k * TILE:(k + 1) * TILE] = sl[_normal_groups(nrm[sl])]

    ids = np.full(Tp, -1, np.int32)
    ids[:T] = order
    tp = tri_p[:, order]                                 # [2, T, 3, 3] f32
    rows = 6 if has_motion else 3
    tris = np.zeros((Tp, rows, 4), np.float32)
    if has_motion:
        tris[:T, 0:3, :3] = tp[0]
        tris[:T, 3:6, :3] = tp[1]
    else:
        tris[:T, 0, :3] = tp[0, :, 0]
        tris[:T, 1, :3] = tp[0, :, 1] - tp[0, :, 0]      # f32, as the plain
        tris[:T, 2, :3] = tp[0, :, 2] - tp[0, :, 0]      # version rounds
    tris[:, 0, 3] = ids.view(np.float32)

    screen = np.zeros((nb_, Tp, 4), np.float32)
    screen[:, T:, 3] = -1.0
    Vo = V[:, order]
    if has_motion:
        delta = 20 * U * np.abs(Vo).max(axis=(0, 2, 3))
        for b in range(nb_):
            ends = []
            for t in (b / nb_, (b + 1) / nb_):
                W = (1.0 - t) * Vo[0] + t * Vo[1]
                ends.append((W[:, 1] - W[:, 0], W[:, 2] - W[:, 0]))
            n, sig = _screen(ends[0][0], ends[0][1], ends[1][0], ends[1][1],
                             delta)
            screen[b, :T, :3], screen[b, :T, 3] = n, sig
    else:
        e1 = tris[:T, 1, :3].astype(np.float64)
        e2 = tris[:T, 2, :3].astype(np.float64)
        n, sig = _screen(e1, e2, e1, e2, np.zeros(T))
        screen[0, :T, :3], screen[0, :T, 3] = n, sig

    tiles = np.zeros((K, 3, 4), np.float32)
    bands = np.zeros((nb_, K, GROUPS, 4), np.float32)
    vo = verts[:, order]
    for k in range(K):
        s, e = k * TILE, min((k + 1) * TILE, T)
        v = vo[:, s:e].reshape(-1, 3)
        blo, bhi = v.min(0), v.max(0)
        pad = 4e-6 * max(np.abs(blo).max(), np.abs(bhi).max()) + 1e-20
        lo32, hi32 = _f32_down(blo - pad), _f32_up(bhi + pad)
        c32 = (0.5 * (lo32.astype(np.float64) + hi32)).astype(np.float32)
        cb = c32.astype(np.float64)
        h1 = np.maximum(hi32 - cb, cb - lo32).sum() * (1 + 1e-6)
        bmax = max(np.abs(lo32).max(), np.abs(hi32).max())
        tiles[k, 0, :3], tiles[k, 0, 3] = lo32, _f32_up(h1)
        tiles[k, 1, :3], tiles[k, 1, 3] = hi32, _f32_up(bmax)
        tiles[k, 2, :3] = c32
        for b in range(nb_):
            for g in range(GROUPS):
                g0, g1 = s + g * GROUP, min(s + (g + 1) * GROUP, e)
                a, tau = _band(screen[b, g0:g1, :3], screen[b, g0:g1, 3])
                bands[b, k, g, :3], bands[b, k, g, 3] = a, tau
    kappa = _f32_up(2 * 32 * U / (Q_MIN - GAMMA6))
    return dict(tris=tris, ids=ids, screen=screen, tiles=tiles, bands=bands,
                kappa=float(kappa), mu=float(_f32_up(16 * U)))


def tables_for(tri_p, has_motion):
    """BruteTables of the triangles tri_p [2, T, 3, 3] (a tensor), on its
    device."""
    host = build_tables(tri_p.detach().cpu().numpy(), has_motion)
    t = lambda k: torch.as_tensor(host[k], device=tri_p.device)
    return BruteTables(
        tris=t('tris'), ids=t('ids'), screen=t('screen'), tiles=t('tiles'),
        bands=t('bands'), kappa=host['kappa'], mu=host['mu'], motion=bool(has_motion),
        tri_p=tri_p)


def attach(scene):
    """scene with the brute-force tables of its own triangles (after its
    tri_p was replaced)."""
    return dataclasses.replace(scene, brute=tables_for(scene.tri_p,
                                                       scene.has_motion))


# ---------------------------------------------------------------------------
# the kernel's decisions in torch (f32, the kernel's order)
# ---------------------------------------------------------------------------

def ray_terms(bt, org, d, time, min_t, max_t):
    """The per-ray values the kernel computes once: alive, full, unit
    direction h, inverse direction, |o|_inf, shutter bin."""
    alive = max_t >= min_t
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    dmax = torch.maximum(torch.maximum(dx.abs(), dy.abs()), dz.abs())
    ok = (torch.isfinite(org).all(1) & torch.isfinite(d).all(1)
          & (min_t > -math.inf) & (dmax >= 0.5) & (dmax <= 2.0))
    nbins = bt.screen.shape[0]
    if bt.motion:
        ok = ok & (time >= 0.0) & (time <= 1.0)
        b = torch.where(ok, (time * nbins).to(torch.int32),
                        torch.zeros_like(time, dtype=torch.int32))
        b = torch.clamp(b, max=nbins - 1).long()
    else:
        b = torch.zeros(org.shape[0], dtype=torch.long, device=org.device)
    norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    safe = torch.where(torch.abs(d) < 1e-12,
                       torch.where(d < 0, torch.full_like(d, -1e-12),
                                   torch.full_like(d, 1e-12)), d)
    o = org.abs()
    return dict(alive=alive, full=alive & ~ok, h=d / norm[:, None],
                inv=1.0 / safe, onorm=torch.maximum(torch.maximum(
                    o[:, 0], o[:, 1]), o[:, 2]), bin=b)


def tile_need(bt, org, rt, min_t, max_t):
    """(whole [R, K], graze [R, K, GROUPS]): the ray's padded
    slab test against the tile passes (or the ray is full), or else it
    may graze a triangle of the tile's normal group g; all False for a
    dead ray."""
    tl = bt.tiles
    lo, h1 = tl[:, 0, :3], tl[:, 0, 3]
    hi, bmax = tl[:, 1, :3], tl[:, 1, 3]
    c = tl[:, 2, :3]
    o = org[:, None, :]
    dist = ((torch.abs(o[..., 0] - c[:, 0]) + torch.abs(o[..., 1] - c[:, 1]))
            + torch.abs(o[..., 2] - c[:, 2])) + h1
    kappa = torch.tensor(bt.kappa, dtype=torch.float32, device=org.device)
    mu = torch.tensor(bt.mu, dtype=torch.float32, device=org.device)
    pad = kappa * dist + mu * (rt['onorm'][:, None] + bmax)
    inv = rt['inv'][:, None, :]
    t0 = (lo - pad[..., None] - o) * inv
    t1 = (hi + pad[..., None] - o) * inv
    mn3, mx3 = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(mn3[..., 0], mn3[..., 1]), mn3[..., 2])
    tf = torch.minimum(torch.minimum(mx3[..., 0], mx3[..., 1]), mx3[..., 2])
    alive = rt['alive'][:, None]
    whole = alive & (rt['full'][:, None] | ((tn <= tf)
                                            & (tf >= min_t[:, None])
                                            & (tn <= max_t[:, None])))
    ax = bt.bands[rt['bin']]                             # [R, K, G, 4]
    h = rt['h'][:, None, None, :]
    dot = (h[..., 0] * ax[..., 0] + h[..., 1] * ax[..., 1]) \
        + h[..., 2] * ax[..., 2]
    graze = (alive & ~whole)[..., None] & (torch.abs(dot) < ax[..., 3])
    return whole, graze


def screened(bt, rt, j0, j1):
    """[R, j1 - j0]: the ray may graze triangle slot j (Morton order)."""
    sc = bt.screen[:, j0:j1][rt['bin']]                     # [R, j, 4]
    h = rt['h'][:, None, :]
    dot = (h[..., 0] * sc[..., 0] + h[..., 1] * sc[..., 1]) \
        + h[..., 2] * sc[..., 2]
    return torch.abs(dot) < sc[..., 3]


def _pair_tests(bt, org, d, time, min_t, max_t, j0, j1):
    """The plain version's test of every ray against triangle slots
    [j0, j1): (valid, t, u, v) [R, j1 - j0]; valid = the test passes with
    t < inf (a ray's hit is its least valid (t, id))."""
    from .intersect import tri_test_ordered
    from ..utils import vecmath as vm
    tr = bt.tris[j0:j1]
    o, dd = org[:, None, :], d[:, None, :]
    if bt.motion:
        w = vm.lerp(time[:, None, None, None], tr[None, :, 0:3, :3],
                    tr[None, :, 3:6, :3])
        p0 = w[..., 0, :]
        e1, e2 = w[..., 1, :] - p0, w[..., 2, :] - p0
    else:
        p0, e1, e2 = (tr[None, :, c, :3] for c in range(3))
    t, u, v, div = tri_test_ordered(o, dd, p0, e1, e2)
    valid = ((div != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t >= min_t[:, None]) & (t <= max_t[:, None])
             & (t < math.inf))
    return valid, t, u, v


def _least(valid, t, u, v, ids):
    """The least (t, id) over the last axis where valid: (t, id, u, v),
    t = inf and the rest 0 where none is."""
    inf = torch.full_like(t, math.inf)
    tm = torch.where(valid, t, inf)
    best = tm.amin(-1)
    at = valid & (tm == best[..., None])
    big = torch.iinfo(torch.int32).max
    idb = torch.broadcast_to(ids, t.shape)
    bid = torch.where(at, idb, torch.full_like(idb, big)).amin(-1)
    win = at & (idb == bid[..., None])
    zero = torch.zeros_like(t)
    hit = valid.any(-1)
    return (best, torch.where(hit, bid, torch.zeros_like(bid)),
            torch.where(win, u, zero).sum(-1), torch.where(win, v, zero).sum(-1))


def culled_reference(scene, org, d, time, min_t, max_t, splits=1,
                     stats=None, ray_chunk=512):
    """The kernel's query as plain torch: rays in blocks of TILE as
    they come, each block's tile list (the tiles one of its rays
    needs), each ray testing the triangles of the tiles it needs (all of
    them where its padded slab test passes, the screened ones where it
    may graze one), the triangle ranges' partial bests (splits contiguous
    tile ranges) merged by the least (t, id). Returns (t, id, u, v), as
    _bruteforce_live. stats, a dict, receives the
    block lists [blocks, K] bool, the tested pairs per ray, the valid
    pairs (whose test passes) that no list or test covers (must be 0),
    the valid pairs found only by the screen (outside the ray's padded
    slab), the live rays and the full ones."""
    bt = scene.brute
    R, T = org.shape[0], scene.num_tris
    K = bt.tiles.shape[0]
    rt = ray_terms(bt, org, d, time, min_t, max_t)
    hit, graze = tile_need(bt, org, rt, min_t, max_t)
    need = hit | graze.any(-1)
    nblk = -(-R // TILE)
    pad = nblk * TILE - R
    lists = torch.cat([need, need.new_zeros(pad, K)]).reshape(
        nblk, TILE, K).any(1)
    listed = lists[torch.arange(R, device=org.device) // TILE]
    splits = min(splits, K)
    ranges = [(s * K // splits, (s + 1) * K // splits)
              for s in range(splits)]
    ids = bt.ids.long()
    parts = []
    tested_n = torch.zeros(R, dtype=torch.int64, device=org.device)
    missed = grazed = 0
    for k0, k1 in ranges:
        j0, j1 = k0 * TILE, min(k1 * TILE, T)
        outs = []
        for r0 in range(0, R, ray_chunk):
            sl = slice(r0, r0 + ray_chunk)
            rts = {k: x[sl] for k, x in rt.items()}
            valid, t, u, v = _pair_tests(bt, org[sl], d[sl], time[sl],
                                         min_t[sl], max_t[sl], j0, j1)
            slot = torch.arange(j0, j1, device=org.device)
            tile_of, group_of = slot // TILE, slot % TILE // GROUP
            h = hit[sl][:, tile_of]
            b = graze[sl][:, tile_of, group_of] & screened(bt, rts, j0, j1)
            tested = (h | b) & listed[sl][:, tile_of] & rt['alive'][sl,
                                                                    None]
            tested_n[sl] += tested.sum(1)
            missed += int((valid & ~tested).sum())
            grazed += int((valid & tested & ~h).sum())
            outs.append(_least(valid & tested, t, u, v, ids[j0:j1]))
        parts.append([torch.cat(x) for x in zip(*outs)])
    bt_, bi, bu, bv = parts[0]
    for t, i, u, v in parts[1:]:
        take = (t < bt_) | ((t == bt_) & (i < bi))
        bt_, bi = torch.where(take, t, bt_), torch.where(take, i, bi)
        bu, bv = torch.where(take, u, bu), torch.where(take, v, bv)
    bi = bi.to(torch.int32)
    if stats is not None:
        stats.update(lists=lists, tested=tested_n, missed=missed,
                     grazed=grazed,
                     live=int(rt['alive'].sum()), full=int(rt['full'].sum()))
    return bt_, bi, bu, bv


def query_stats(scene, org, d, time, min_t, max_t, ray_chunk=8192,
                tri_chunk=1024):
    """What the kernel's decisions leave of a query, in the kernel's
    arithmetic (no test runs): the tiles on a block's list (mean, p99,
    max, of K), the (ray, triangle) pairs its rays test, the live and
    full rays and live rays x triangles (what the brute force tests)."""
    bt = scene.brute
    R, T = org.shape[0], scene.num_tris
    K = bt.tiles.shape[0]
    nblk = -(-R // TILE)
    lists = torch.zeros((nblk, K), dtype=torch.bool, device=org.device)
    tested = live = full = 0
    for r0 in range(0, R, ray_chunk):
        sl = slice(r0, r0 + ray_chunk)
        rt = ray_terms(bt, org[sl], d[sl], time[sl], min_t[sl], max_t[sl])
        hit, graze = tile_need(bt, org[sl], rt, min_t[sl], max_t[sl])
        need = hit | graze.any(-1)
        rows = torch.arange(r0, r0 + need.shape[0], device=org.device)
        lists.index_put_((rows // TILE,), need, accumulate=True)
        live += int(rt['alive'].sum())
        full += int(rt['full'].sum())
        for j0 in range(0, T, tri_chunk):
            j1 = min(j0 + tri_chunk, T)
            slot = torch.arange(j0, j1, device=org.device)
            tile_of, group_of = slot // TILE, slot % TILE // GROUP
            scr = screened(bt, rt, j0, j1)
            tested += int((hit[:, tile_of]
                           | (graze[:, tile_of, group_of] & scr)).sum())
    per = lists.sum(1).double()
    return dict(tiles=K, list_mean=float(per.mean()),
                list_p99=float(torch.quantile(per, 0.99)),
                list_max=int(per.max()), tested=tested, live=live,
                full=full, pairs_all=live * T)
