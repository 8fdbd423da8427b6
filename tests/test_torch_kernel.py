"""The kernels' wrappers and the port's device defaults (no JAX in this
file, so it also runs on a machine with a card and no JAX):

* on CPU tensors the walk wrappers run the plain version and count no
  launch; the plain version's any hit equals the closest hit's hit set;
* on a card (marked `cuda`, skipped elsewhere): the three forms of the walk
  kernel (csrc/walk.cuh), the staged chunk walk (K1/K2), the resident
  chunk walk (K3) and the culled sweep (K4), both variants of each, equal
  their plain versions exactly (the kernels are built with --fmad=false),
  each launch is counted under its own name, and bad inputs raise. Each
  builds its chunk lists (the sweep: its visit mask) itself and splits
  each ray block's chunks into ranges: it is held against
  _block_chunk_lists + walk_reference (the sweep: _chunk_mask +
  sweep_reference), and its hit sets against the lists or the mask, with
  1, 2, the default and K ranges, on planted exact ties, on rays all
  occluded within the first tile (an early exit), with all-dead blocks
  and a ray count that is not a multiple of 256;
* on the open generated scene (no walls: rays miss), K1/K2 and their
  plain version on camera rays, rays leaving surface points, the env
  map's emission rays (origins on the x1000 bounding sphere, far outside
  every chunk) and blocks of rays that all miss: a miss keeps t = BIG and
  id -1; on the card, bit for bit with the plain version;
* the entry points default to the card: without one, parse_scene and the
  CLI refuse unless the CPU is asked for;
* the BVH traversal (ops/bvh.py): on CPU tensors the wrapper runs the
  plain version and counts no launch; on a card (marked `cuda`) the
  kernel (csrc/bvh.cu, walking pack_bvh's tables) equals the plain
  version bit for bit, closest and any hit, on the small box, open and
  moving open scenes at 65,536 and 4,352 rays, on all-dead rays, a
  root-leaf tree, coincident triangles in different leaves and a tree of
  STACK_DEPTH levels; without the packed tables it raises.
"""

import dataclasses
import os

import pytest
import torch

from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.ops import bvh
from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
from langevin_mcmc_tpu_torch.ops import sweep_isect as sw
from langevin_mcmc_tpu_torch.parallel.mesh import ChainMesh, replicate
from langevin_mcmc_tpu_torch.scene.parse import parse_scene
from torch_parity import (coincident_copies, left_chain_nodes,
                          planted_tie_case, with_triangles)

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('small')),
                                 small=True, width=32, height=24)
    return parse_scene(xml, device='cpu')[0]


@pytest.fixture(scope='module')
def open_scene(tmp_path_factory):
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('open')),
                                 small=True, width=32, height=24,
                                 scene='open')
    return parse_scene(xml, device='cpu')[0]


def _open_rays(scene, n, device):
    """n rays on the open scene: a quarter camera rays, a quarter from
    surface points in random directions, a quarter from the x1000 bounding
    sphere (half the env map's emission rays, which almost all miss, half
    aimed at triangle centroids), and a quarter straight up from above a
    corner of the floor (all miss; they sort into Morton cells of their
    own, so whole blocks miss)."""
    from langevin_mcmc_tpu_torch.ops import lights
    from langevin_mcmc_tpu_torch.scene.camera import sample_primary
    g = torch.Generator().manual_seed(9)
    q = n // 4
    o0, d0, mn0, mx0 = sample_primary(scene.camera, torch.rand(q, 2,
                                                               generator=g),
                                      torch.zeros(q))
    cen = scene.tri_p[0].mean(1)
    o1 = cen[torch.randint(0, scene.num_tris, (q,), generator=g)]
    d1 = torch.randn(q, 3, generator=g)
    d1 = d1 / d1.norm(dim=1, keepdim=True)
    h = q // 2
    env = torch.full((h,), scene.env_light_id, dtype=torch.int32)
    em = lights.emit(scene, env, torch.zeros(h, dtype=torch.int32),
                     torch.rand(h, 2, generator=g),
                     torch.rand(h, 2, generator=g), torch.zeros(h))
    aim = cen[torch.randint(0, scene.num_tris, (q - h,), generator=g)]
    d2 = torch.randn(q - h, 3, generator=g)
    d2 = d2 / d2.norm(dim=1, keepdim=True)
    o2 = aim - d2 * scene.bsphere_radius
    r = n - 3 * q
    o3 = torch.rand(r, 3, generator=g) + 18.5
    o3[:, 2] = 10.0
    d3 = torch.tensor([[0.0, 0.0, 1.0]]).repeat(r, 1)
    org = torch.cat([o0, o1, em['org'], o2, o3])
    d = torch.cat([d0, d1, em['dir'], d2, d3])
    mn = torch.cat([mn0, torch.full((n - q,), 1e-3)])
    mx = torch.cat([mx0, torch.full((n - q,), float('inf'))])
    return [x.to(device) for x in (org, d, mn, mx)]


def _open_case(sc, rays):
    """(tables, sorted rays, plain closest hit, plain occlusion) of the
    staged walk on the open scene."""
    tables = (sc.cw.pack, sc.cw.ids, sc.cw.chunk_lo, sc.cw.chunk_hi)
    o, d, rng = _sorted(sc, 'staged', rays)
    (t, tid, _, _), _ = _plain('staged', *tables, o, d, rng, False)
    return tables, (o, d, rng), t, tid


def test_open_scene_misses_plain(open_scene):
    """The plain version on the open scene: misses keep t = BIG and id -1,
    whole blocks miss, env emission rays from the far sphere hit the
    scene, and the any hit equals the closest hit's hit set."""
    rays = _open_rays(open_scene, 2048, 'cpu')
    tables, srt, t, tid = _open_case(open_scene, rays)
    hit = t < cw.BIG
    assert (tid[~hit] == -1).all() and (tid[hit] >= 0).all()
    live = (srt[2][:, 1] > srt[2][:, 0]).reshape(-1, cw.RAY_BLOCK)
    block_miss = (~hit.reshape(-1, cw.RAY_BLOCK) | ~live).all(1) & live.any(1)
    assert block_miss.any(), 'no block of live rays that all miss'
    occ, _ = _plain('staged', *tables, *srt, True)
    assert torch.equal(occ, hit)
    # rays from the bounding sphere, 28,000 units out, aimed at the scene
    # reach it; the last quarter misses
    h, _, _, _, _ = cw.intersect_chunkwalk(open_scene, *rays[:2],
                                           torch.zeros(2048), *rays[2:])
    assert h[1280:1536].float().mean() > 0.5 and not h[1536:].any()


@pytest.mark.cuda
def test_open_scene_kernel_matches_plain_on_card(open_scene):
    """K1/K2 on the open scene's miss-heavy rays, far env origins and
    all-miss blocks included, bit for bit with the plain version."""
    sc = _on_card(open_scene)
    rays = _open_rays(open_scene, 4096, 'cuda')
    tables = (sc.cw.pack, sc.cw.ids, sc.cw.chunk_lo, sc.cw.chunk_hi)
    (t, tid, _, _), _ = _kernel_equals_plain('staged', sc, tables, rays)
    hit = t < cw.BIG
    assert (~hit).any() and hit.any() and (tid[~hit] == -1).all()
    for S in (1, sc.cw.pack.shape[0]):
        _kernel_equals_plain('staged', sc, tables, rays, splits=S)


def _rays(scene, n, device):
    """Rays between random pairs of triangle centroids, a quarter dead."""
    g = torch.Generator().manual_seed(5)
    cen = scene.tri_p[0].mean(1)
    a = cen[torch.randint(0, scene.num_tris, (n,), generator=g)]
    b = cen[torch.randint(0, scene.num_tris, (n,), generator=g)]
    d = b - a
    d = d / d.norm(dim=1, keepdim=True).clamp(min=1e-6)
    mn = torch.full((n,), 1e-2)
    mx = torch.where(torch.rand(n, generator=g) < 0.25, torch.zeros(n),
                     torch.full((n,), float('inf')))
    return [x.to(device) for x in (a, d, mn, mx)]


FORMS = ['staged', 'resident', 'sweep']
# launch-count keys of each form: (closest hit, any hit)
KEYS = {'staged': ('split_closest_hit', 'split_any_hit'),
        'resident': ('closest_hit_resident', 'any_hit_resident'),
        'sweep': ('closest_hit', 'any_hit')}


def _walk(form):
    return {'staged': cw.walk_staged, 'resident': cw.walk_resident,
            'sweep': sw.walk}[form]


def _tables(sc, form):
    """The form's table set (scene.cw or scene.sweep) of scene sc."""
    return sc.sweep if form == 'sweep' else sc.cw


def _sorted(sc, form, rays):
    """Rays padded and sorted as the form's query sorts them."""
    if form == 'sweep':
        return sw.prepare_rays(sc.sweep, *rays)[0]
    return cw.sort_rays(sc.cw, *rays)[0]


def _launches():
    return {**cw.launch_counts, **{'sweep_' + k: v
                                   for k, v in sw.launch_counts.items()}}


def _reset():
    cw.reset_launch_counts()
    sw.reset_launch_counts()


def _plain(form, pack, ids, lo, hi, o, d, rng, any_hit):
    """The form's plain version on the same tensors, and the chunk hit sets
    it walks ([blocks, K] uint8)."""
    if form == 'sweep':
        mask = sw._chunk_mask(o, d, rng[:, 0], rng[:, 1], lo, hi)
        return (sw.sweep_reference(pack, ids, mask, o, d, rng, any_hit),
                mask.to(torch.uint8))
    chunk_idx, counts = cw._block_chunk_lists(o, d, rng[:, 0], rng[:, 1],
                                              lo, hi)
    sets = torch.zeros((counts.shape[0], pack.shape[0]), dtype=torch.uint8,
                       device=o.device)
    for b in range(counts.shape[0]):
        sets[b, chunk_idx[b, :counts[b]].long()] = 1
    return (cw.walk_reference(pack, ids, chunk_idx, counts, o, d, rng,
                              any_hit), sets)


def test_cpu_runs_plain_version_without_launches(scene):
    _reset()
    rays = _rays(scene, 700, 'cpu')
    for form in FORMS:
        tabs = _tables(scene, form)
        args = (tabs.pack, tabs.ids, tabs.chunk_lo, tabs.chunk_hi,
                *_sorted(scene, form, rays))
        t, tid, u, v = _walk(form)(*args, False)
        occ = _walk(form)(*args, True)
        (rt, rid, ru, rv), _ = _plain(form, *args, False)
        assert torch.equal(t, rt) and torch.equal(tid, rid)
        hit = t < cw.BIG
        assert torch.equal(occ, hit)
        assert hit.any() and (~hit).any()
        assert (tid[hit] >= 0).all() and (tid[~hit] == -1).all()
    assert not any(_launches().values())


def _on_card(scene):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    # replicate keeps a BVH's tables tied to the node tensor they packed
    return replicate(ChainMesh((torch.device('cuda'),), 0, 1), scene)[0]


def _kernel_equals_plain(form, sc, tables, rays, splits=None):
    """The form's kernel on rays sorted and padded for scene sc, walking
    tables (pack, ids, chunk_lo, chunk_hi), against its plain version, bit
    for bit; its chunk hit sets against the plain version's lists or mask;
    one closest-hit and three any-hit launches, counted under the form's
    keys. Returns the plain closest hit and the hit sets."""
    pack, ids, lo, hi = tables
    o, d, rng = _sorted(sc, form, rays)
    args = (pack, ids, lo, hi, o, d, rng)
    want, sets = _plain(form, *args, False)
    mask = torch.zeros_like(sets)
    _reset()
    got = _walk(form)(*args, False, splits=splits, chunk_mask=mask)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    occ, _ = _plain(form, *args, True)
    for _ in range(3):  # repeated: an early exit must leave no copy behind
        assert torch.equal(_walk(form)(*args, True, splits=splits), occ)
    torch.cuda.synchronize()
    assert torch.equal(mask, sets)
    closest, any_hit = KEYS[form]
    prefix = 'sweep_' if form == 'sweep' else ''
    want_counts = {k: 0 for k in _launches()}
    want_counts.update({prefix + closest: 1, prefix + any_hit: 3})
    assert _launches() == want_counts
    return want, sets


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(scene):
    sc = _on_card(scene)
    tables = (sc.cw.pack, sc.cw.ids, sc.cw.chunk_lo, sc.cw.chunk_hi)
    rays = _rays(sc, 4096, 'cuda')
    want, sets = _kernel_equals_plain('staged', sc, tables, rays)
    assert (want[0] < cw.BIG).any() and not sets[-1].any()
    (o, d, rng), _ = cw.sort_rays(sc.cw, *rays)
    with pytest.raises(ValueError):
        cw.walk_staged(tables[0].double(), *tables[1:], o, d, rng, False)
    with pytest.raises(ValueError):
        cw.walk_staged(*tables, o[:-1], d, rng, True)
    with pytest.raises(RuntimeError):  # splits the kernel does not take
        cw.walk_staged(*tables, o, d, rng, False, splits=0)


@pytest.mark.cuda
@pytest.mark.parametrize('form', FORMS)
@pytest.mark.parametrize('splits', ['one', 'two', 'all'])
def test_kernel_splits_on_card(scene, form, splits):
    """1, 2 and K chunk ranges per block; 1,000 rays (not a multiple of
    256) of which a quarter dead (the chunk walk sorts them last, so its
    last block is all dead)."""
    sc = _on_card(scene)
    tabs = _tables(sc, form)
    tables = (tabs.pack, tabs.ids, tabs.chunk_lo, tabs.chunk_hi)
    S = {'one': 1, 'two': 2, 'all': tabs.pack.shape[0]}[splits]
    want, sets = _kernel_equals_plain(form, sc, tables,
                                      _rays(sc, 1000, 'cuda'), splits=S)
    assert (want[0] < cw.BIG).any()
    if form != 'sweep':
        assert not sets[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize('form', FORMS)
@pytest.mark.parametrize('splits', ['one', 'two', 'all'])
def test_kernel_planted_ties_on_card(scene, form, splits):
    """The same triangle in chunk 0 under ids X and -2 (in another
    128-triangle tile for the sweep's 512-triangle chunks) and in the last
    chunk under -3: the closest hit is -2 (smaller id within a chunk,
    earlier chunk across chunks, also when the two chunks lie in different
    ranges). Every live ray is occluded within the first tile of chunk 0,
    the first of its list, so the any-hit ranges leave early, with later
    tiles of their lists unread."""
    sc = _on_card(scene)
    *tables, rays = planted_tie_case(scene, _tables(scene, form))
    tables = [x.cuda() for x in tables]
    rays = [x.cuda() for x in rays]
    S = {'one': 1, 'two': 2, 'all': tables[0].shape[0]}[splits]
    (t, tid, _, _), sets = _kernel_equals_plain(form, sc, tables, rays,
                                                splits=S)
    hit = t < cw.BIG
    assert (tid[hit] == -2).float().mean() > 0.9
    assert int(sets.sum(1).max()) >= 3


@pytest.mark.cuda
@pytest.mark.parametrize('form', FORMS)
def test_kernel_all_dead_on_card(scene, form):
    """Every ray dead: nothing is hit; the any hit leaves every range at its
    first tile (the sweep's mask, which has no alive term, still visits the
    chunks around the rays' origins)."""
    sc = _on_card(scene)
    tabs = _tables(sc, form)
    tables = (tabs.pack, tabs.ids, tabs.chunk_lo, tabs.chunk_hi)
    org, d, mn, _ = _rays(sc, 1000, 'cuda')
    want, sets = _kernel_equals_plain(form, sc, tables,
                                      (org, d, mn, torch.zeros_like(mn)))
    assert not (want[0] < cw.BIG).any()
    assert sets.any() == (form == 'sweep')


@pytest.mark.cuda
def test_resident_kernel_matches_plain_on_card(scene):
    sc = _on_card(scene)
    tables = (sc.cw.pack, sc.cw.ids, sc.cw.chunk_lo, sc.cw.chunk_hi)
    want, _ = _kernel_equals_plain('resident', sc, tables,
                                   _rays(sc, 4096, 'cuda'))
    assert (want[0] < cw.BIG).any()


@pytest.mark.cuda
def test_sweep_kernel_matches_plain_on_card(scene):
    sc = _on_card(scene)
    tables = (sc.sweep.pack, sc.sweep.ids, sc.sweep.chunk_lo,
              sc.sweep.chunk_hi)
    rays = _rays(sc, 4096, 'cuda')
    want, _ = _kernel_equals_plain('sweep', sc, tables, rays)
    assert (want[0] < cw.BIG).any()
    o, d, rng = _sorted(sc, 'sweep', rays)
    with pytest.raises(ValueError):  # the chunk walk's tables
        sw.walk(sc.cw.pack, sc.cw.ids, sc.cw.chunk_lo, sc.cw.chunk_hi, o, d,
                rng, False)


def test_entry_points_default_to_the_card(tmp_path):
    """parse_scene and the CLI render on the card unless the CPU is asked
    for; without a card they refuse instead of falling back."""
    from langevin_mcmc_tpu_torch.__main__ import main
    xml = testscenes.write_scene(str(tmp_path), small=True, width=32,
                                 height=24)
    if torch.cuda.is_available():
        assert parse_scene(xml)[0].tri_p.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parse_scene(xml)
    with pytest.raises(SystemExit) as exc:
        main([xml, '--output-dir', os.path.join(tmp_path, 'out')])
    assert exc.value.code != 0
    assert parse_scene(xml, device='cpu')[0].tri_p.device.type == 'cpu'


BVH_SCENES = {'static': {}, 'open': dict(scene='open'),
              'motion': dict(scene='open', motion=True)}


@pytest.fixture(scope='module', params=list(BVH_SCENES))
def bvh_scene(request, tmp_path_factory):
    """The small box (static), the small open scene or the small moving
    open scene, with a BVH attached, on the CPU."""
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('bvh')),
                                 small=True, width=32, height=24,
                                 **BVH_SCENES[request.param])
    return bvh.attach_bvh(parse_scene(xml, device='cpu')[0])


def _timed_rays(scene, n, device):
    """_rays with a random shutter time per ray: (org, d, time, mn, mx)."""
    org, d, mn, mx = _rays(scene, n, 'cpu')
    time = torch.rand(n, generator=torch.Generator().manual_seed(6))
    return [x.to(device) for x in (org, d, time, mn, mx)]


def _bvh_equals_plain(sc, rays, any_hit):
    """The kernel (one launch, counted under its variant) against
    traverse_reference, bit for bit. Returns the plain version's output."""
    tabs = (sc.bvh_nodes, sc.bvh_prim_ids, sc.tri_p)
    bvh.reset_launch_counts()
    got = bvh.traverse(*tabs, *rays, any_hit, sc.has_motion, sc.bvh_packed)
    want = bvh.traverse_reference(*tabs, *rays, any_hit, sc.has_motion)
    torch.cuda.synchronize()
    if any_hit:
        assert torch.equal(got, torch.isfinite(want))
    else:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    key = 'any_hit' if any_hit else 'closest_hit'
    assert bvh.launch_counts == {k: int(k == key)
                                 for k in bvh.launch_counts}
    return want


def test_bvh_wrapper_runs_the_plain_version_on_cpu(bvh_scene):
    """On CPU tensors the BVH wrapper runs traverse_reference (with or
    without the packed tables) and counts no launch; its any hit equals
    the closest hit's hit set."""
    bvh.reset_launch_counts()
    rays = _timed_rays(bvh_scene, 1000, 'cpu')
    tabs = (bvh_scene.bvh_nodes, bvh_scene.bvh_prim_ids, bvh_scene.tri_p)
    t, tid, _, _ = bvh.traverse(*tabs, *rays, False, bvh_scene.has_motion)
    occ = bvh.traverse(*tabs, *rays, True, bvh_scene.has_motion,
                       bvh_scene.bvh_packed)
    hit = torch.isfinite(t)
    assert torch.equal(occ, hit) and hit.any() and (~hit).any()
    assert (tid[~hit] == 0).all()
    assert not any(bvh.launch_counts.values())


@pytest.mark.cuda
@pytest.mark.parametrize('n', [65536, 4352])
@pytest.mark.parametrize('any_hit', [False, True])
def test_bvh_kernel_matches_plain_on_card(bvh_scene, any_hit, n):
    """The BVH kernel (csrc/bvh.cu) equals traverse_reference bit for bit
    (t, id, u, v or occluded) on the box, the open and the moving open
    scene, at the chain's and the large step's ray counts, one launch
    counted; inputs of the wrong dtype raise."""
    sc = _on_card(bvh_scene)
    rays = _timed_rays(sc, n, 'cuda')
    want = _bvh_equals_plain(sc, rays, any_hit)
    assert torch.isfinite(want if any_hit else want[0]).any()
    with pytest.raises(ValueError):
        bvh.traverse(sc.bvh_nodes, sc.bvh_prim_ids, sc.tri_p,
                     rays[0].double(), *rays[1:], any_hit, sc.has_motion,
                     sc.bvh_packed)


@pytest.mark.cuda
@pytest.mark.parametrize('any_hit', [False, True])
def test_bvh_kernel_all_dead_on_card(bvh_scene, any_hit):
    sc = _on_card(bvh_scene)
    rays = _timed_rays(sc, 4352, 'cuda')
    rays[4] = torch.zeros_like(rays[4])
    want = _bvh_equals_plain(sc, rays, any_hit)
    assert not torch.isfinite(want if any_hit else want[0]).any()


@pytest.mark.cuda
@pytest.mark.parametrize('any_hit', [False, True])
def test_bvh_kernel_root_leaf_on_card(bvh_scene, any_hit):
    """A tree whose root is a leaf (3 triangles): no record at all."""
    sc = with_triangles(_on_card(bvh_scene),
                        bvh_scene.tri_p[:, :3].numpy())
    assert sc.bvh_packed.records.shape[0] == 0 and sc.bvh_packed.root < 0
    _bvh_equals_plain(sc, _timed_rays(sc, 4352, 'cuda'), any_hit)


@pytest.mark.cuda
def test_bvh_kernel_planted_tie_on_card(bvh_scene):
    """Coincident copies of a triangle in different leaves: the first in
    depth-first order wins, as in traverse_reference."""
    sc, copies = coincident_copies(_on_card(bvh_scene), 5, 5)
    cen = sc.tri_p[0, 5].mean(0)
    rays = _timed_rays(sc, 4352, 'cuda')
    rays[1] = cen - rays[0]
    rays[1] = rays[1] / rays[1].norm(dim=1, keepdim=True)
    rays[2] = torch.zeros_like(rays[2])
    rays[4] = torch.full_like(rays[4], float('inf'))
    t, tid, _, _ = _bvh_equals_plain(sc, rays, False)
    on_copy = torch.isin(tid, torch.tensor(copies, device='cuda'))
    assert (on_copy & torch.isfinite(t)).sum() > 100


@pytest.mark.cuda
@pytest.mark.parametrize('any_hit', [False, True])
def test_bvh_kernel_deepest_tree_on_card(bvh_scene, any_hit):
    """A tree of STACK_DEPTH levels, each inner node's children both hit:
    the kernel's stack holds STACK_DEPTH - 1 references."""
    sc = _on_card(bvh_scene)
    nodes = left_chain_nodes(bvh.STACK_DEPTH - 1, sc.num_tris).cuda()
    assert bvh.tree_depth(nodes.cpu().numpy()) == bvh.STACK_DEPTH
    sc = dataclasses.replace(
        sc, bvh_nodes=nodes,
        bvh_packed=bvh.pack_bvh(nodes, sc.bvh_prim_ids, sc.tri_p))
    _bvh_equals_plain(sc, _timed_rays(sc, 4352, 'cuda'), any_hit)


@pytest.mark.cuda
def test_bvh_kernel_needs_packed_tables_on_card(bvh_scene):
    """On the card the traversal walks pack_bvh's tables and raises
    without them (or with the tables of another node tensor, here a copy
    of the tree): no fallback."""
    sc = _on_card(bvh_scene)
    rays = _timed_rays(sc, 256, 'cuda')
    bvh.reset_launch_counts()
    other = bvh.pack_bvh(sc.bvh_nodes.clone(), sc.bvh_prim_ids, sc.tri_p)
    for packed in (None, other):
        bare = dataclasses.replace(sc, bvh_packed=packed)
        for fn in (bvh.intersect_bvh, bvh.occluded_bvh):
            with pytest.raises(ValueError, match='pack_bvh'):
                fn(bare, *rays)
    assert not any(bvh.launch_counts.values())
