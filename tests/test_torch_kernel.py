"""The kernels' wrappers and the port's device defaults (no JAX in this
file, so it also runs on a machine with a card and no JAX):

* on CPU tensors the chunk-walk wrappers run the plain version and count
  no launch; the plain version's any hit equals the closest hit's hit set;
* on a card (marked `cuda`, skipped elsewhere): the staged chunk walk
  (K1/K2), its resident form (K3) and the culled sweep (K4), both variants
  of each, equal their plain versions exactly (the kernels are built with
  --fmad=false), each launch is counted under its own name, and bad inputs
  raise. The staged walk builds its chunk lists itself and splits each
  ray block's chunks into ranges: it is held against _block_chunk_lists +
  walk_reference with 1, the default and K ranges, on planted exact ties,
  on rays all occluded within the first chunk (an exit with copies in
  flight), and with all-dead blocks and a ray count that is not a multiple
  of 256;
* the entry points default to the card: without one, parse_scene and the
  CLI refuse unless the CPU is asked for.
"""

import dataclasses
import os

import pytest
import torch

from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.ops import chunkwalk as cw
from langevin_mcmc_tpu_torch.ops import sweep_isect as sw
from langevin_mcmc_tpu_torch.scene.parse import parse_scene
from langevin_mcmc_tpu_torch.utils.tree import tree_map
from torch_parity import planted_tie_case

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('small')),
                                 small=True, width=32, height=24)
    return parse_scene(xml, device='cpu')[0]


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


def _inputs(scene, rays):
    (chunk_idx, counts, o, dd, rng), _ = cw.prepare_rays(scene.cw, *rays)
    return (scene.cw.pack, scene.cw.ids, chunk_idx, counts, o, dd, rng)


def test_cpu_runs_plain_version_without_launches(scene):
    cw.reset_launch_counts()
    args = _inputs(scene, _rays(scene, 700, 'cpu'))
    pack, ids, _, _, o, dd, rng = args
    t, tid, u, v = cw.walk_staged(pack, ids, scene.cw.chunk_lo,
                                  scene.cw.chunk_hi, o, dd, rng, False)
    occ = cw.walk_staged(pack, ids, scene.cw.chunk_lo, scene.cw.chunk_hi, o,
                         dd, rng, True)
    assert torch.equal(cw.walk_resident(*args, any_hit=True), occ)
    assert not any(cw.launch_counts.values())
    rt, rid, ru, rv = cw.walk_reference(*args, any_hit=False)
    assert torch.equal(t, rt) and torch.equal(tid, rid)
    hit = t < cw.BIG
    assert torch.equal(occ, hit)
    assert hit.any() and (~hit).any()
    assert (tid[hit] >= 0).all() and (tid[~hit] == -1).all()


def _on_card(scene):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return dataclasses.replace(tree_map(lambda x: x.cuda(), scene),
                               device=torch.device('cuda'))


def _staged_equals_plain(sc, tables, rays, splits=None):
    """The staged kernel on rays sorted and padded for scene sc, walking
    tables (pack, ids, chunk_lo, chunk_hi), against _block_chunk_lists +
    walk_reference, bit for bit; its chunk hit sets against the lists.
    Returns the plain closest hit and the list lengths."""
    pack, ids, lo, hi = tables
    (o, d, rng), _ = cw.sort_rays(sc.cw, *rays)
    chunk_idx, counts = cw._block_chunk_lists(o, d, rng[:, 0], rng[:, 1],
                                              lo, hi)
    mask = torch.zeros((counts.shape[0], pack.shape[0]), dtype=torch.uint8,
                       device=o.device)
    got = cw.walk_staged(pack, ids, lo, hi, o, d, rng, False, splits=splits,
                         chunk_mask=mask)
    want = cw.walk_reference(pack, ids, chunk_idx, counts, o, d, rng, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for _ in range(3):  # repeated: an exit must leave no copy in flight
        assert torch.equal(
            cw.walk_staged(pack, ids, lo, hi, o, d, rng, True,
                           splits=splits),
            cw.walk_reference(pack, ids, chunk_idx, counts, o, d, rng, True))
    torch.cuda.synchronize()
    hit_sets = torch.zeros_like(mask)
    for b in range(counts.shape[0]):
        hit_sets[b, chunk_idx[b, :counts[b]].long()] = 1
    assert torch.equal(mask, hit_sets)
    return want, counts


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(scene):
    sc = _on_card(scene)
    tables = (sc.cw.pack, sc.cw.ids, sc.cw.chunk_lo, sc.cw.chunk_hi)
    rays = _rays(sc, 4096, 'cuda')
    cw.reset_launch_counts()
    want, counts = _staged_equals_plain(sc, tables, rays)
    assert cw.launch_counts == {'split_closest_hit': 1, 'split_any_hit': 3,
                                'closest_hit_resident': 0,
                                'any_hit_resident': 0}
    assert (want[0] < cw.BIG).any() and int(counts[-1]) == 0
    (o, d, rng), _ = cw.sort_rays(sc.cw, *rays)
    with pytest.raises(ValueError):
        cw.walk_staged(tables[0].double(), *tables[1:], o, d, rng, False)
    with pytest.raises(ValueError):
        cw.walk_staged(*tables, o[:-1], d, rng, True)
    with pytest.raises(RuntimeError):  # splits the kernel does not take
        cw.walk_staged(*tables, o, d, rng, False, splits=0)


@pytest.mark.cuda
@pytest.mark.parametrize('splits', ['one', 'two', 'all'])
def test_staged_kernel_splits_on_card(scene, splits):
    """1, 2 and K chunk ranges per block; 1,000 rays (not a multiple of
    256) of which 300 dead, so the last block is all dead."""
    sc = _on_card(scene)
    tables = (sc.cw.pack, sc.cw.ids, sc.cw.chunk_lo, sc.cw.chunk_hi)
    S = {'one': 1, 'two': 2, 'all': sc.cw.pack.shape[0]}[splits]
    want, counts = _staged_equals_plain(sc, tables, _rays(sc, 1000, 'cuda'),
                                        splits=S)
    assert int(counts[-1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize('splits', ['one', 'two', 'all'])
def test_staged_kernel_planted_ties_on_card(scene, splits):
    """The same triangle in chunk 0 under ids X and -2 and in the last
    chunk under -3: the closest hit is -2 (smaller id within a chunk,
    earlier chunk across chunks, also when the two chunks lie in different
    ranges). Every live ray is occluded within chunk 0, the first of its
    list, so the any-hit ranges leave with copies of later chunks in
    flight."""
    sc = _on_card(scene)
    *tables, rays = planted_tie_case(scene)
    tables = [x.cuda() for x in tables]
    rays = [x.cuda() for x in rays]
    S = {'one': 1, 'two': 2, 'all': sc.cw.pack.shape[0]}[splits]
    (t, tid, _, _), counts = _staged_equals_plain(sc, tables, rays, splits=S)
    hit = t < cw.BIG
    assert (tid[hit] == -2).float().mean() > 0.9
    assert int(counts.max()) > 3 and int(counts[-1]) == 0


@pytest.mark.cuda
def test_resident_kernel_matches_plain_on_card(scene):
    sc = _on_card(scene)
    args = _inputs(sc, _rays(sc, 4096, 'cuda'))
    cw.reset_launch_counts()
    got = cw.walk_resident(*args, any_hit=False)
    want = cw.walk_reference(*args, any_hit=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(cw.walk_resident(*args, any_hit=True),
                       cw.walk_reference(*args, any_hit=True))
    assert cw.launch_counts == {'split_closest_hit': 0, 'split_any_hit': 0,
                                'closest_hit_resident': 1,
                                'any_hit_resident': 1}


@pytest.mark.cuda
def test_sweep_kernel_matches_plain_on_card(scene):
    sc = _on_card(scene)
    (mask, o, d, rng), _ = sw.prepare_rays(sc.sweep,
                                           *_rays(sc, 4096, 'cuda'))
    args = (sc.sweep.pack, sc.sweep.ids, mask, o, d, rng)
    sw.reset_launch_counts()
    got = sw.walk(*args, any_hit=False)
    want = sw.sweep_reference(*args, any_hit=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(sw.walk(*args, any_hit=True),
                       sw.sweep_reference(*args, any_hit=True))
    assert sw.launch_counts == {'closest_hit': 1, 'any_hit': 1}
    with pytest.raises(ValueError):
        sw.walk(*args[:2], mask.long(), *args[3:], any_hit=False)


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
