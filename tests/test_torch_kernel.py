"""The kernels' wrappers and the port's device defaults (no JAX in this
file, so it also runs on a machine with a card and no JAX):

* on CPU tensors the chunk-walk wrapper runs the plain version and counts
  no launch; the plain version's any hit equals the closest hit's hit set;
* on a card (marked `cuda`, skipped elsewhere): the chunk walk (K1/K2, and
  its resident form K3) and the culled sweep (K4), both variants of each,
  equal their plain versions exactly (the kernels are built with
  --fmad=false), each launch is counted under its own name, and bad inputs
  raise;
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
    t, tid, u, v = cw.walk(*args, any_hit=False)
    occ = cw.walk(*args, any_hit=True)
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


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(scene):
    sc = _on_card(scene)
    args = _inputs(sc, _rays(sc, 4096, 'cuda'))
    cw.reset_launch_counts()
    got = cw.walk(*args, any_hit=False)
    want = cw.walk_reference(*args, any_hit=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(cw.walk(*args, any_hit=True),
                       cw.walk_reference(*args, any_hit=True))
    assert cw.launch_counts == {'closest_hit': 1, 'any_hit': 1,
                                'closest_hit_resident': 0,
                                'any_hit_resident': 0}
    with pytest.raises(ValueError):
        cw.walk(args[0].double(), *args[1:], any_hit=False)
    with pytest.raises(ValueError):
        cw.walk(*args[:4], args[4][:-1], *args[5:], any_hit=True)


@pytest.mark.cuda
def test_resident_kernel_matches_plain_on_card(scene):
    sc = _on_card(scene)
    args = _inputs(sc, _rays(sc, 4096, 'cuda'))
    cw.reset_launch_counts()
    got = cw.walk(*args, any_hit=False, resident=True)
    want = cw.walk_reference(*args, any_hit=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(cw.walk(*args, any_hit=True, resident=True),
                       cw.walk_reference(*args, any_hit=True))
    assert cw.launch_counts == {'closest_hit': 0, 'any_hit': 0,
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
