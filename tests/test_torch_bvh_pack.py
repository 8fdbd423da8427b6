"""The BVH kernel's tables (ops/bvh.py pack_bvh) and its control flow, on
the CPU, on the small generated box, open and moving open scenes:

* pack_bvh's invariants: every record's child boxes are the children's
  node boxes bit for bit, a leaf's reference is its (first, count), an
  inner child's is its record; the leaf-ordered triangles are
  tri_p[:, prim_ids] bit for bit with the ids in lane 3; the records are
  the inner nodes in breadth-first order, and with the leaves they
  reference they cover every node once; a tree whose root is a leaf
  (T <= 4) packs to no record and a leaf root; a scene built from host
  arrays with a BVH carries its tables;
* a per-ray Python model of csrc/bvh.cu's walk (one record a step, the
  next node in a register, the right child pushed only when both hit,
  leaf references, the any-hit early exit), run on the packed tables
  with traverse_reference's own _ray_box and _tri_test on one-row
  tensors so that every product and sum rounds as there, equals
  traverse_reference bit for bit on ~200 rays a scene (dead rays and
  rays with a finite max_t among them), on a root-leaf tree, and on a
  planted tie: coincident triangles in different leaves, where the first
  in depth-first order wins;
* the tie between the tables and their tree: pack_bvh refuses a tree
  deeper than the stack, the traversal refuses tables packed from another
  node tensor (a same-size tree swapped into the scene), and replicating
  a scene onto another device keeps the tie.
The card runs the kernel itself against traverse_reference
(test_torch_kernel.py, marked `cuda`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.ops import bvh
from langevin_mcmc_tpu_torch.parallel.mesh import ChainMesh, replicate
from langevin_mcmc_tpu_torch.scene.parse import parse_scene, parse_scene_host
from langevin_mcmc_tpu_torch.scene.scenedata import build_scene
from torch_parity import coincident_copies, left_chain_nodes, with_triangles

torch.set_num_threads(1)
R = 200
SCENES = {'box': {}, 'open': dict(scene='open'),
          'motion': dict(scene='open', motion=True)}


@pytest.fixture(scope='module', params=list(SCENES))
def scene(request, tmp_path_factory):
    xml = testscenes.write_scene(str(tmp_path_factory.mktemp('pack')),
                                 small=True, width=32, height=24,
                                 **SCENES[request.param])
    return bvh.attach_bvh(parse_scene(xml, device='cpu')[0])


def _rays(scene, n, seed, aim=None):
    """Seeded rays towards random triangles (towards triangle `aim` when
    given): a fifth with a finite max_t, a tenth dead, random times."""
    rng = np.random.default_rng(seed)
    tp = scene.tri_p[0].numpy()
    T = tp.shape[0]
    org = (tp[rng.integers(0, T, n)].mean(1)
           + rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    tgt = tp[np.full(n, aim) if aim is not None
             else rng.integers(0, T, n)].mean(1)
    d = tgt - org
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    time = rng.random(n).astype(np.float32)
    mn = np.full(n, 1e-2, np.float32)
    mx = np.where(rng.random(n) < 0.2, rng.random(n) * 2.0,
                  np.inf).astype(np.float32)
    mx[rng.random(n) < 0.1] = 0.0
    return [torch.as_tensor(x) for x in (org, d, time, mn, mx)]


def _bits(x):
    return x.contiguous().view(torch.int32)


def _child_refs(packed):
    b = _bits(packed.records)
    return b[:, 12].long(), b[:, 13].long()


def _record_nodes(nodes, packed):
    """The node of each record: the root's is node 0, and an inner child's
    record is its parent's child node (a parent's record comes first)."""
    order = [0] * packed.records.shape[0]
    for i, refs in enumerate(_bits(packed.records)[:, 12:14].tolist()):
        n = order[i]
        for child, ref in zip((int(nodes[n, 6]), int(-nodes[n, 7])), refs):
            if ref >= 0:
                assert ref > i
                order[ref] = child
    return torch.tensor(order, dtype=torch.int64)


def test_records_hold_the_children(scene):
    nodes, p = scene.bvh_nodes, scene.bvh_packed
    nb = _bits(nodes)
    rb = _bits(p.records)
    order = _record_nodes(nodes, p)
    left = nodes[order, 6].long()
    right = (-nodes[order, 7]).long()
    assert (nodes[order, 7] <= 0).all()
    assert torch.equal(rb[:, 0:6], nb[left, 0:6])
    assert torch.equal(rb[:, 6:12], nb[right, 0:6])
    assert (rb[:, 14:16] == 0).all()
    for child, ref in zip((left, right), _child_refs(p)):
        is_leaf = nodes[child, 7] > 0
        first = nodes[child, 6].long()
        count = nodes[child, 7].long()
        assert torch.equal(ref < 0, is_leaf)
        assert torch.equal(~ref[is_leaf], (first[is_leaf] << 3)
                           | count[is_leaf])
        assert torch.equal(order[ref[~is_leaf]], child[~is_leaf])
    assert p.root == 0 and p.nodes is nodes
    assert p.depth == bvh.tree_depth(nodes.numpy())


def test_leaf_ordered_triangles(scene):
    p = scene.bvh_packed
    ids = scene.bvh_prim_ids.long()
    assert p.tris.shape == (2, scene.num_tris, 3, 4)
    tb = _bits(p.tris)
    assert torch.equal(tb[..., :3], _bits(scene.tri_p[:, ids]))
    assert torch.equal(tb[:, :, 0, 3], scene.bvh_prim_ids.expand(2, -1))
    assert (tb[:, :, 1:, 3] == 0).all()


def test_breadth_first_order_covers_every_node_once(scene):
    nodes, p = scene.bvh_nodes, scene.bvh_packed
    N = nodes.shape[0]
    depth = np.zeros(N, np.int64)
    for i, row in enumerate(nodes.numpy()):
        if row[7] <= 0.0:
            for c in (int(row[6]), int(-row[7])):
                depth[c] = depth[i] + 1
    order = _record_nodes(nodes, p).numpy()
    assert (np.diff(depth[order]) >= 0).all()
    inner = np.flatnonzero(nodes[:, 7].numpy() <= 0.0)
    assert sorted(order.tolist()) == inner.tolist()
    # the root, the records' inner children and the leaves they reference
    seen = [0] + [int(order[r]) for ref in _child_refs(p)
                  for r in ref[ref >= 0]]
    leaf_of = {(int(f) << 3) | int(c): i for i, (f, c) in enumerate(
        zip(nodes[:, 6].long(), nodes[:, 7].long())) if c > 0}
    seen += [leaf_of[int(~r)] for ref in _child_refs(p) for r in ref[ref < 0]]
    assert sorted(seen) == list(range(N))


def _model(packed, org, d, time, min_t, max_t, any_hit, has_motion):
    """csrc/bvh.cu's walk, one ray at a time, on the packed tables; each
    box and triangle test is traverse_reference's own on one-row
    tensors."""
    rec = packed.records
    refs = _bits(rec)[:, 12:14].tolist()
    tri_xyz = packed.tris[..., :3]
    ids = _bits(packed.tris)[0, :, 0, 3]
    inv_d = 1.0 / torch.where(d == 0.0, torch.full_like(d, 1e-20), d)
    R_ = org.shape[0]
    out_t = torch.full((R_,), float('inf'))
    out_id = torch.zeros(R_, dtype=torch.int32)
    out_u = torch.zeros(R_)
    out_v = torch.zeros(R_)
    for r in range(R_):
        o, dd, iv = org[r:r + 1], d[r:r + 1], inv_d[r:r + 1]
        tm, lo, hi = time[r:r + 1], min_t[r:r + 1], max_t[r:r + 1]
        best_t, best_id = torch.full((1,), float('inf')), 0
        best_u, best_v = torch.zeros(1), torch.zeros(1)
        stack, node = [], packed.root
        while True:
            if node >= 0:
                tmax = torch.minimum(hi, best_t)
                lhit = bool(bvh._ray_box(iv, o, rec[node:node + 1, 0:6], lo,
                                         tmax))
                rhit = bool(bvh._ray_box(iv, o, rec[node:node + 1, 6:12], lo,
                                         tmax))
                lref, rref = refs[node]
                if lhit:
                    if rhit:
                        stack.append(rref)
                    node = lref
                    continue
                if rhit:
                    node = rref
                    continue
            else:
                first, count = (~node) >> 3, (~node) & 7
                for j in range(first, first + count):
                    t, u, v, div = bvh._tri_test(
                        tri_xyz, torch.tensor([j]), o, dd, tm, has_motion)
                    if bool((div != 0.0) & (u >= 0.0) & (v >= 0.0)
                            & (u + v <= 1.0) & (t >= lo) & (t <= hi)
                            & (t < best_t)):
                        best_t, best_id, best_u, best_v = t, int(ids[j]), u, v
                if any_hit and bool(torch.isfinite(best_t)):
                    break
            if not stack:
                break
            node = stack.pop()
            assert len(stack) < bvh.STACK_DEPTH
        out_t[r], out_id[r], out_u[r], out_v[r] = (best_t[0], best_id,
                                                   best_u[0], best_v[0])
    if any_hit:
        return torch.isfinite(out_t)
    return out_t, out_id, out_u, out_v


def _model_equals_reference(sc, rays, any_hit):
    tabs = (sc.bvh_nodes, sc.bvh_prim_ids, sc.tri_p)
    want = bvh.traverse_reference(*tabs, *rays, any_hit, sc.has_motion)
    got = _model(sc.bvh_packed, *rays, any_hit, sc.has_motion)
    if any_hit:
        assert torch.equal(got, torch.isfinite(want))
        return got
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize('any_hit', [False, True])
def test_kernel_model_equals_reference(scene, any_hit):
    rays = _rays(scene, R, seed=11)
    got = _model_equals_reference(scene, rays, any_hit)
    hit = got if any_hit else torch.isfinite(got[0])
    live = rays[4] >= rays[3]
    assert hit.any() and (live & ~hit).any() and not hit[~live].any()


@pytest.mark.parametrize('any_hit', [False, True])
def test_root_leaf_tree(scene, any_hit):
    sc = with_triangles(scene, scene.tri_p[:, :3].numpy())
    p = sc.bvh_packed
    assert p.records.shape == (0, 16)
    assert p.root == bvh.leaf_ref(0, 3) < 0
    rays = _rays(sc, 64, seed=12, aim=1)
    got = _model_equals_reference(sc, rays, any_hit)
    assert (got if any_hit else torch.isfinite(got[0])).any()


def test_planted_tie_first_in_depth_first_order_wins(scene):
    """Six coincident copies of one triangle split across leaves: rays
    aimed at it hit every copy at one t, and the first copy in
    depth-first (leaf) order wins, in the model as in the reference."""
    tie = 5
    sc, copies = coincident_copies(scene, tie, 5)
    pos = {int(i): j for j, i in enumerate(sc.bvh_prim_ids)}
    nodes = sc.bvh_nodes
    leaves = {(int(f), int(c)) for f, c in zip(nodes[:, 6], nodes[:, 7])
              if c > 0}
    leaf_of = {i: next(lf for lf in leaves if lf[0] <= pos[i] < sum(lf))
               for i in copies}
    assert len(set(leaf_of.values())) >= 2
    rays = _rays(sc, 64, seed=13, aim=tie)
    rays[2] = torch.zeros_like(rays[2])     # at keyframe 0, where aimed
    rays[4] = torch.full_like(rays[4], float('inf'))
    t, tid, _, _ = _model_equals_reference(sc, rays, False)
    hit_copy = torch.isin(tid, torch.tensor(copies)) & torch.isfinite(t)
    assert hit_copy.sum() > 10
    first = min(copies, key=lambda i: pos[i])
    assert (tid[hit_copy] == first).all()


def test_build_scene_packs_a_carried_bvh(tmp_path):
    """A scene built from host arrays that carry a BVH (use_bvh) has the
    kernel's tables; one without a BVH has none."""
    xml = testscenes.write_scene(str(tmp_path), small=True, width=16,
                                 height=12)
    host, _, _ = parse_scene_host(xml)
    plain = build_scene(dict(host), device='cpu')
    assert plain.bvh_packed is None and not plain.use_bvh
    nodes, prims = bvh.build_bvh(np.asarray(host['tri_p'], np.float32))
    sc = build_scene(dict(host, bvh_nodes=nodes, bvh_prim_ids=prims,
                          use_bvh=True), device='cpu')
    got = sc.bvh_packed
    want = bvh.pack_bvh(sc.bvh_nodes, sc.bvh_prim_ids, sc.tri_p)
    assert torch.equal(_bits(got.records), _bits(want.records))
    assert torch.equal(_bits(got.tris), _bits(want.tris))
    assert got.root == want.root == 0
    assert got.nodes is sc.bvh_nodes


@pytest.mark.parametrize('extra', [0, 1])
def test_pack_bvh_refuses_a_tree_deeper_than_the_stack(scene, extra):
    """pack_bvh checks the depth of the tree whose tables the kernel
    walks: STACK_DEPTH levels pack, one more raises."""
    nodes = left_chain_nodes(bvh.STACK_DEPTH - 1 + extra, scene.num_tris)
    assert bvh.tree_depth(nodes.numpy()) == bvh.STACK_DEPTH + extra
    if extra:
        with pytest.raises(ValueError, match='levels'):
            bvh.pack_bvh(nodes, scene.bvh_prim_ids, scene.tri_p)
    else:
        p = bvh.pack_bvh(nodes, scene.bvh_prim_ids, scene.tri_p)
        assert p.depth == bvh.STACK_DEPTH and p.nodes is nodes


def test_traversal_refuses_the_tables_of_another_tree(scene):
    """A tree of the same size (the root's children swapped) put into the
    scene without its tables raises, on the CPU as on the card; packed
    anew, it is walked as traverse_reference walks it."""
    nodes = scene.bvh_nodes.clone()
    nodes[0, 6] = -scene.bvh_nodes[0, 7]
    nodes[0, 7] = -scene.bvh_nodes[0, 6]
    swapped = dataclasses.replace(scene, bvh_nodes=nodes)
    rays = _rays(scene, 64, seed=14)
    for fn in (bvh.intersect_bvh, bvh.occluded_bvh):
        with pytest.raises(ValueError, match='another node tensor'):
            fn(swapped, *rays)
    repacked = dataclasses.replace(swapped, bvh_packed=bvh.pack_bvh(
        nodes, scene.bvh_prim_ids, scene.tri_p))
    hit, tid, _, _, _ = bvh.intersect_bvh(repacked, *rays)
    t, want_id, _, _ = bvh.traverse_reference(
        nodes, scene.bvh_prim_ids, scene.tri_p, *rays, False,
        scene.has_motion)
    assert hit.any() and torch.equal(hit, torch.isfinite(t))
    assert torch.equal(tid, want_id)


def test_replicate_keeps_the_tables_tied(scene):
    """A scene replicated onto another device (here the meta device) gets
    one copy of its node tensor, shared by the scene and its tables."""
    (sc,) = replicate(ChainMesh((torch.device('meta'),), 0, 1), scene)
    assert sc.bvh_nodes.is_meta and sc.bvh_nodes is not scene.bvh_nodes
    assert sc.bvh_packed.nodes is sc.bvh_nodes
