"""Multi-device rendering in the port (parallel/, make_mlt_step's
film_shards) against the JAX package, in one process on the CPU:

* merge_stacked equals JAX's parallel.shardmap_step.merge_stacked and the
  numpy merge of tests/test_shardmap.py on the same seeded stacks: every
  stored entry and count exactly, score_sum (a sum over each row, whose
  order XLA, numpy and the port's fixed tree each choose) at rtol 1e-6;
  with full rows, empty tails and a path store;
* film_shards=S: the shards' sum equals the unsharded film from the same
  generator (rtol 1e-6), and every splat point carries its lane's shard,
  the large step's K-compact points through sel // (C // S);
* global_sum at one process; the mesh helpers and its device groups;
  the group generators;
* bootstrap_multihost at one process equals bootstrap with the rank-0
  folded generator exactly, and its two-rank reduction equals the JAX
  package's exactly;
* a one-process render over a 4-shard CPU mesh: finite, non-negative,
  b > 0, and the cache merge ran.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from langevin_mcmc_tpu.mcmc.cache import GlobalCache as JCache
from langevin_mcmc_tpu.parallel.shardmap_step import merge_stacked as jmerge
from langevin_mcmc_tpu_torch import testscenes
from langevin_mcmc_tpu_torch.integrators import mlt
from langevin_mcmc_tpu_torch.mcmc.cache import GlobalCache
from langevin_mcmc_tpu_torch.parallel import mesh as meshmod
from langevin_mcmc_tpu_torch.parallel import multihost
from langevin_mcmc_tpu_torch.parallel import shardmap_step as sm
from langevin_mcmc_tpu_torch.scene.parse import parse_scene
from test_shardmap import _np_merge

torch.set_num_threads(1)

FIELDS = ('pss', 'v1', 'v2', 'weight', 's_tag', 't_tag')


def _stacks(S, prev, seed, size=16, Dm=3):
    """Seeded per-shard cache stacks sharing their first prev[d] entries of
    each row; shard 1's tails are empty."""
    rng = np.random.default_rng(seed)
    ndim = len(prev)
    prev = np.asarray(prev, np.int32)
    counts = np.stack([np.minimum(prev + rng.integers(0, 7, ndim), size)
                       for _ in range(S)]).astype(np.int32)
    counts[1] = prev
    st = dict(
        pss=rng.random((S, ndim, size, Dm)).astype(np.float32),
        v1=rng.random((S, ndim, size, Dm)).astype(np.float32),
        v2=rng.random((S, ndim, size, Dm)).astype(np.float32),
        weight=rng.random((S, ndim, size)).astype(np.float32) + 0.1,
        s_tag=rng.integers(0, 5, (S, ndim, size)).astype(np.int32),
        t_tag=rng.integers(0, 5, (S, ndim, size)).astype(np.int32),
        count=counts)
    rec = dict(a=rng.random((S, ndim, size, 2)).astype(np.float32),
               b=rng.integers(0, 9, (S, ndim, size)).astype(np.int32))
    for k in FIELDS:
        for d in range(ndim):
            st[k][:, d, :prev[d]] = st[k][0, d, :prev[d]]
    for k in rec:
        for d in range(ndim):
            rec[k][:, d, :prev[d]] = rec[k][0, d, :prev[d]]
    return st, rec, prev


@pytest.mark.parametrize('S,prev', [
    (4, [0, 2, 16, 5, 1]),          # a full row (prev = SIZE)
    (3, [16, 16, 0, 0, 9, 15]),     # full rows, empty rows
    (2, [3, 0, 12]),
])
def test_merge_stacked_matches_jax_and_numpy(S, prev):
    st, rec, prev = _stacks(S, prev, seed=sum(prev) + S)
    score0 = np.zeros(st['count'].shape, np.float32)
    got = sm.merge_stacked(
        GlobalCache(**{k: torch.as_tensor(v) for k, v in st.items()},
                    score_sum=torch.as_tensor(score0),
                    rec={k: torch.as_tensor(v) for k, v in rec.items()}),
        torch.as_tensor(prev))
    want = jmerge(JCache(**{k: jnp.asarray(v) for k, v in st.items()},
                         score_sum=jnp.asarray(score0),
                         rec={k: jnp.asarray(v) for k, v in rec.items()}),
                  jnp.asarray(prev))
    np_want, np_count, np_score = _np_merge(st, prev)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.count.numpy(), np_count)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
        for d in range(len(prev)):
            n = np_count[d]
            np.testing.assert_array_equal(getattr(got, k).numpy()[d, :n],
                                          np_want[k][d, :n], err_msg=k)
    for k in rec:
        np.testing.assert_array_equal(got.rec[k].numpy(),
                                      np.asarray(want.rec[k]), err_msg=k)
    np.testing.assert_allclose(got.score_sum.numpy(),
                               np.asarray(want.score_sum), rtol=1e-6)
    np.testing.assert_allclose(got.score_sum.numpy(), np_score, rtol=1e-6)
    assert (np_count > prev).any()


def test_pairwise_sum_is_a_fixed_tree():
    x = torch.as_tensor(np.random.default_rng(0).random((5, 37)),
                        dtype=torch.float32)
    got = sm._pairwise_sum(x)
    np.testing.assert_allclose(got.numpy(), x.double().sum(1).numpy(),
                               rtol=1e-6)
    assert torch.equal(sm._pairwise_sum(x[:, :1]), x[:, 0])


@pytest.fixture(scope='module')
def small_box(tmp_path_factory):
    def make(**kw):
        xml = testscenes.write_scene(
            str(tmp_path_factory.mktemp('box')), small=True, width=16,
            height=12, max_depth=3, num_init_samples=512, num_chains=64,
            **kw)
        return parse_scene(xml, device='cpu')
    return make


@pytest.mark.parametrize('large_step', ['plain', 'multiplexed'])
def test_film_shards_sum_and_lanes(small_box, large_step, monkeypatch):
    scene, opts, _ = small_box(large_step=large_step)
    S, C = 4, opts.num_chains
    with torch.no_grad():
        b, ld, banked = mlt.bootstrap(scene, opts,
                                      torch.Generator().manual_seed(3),
                                      chunk=256)
        banked = mlt.attach_cache(banked, opts)
        films = {}
        seen = {}
        splat, take = mlt.splat, mlt.tree_take

        def spy_splat(film, scr, ctr, mask=None, shard_idx=None):
            seen['shard_idx'] = shard_idx
            return splat(film, scr, ctr, mask, shard_idx)

        def spy_take(obj, idx):
            seen.setdefault('sel', idx)
            return take(obj, idx)
        monkeypatch.setattr(mlt, 'splat', spy_splat)
        monkeypatch.setattr(mlt, 'tree_take', spy_take)
        for shards in (None, S):
            step = mlt.make_mlt_step(scene, opts, b, 0.3, length_dist=ld,
                                     film_shards=shards)
            shape = (scene.height, scene.width, 3)
            film = torch.zeros(shape if shards is None else (S,) + shape)
            seen.clear()
            step(torch.Generator().manual_seed(9), banked, film, banked)
            films[shards] = film
    np.testing.assert_allclose(films[S].sum(0).numpy(), films[None].numpy(),
                               rtol=1e-6, atol=1e-7)
    assert films[None].sum() > 0
    lane = torch.arange(C) // (C // S)
    sel = seen['sel']
    NB = mlt.bank_slots(opts, opts.max_depth)
    rest = seen['shard_idx'][C * NB + C:]
    per_large = rest.numel() // sel.numel()
    want = torch.cat([lane.repeat_interleave(NB), lane,
                      (sel // (C // S)).repeat_interleave(per_large)])
    assert sel.numel() < C and not torch.equal(sel, torch.arange(sel.numel()))
    assert torch.equal(seen['shard_idx'], want)
    assert (films[S].reshape(S, -1).sum(1) > 0).all()


def test_film_shards_must_divide_chains(small_box):
    scene, opts, _ = small_box()
    with pytest.raises(ValueError):
        mlt.make_mlt_step(scene, opts, 1.0, 0.3, film_shards=3)


def test_global_sum_single_process():
    assert multihost.process_count() == 1
    assert float(multihost.global_sum(np.float64(3.5))) == 3.5
    np.testing.assert_array_equal(multihost.global_sum(np.array([1.0, 2.0])),
                                  [1.0, 2.0])
    assert multihost.init_distributed(None, 1, 0, 'cpu') is None
    assert multihost.backend() is None


def test_mesh_shards_and_replicas():
    m = meshmod.make_chain_mesh(['cpu'] * 4)
    assert (m.num_shards, m.first_shard, m.world) == (4, 0, 1)
    assert m.groups == [(torch.device('cpu'), 0, 4)]
    # runs of shards on one device form the groups ('meta' holds no data)
    m = meshmod.ChainMesh(tuple(map(torch.device, ('cpu', 'cpu', 'meta',
                                                   'cpu'))), 0, 1)
    assert [g[1:] for g in m.groups] == [(0, 2), (2, 1), (3, 1)]
    x = torch.arange(24).reshape(8, 3)
    parts = meshmod.shard_chains(m, {'x': x, 's': torch.tensor(5)})
    assert len(parts) == 3
    assert torch.equal(parts[0]['x'], x[:4])
    assert parts[1]['x'].is_meta and parts[1]['x'].shape == (2, 3)
    assert torch.equal(parts[2]['x'], x[6:])
    assert int(parts[0]['s']) == 5 and int(parts[2]['s']) == 5
    with pytest.raises(ValueError):
        meshmod.shard_chains(m, {'x': torch.zeros(6)})
    reps = meshmod.replicate(m, {'x': x})
    assert len(reps) == 3 and torch.equal(reps[2]['x'], x)
    assert reps[1]['x'].is_meta


def test_shard_generators_differ_by_shard_and_repeat_by_seed():
    # one generator a group, seeded from its first shard's global index
    meshes = [meshmod.ChainMesh((torch.device('cpu'),) * 2, r, 3)
              for r in range(3)]
    draw = lambda seed: [torch.rand(4, generator=g) for m in meshes
                         for g in sm.shard_generators(m, seed)]
    a, b, c = draw(7), draw(7), draw(8)
    assert len(a) == 3
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    assert not torch.equal(a[0], c[0])
    want = torch.rand(4, generator=torch.Generator().manual_seed(
        sm.fold_seed(7, 2)))
    assert torch.equal(a[1], want)
    assert sm.fold_seed(7, 0) != sm.fold_seed(7, 1) < 2 ** 63


def test_bootstrap_multihost_single_process_equals_bootstrap(small_box):
    scene, opts, _ = small_box()
    with torch.no_grad():
        b1, ld1, s1 = multihost.bootstrap_multihost(scene, opts, 5,
                                                    chunk=256)
        b2, ld2, s2 = mlt.bootstrap(
            scene, opts, torch.Generator().manual_seed(sm.fold_seed(5, 0)),
            chunk=256)
    assert b1 == b2
    assert torch.equal(ld1.func, ld2.func) and torch.equal(ld1.cdf, ld2.cdf)
    leaves = []
    mlt.tree_map(lambda x, y: leaves.append(torch.equal(x, y)) or x, s1, s2)
    assert leaves and all(leaves)


@dataclasses.dataclass(frozen=True)
class _Opts:
    num_init_samples: int
    num_chains: int

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def test_bootstrap_multihost_two_rank_reduction_matches_jax(monkeypatch):
    """Two ranks' bootstrap outputs (stubbed, totals not proportional to
    their sample counts) through both packages' bootstrap_multihost, the
    collectives replaced by the rank-order sums: b and the length
    histogram equal the JAX package's exactly."""
    import jax
    from langevin_mcmc_tpu.integrators import mlt as jmlt
    from langevin_mcmc_tpu.parallel import multihost as jmh
    from langevin_mcmc_tpu.utils.distribution import Distribution1D as JDist
    from langevin_mcmc_tpu_torch.utils.distribution import Distribution1D
    rng = np.random.default_rng(4)
    local = [(0.37, rng.random(8)), (2.9, rng.random(8) * 40.0)]
    opts = _Opts(num_init_samples=1000, num_chains=64)
    scene = types.SimpleNamespace(device=torch.device('cpu'))

    def run(port, rank, sums):
        """bootstrap_multihost of one package on rank of 2; returns (b,
        length_dist func, the values it summed)."""
        seen = []

        def gsum(x):
            seen.append(np.asarray(x, np.float64))
            return x if sums is None else sums[len(seen) - 1]
        b_loc, lc = local[rank]
        if port:
            monkeypatch.setattr(multihost, 'process_count', lambda: 2)
            monkeypatch.setattr(multihost, 'process_index', lambda: rank)
            monkeypatch.setattr(multihost, 'global_sum', gsum)
            monkeypatch.setattr(mlt, 'bootstrap', lambda *a, **k: (
                b_loc, Distribution1D(lc / lc.sum(), device='cpu'), None))
            b, ld, _ = multihost.bootstrap_multihost(scene, opts, 5)
            func = ld.func.numpy()
        else:
            monkeypatch.setattr(jmh, 'jax', types.SimpleNamespace(
                process_count=lambda: 2, process_index=lambda: rank,
                random=jax.random))
            monkeypatch.setattr(jmh, 'global_sum', gsum)
            monkeypatch.setattr(jmlt, 'bootstrap', lambda *a, **k: (
                b_loc, JDist(lc / lc.sum()), None))
            b, ld, _ = jmh.bootstrap_multihost(None, opts,
                                               jax.random.PRNGKey(0))
            func = np.asarray(ld.func)
        return b, func, seen

    for port in (False, True):
        rows = [run(port, r, None)[2] for r in range(2)]
        sums = [a + b for a, b in zip(*rows)]
        got = [run(port, r, sums)[:2] for r in range(2)]
        if port:
            want_rows, want = jrows, jgot
            for a, b in zip(rows, want_rows):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            for (b, f), (jb, jf) in zip(got, want):
                assert b == jb
                np.testing.assert_array_equal(f, jf)
        jrows, jgot = rows, got
    assert got[0][0] == got[1][0]
    np.testing.assert_array_equal(got[0][1], got[1][1])
    # the data tell the weighted histogram from the summed contributions
    raw = local[0][1] + local[1][1]
    assert not np.allclose(got[0][1], (raw / raw.sum()).astype(np.float32))


def test_render_over_a_four_shard_cpu_mesh(small_box, monkeypatch):
    scene, opts, _ = small_box()
    monkeypatch.setattr(multihost, 'MERGE_EVERY', 1)
    tm, parts = {}, {}
    m = meshmod.make_chain_mesh(['cpu'] * 4)
    with torch.no_grad():
        film, b = multihost.render_mlt_multihost(
            scene, opts, 3, num_steps=6, chunk=256, timings=tm, mesh=m,
            parts=parts)
    f = film.numpy()
    assert f.shape == (scene.height, scene.width, 3)
    assert np.isfinite(f).all() and f.min() >= 0.0 and f.sum() > 0.0
    assert b > 0.0
    assert tm['shards'] == 4 and tm['steps'] == 6 and tm['merges'] == 1
    assert tm['accepts'] > 0
    assert parts['chain_film'].shape == film.shape
