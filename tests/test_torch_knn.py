"""MALA's kNN moments (mcmc/cache.py query_knn) and their kernel,
csrc/knn.cu (no JAX in this file, so it also runs on a machine with a card
and no JAX; the JAX package's query_knn is held against the plain version
in test_torch_mcmc.py):

* on CPU tensors query_knn is the plain version knn_reference, which
  equals a per-lane numpy brute force exactly: distances subtract-then-
  square summed in ascending coordinate order, the k best by distance then
  entry index, the weights and weighted rows summed over the best in that
  order. Cases: exact duplicates and equal distances planted (the lower
  index wins), rows with fewer live entries than k, an empty row, lanes
  whose dims pass pss_max_length (clamped to the last row, all their
  coordinates counted), and k and Dm at the kernel's bounds (8, 32);
* the kernel's wrapper raises for k or Dm past those bounds, and counts
  its launches in the trace registry under 'mcmc.cache';
* on a card (marked `cuda`, skipped elsewhere): the kernel against the
  plain version on the card at the flagship's shapes (16,384 lanes, 13
  rows of 3,000 entries, Dm 16, k 5) with duplicates planted, and at the
  bounds (k 8, Dm 32; k 1, Dm 6, whose rows take the 4-byte copies):
  found bit for bit, v1 and v2 within rtol 1e-6 (the kernel sums w and
  w * v over the k best in ascending (distance, index) order, each
  product rounded before its add, as the plain version does); one launch
  a query; a query captured in a CUDA graph replays to the eager answer;
  and captured MALA steps in the cache phase equal the eager steps from
  the same state and seed bit for bit, with two kNN launches an
  iteration.
"""

import dataclasses

import numpy as np
import pytest
import torch

from langevin_mcmc_tpu_torch import Options, testscenes
from langevin_mcmc_tpu_torch.mcmc import cache as cache_mod
from langevin_mcmc_tpu_torch.ops import tracing

torch.set_num_threads(1)


def _cache(opts, Dm, rng, counts, device='cpu'):
    """A cache of NDIM = pss_max_length + 1 rows of pss_max_size entries:
    uniform pss, v1 = entry index + a row offset in every coordinate (so a
    result names the entries it averaged), v2 random; counts per row."""
    ndim, size = opts.pss_max_length + 1, opts.pss_max_size
    pss = rng.random((ndim, size, Dm), dtype=np.float32)
    v1 = np.broadcast_to(
        (np.arange(size, dtype=np.float32)[None, :, None]
         + 10000.0 * np.arange(ndim, dtype=np.float32)[:, None, None]),
        (ndim, size, Dm)).copy()
    v2 = rng.random((ndim, size, Dm), dtype=np.float32)
    c = cache_mod.make_cache(opts, Dm, device)
    t = lambda a: torch.as_tensor(a, device=device)
    return dataclasses.replace(
        c, pss=t(pss), v1=t(v1), v2=t(v2),
        count=t(np.asarray(counts, dtype=np.int32)))


def _brute(cache, dims, q, opts):
    """The kernel's rules lane by lane in numpy float32."""
    pss, v1, v2 = (x.cpu().numpy() for x in (cache.pss, cache.v1, cache.v2))
    count = cache.count.cpu().numpy()
    ndim, _, Dm = pss.shape
    k = opts.pss_knn
    r2 = np.float32(opts.pss_query_dist ** 2)
    C = q.shape[0]
    found = np.zeros(C, bool)
    o1 = np.zeros((C, Dm), np.float32)
    o2 = np.zeros((C, Dm), np.float32)
    for c in range(C):
        dim = int(dims[c])
        row = min(max(dim, 0), ndim - 1)
        live = pss[row, :max(int(count[row]), 0)]
        dist = np.zeros(live.shape[0], np.float32)
        for j in range(min(max(dim, 0), Dm)):
            y = q[c, j] - live[:, j]
            dist = dist + y * y
        best = np.lexsort((np.arange(dist.shape[0]), dist))[:k]
        radius = np.float32(dim) * r2
        wsum = np.float32(0.0)
        for i in best:
            if dist[i] <= radius:
                w = np.float32(1.0) / (dist[i] * dist[i] + np.float32(1e-6))
                wsum = wsum + w
                o1[c] = o1[c] + w * v1[row, i]
                o2[c] = o2[c] + w * v2[row, i]
                found[c] = True
        wsum = max(wsum, np.float32(1e-30))
        o1[c] = o1[c] / wsum
        o2[c] = o2[c] / wsum
    return found, o1, o2


def _queries(cache, dims, rng, near=0.5, jitter=1e-3):
    """Queries: a share `near` within jitter of a live entry of the lane's
    row (exactly on it when jitter is 0), the rest uniform."""
    pss = cache.pss.cpu().numpy()
    count = cache.count.cpu().numpy()
    ndim, _, Dm = pss.shape
    q = rng.random((len(dims), Dm), dtype=np.float32)
    for c, dim in enumerate(dims):
        row = min(max(int(dim), 0), ndim - 1)
        if count[row] > 0 and rng.random() < near:
            e = pss[row, rng.integers(0, count[row])]
            q[c] = e + (rng.normal(size=Dm) * jitter).astype(np.float32)
    return q


def _check(cache, dims, q, opts):
    """query_knn on CPU tensors against _brute, exactly. Returns found."""
    got = cache_mod.query_knn(cache, torch.as_tensor(dims),
                              torch.as_tensor(q), opts)
    want = _brute(cache, dims, q, opts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    return want[0]


def _opts(**kw):
    return dataclasses.replace(Options(), pss_max_size=64, **kw)


def test_plain_version_equals_brute_force():
    opts = _opts()
    rng = np.random.default_rng(1)
    counts = rng.integers(0, 65, opts.pss_max_length + 1)
    counts[5] = 64
    cache = _cache(opts, 16, rng, counts)
    dims = rng.integers(2, 13, 300).astype(np.int32)
    found = _check(cache, dims, _queries(cache, dims, rng), opts)
    assert 0 < found.sum() < len(found)


def test_ties_go_to_the_lower_index():
    """k = 2. Lane 0 sits on exact copies of an entry at indices 40, 3 and
    10 of a row; lane 1 lies exactly 0.25 in one coordinate from entries
    50, 21 and 60 (0.75 or 0.25 against 0.5). Each keeps the two lowest
    indices of its tie: v1 (the entry index plus the row's offset) is
    their mean."""
    opts = _opts(pss_knn=2, pss_query_dist=0.2)
    Dm, row = 8, 6
    rng = np.random.default_rng(2)
    cache = _cache(opts, Dm, rng, [64] * (opts.pss_max_length + 1))
    pss = cache.pss.numpy()
    pss[row] += 2.0                       # every other entry far away
    e = np.full(Dm, 0.5, np.float32)
    f = e.copy()
    f[1] = 0.0                            # 0.25 from the copies: out
    for i in (40, 3, 10):
        pss[row, i] = e
    for i, j, x in ((50, 0, 0.75), (21, 0, 0.25), (60, 2, 0.75)):
        pss[row, i] = f
        pss[row, i, j] = x
    dims = np.array([row, row], np.int32)
    found = _check(cache, dims, np.stack([e, f]), opts)
    assert found.all()
    v1 = cache_mod.query_knn(cache, torch.as_tensor(dims),
                             torch.as_tensor(np.stack([e, f])), opts)[1]
    base = 10000.0 * row
    np.testing.assert_allclose(v1[:, 0].numpy(), [base + 6.5, base + 35.5],
                               rtol=0, atol=0.02)


def test_short_and_empty_rows():
    """Rows with fewer live entries than k (the entries past the count,
    planted on the query, are not seen) and an empty row (found False,
    moments 0)."""
    opts = _opts(pss_knn=5)
    Dm = 8
    rng = np.random.default_rng(3)
    counts = [64] * (opts.pss_max_length + 1)
    counts[4], counts[6], counts[8] = 2, 0, 4
    cache = _cache(opts, Dm, rng, counts)
    pss = cache.pss.numpy()
    dims = np.array([4, 4, 6, 8, 8, 8], np.int32)
    q = _queries(cache, dims, rng, near=1.0, jitter=0.0)
    pss[4, 2:] = q[0]      # dead entries on the query
    pss[8, 4:] = q[3]
    found = _check(cache, dims, q, opts)
    assert found[[0, 1, 3, 4, 5]].all() and not found[2]
    _, v1, v2 = cache_mod.query_knn(cache, torch.as_tensor(dims),
                                    torch.as_tensor(q), opts)
    assert (v1[2] == 0).all() and (v2[2] == 0).all()
    assert (v1[[0, 1]] < 10000.0 * 4 + 2).all()
    assert (v1[3:] < 10000.0 * 8 + 4).all()


def test_dims_past_the_last_row_are_clamped():
    """Lanes of dims 14 and 16 (pss_max_length 12) query row 12 with all
    their coordinates and their own radius; negative and zero dims query
    row 0 with no coordinate."""
    opts = _opts()
    Dm = 16
    rng = np.random.default_rng(4)
    cache = _cache(opts, Dm, rng, [64] * (opts.pss_max_length + 1))
    dims = np.array([12, 13, 14, 16, 20, 0, -3] * 6, np.int32)
    q = _queries(cache, dims, rng, near=0.8)
    found = _check(cache, dims, q, opts)
    assert found[dims >= 12].any()


@pytest.mark.parametrize('k,Dm', [(8, 32), (1, 6), (8, 5)])
def test_plain_version_at_the_kernel_bounds(k, Dm):
    opts = _opts(pss_knn=k)
    rng = np.random.default_rng(5 + k + Dm)
    counts = rng.integers(0, 65, opts.pss_max_length + 1)
    cache = _cache(opts, Dm, rng, counts)
    dims = rng.integers(2, Dm + 3, 200).astype(np.int32)
    _check(cache, dims, _queries(cache, dims, rng, jitter=3e-3), opts)


@pytest.mark.parametrize('k,Dm', [(9, 16), (0, 16), (5, 33)])
def test_wrapper_raises_past_the_kernel_bounds(k, Dm):
    opts = _opts(pss_knn=k)
    rng = np.random.default_rng(6)
    cache = _cache(opts, Dm, rng, [8] * (opts.pss_max_length + 1))
    dims = torch.full((4,), 4, dtype=torch.int32)
    with pytest.raises(ValueError, match='kNN kernel'):
        cache_mod.knn_kernel(cache, dims, torch.zeros(4, Dm), opts)


def test_launch_counter_is_registered():
    """The kernel's launches are a registry counter that StepGraphs keeps
    counting under replay, filed under mcmc.cache (outside the ray-query
    modules whose counts isect_launches_per_iter reads)."""
    assert any(c is cache_mod.launch_counts for c in tracing._counters)
    assert tracing.snapshot()['launches']['mcmc.cache'] == \
        dict(cache_mod.launch_counts)
    cache_mod.reset_launch_counts()
    assert cache_mod.launch_counts == {'query': 0}


def test_knn_lane_counters_while_tracing():
    """count_knn adds a query's budget to the host count of its side and
    the lanes in need on the device, only while tracing."""
    need = torch.tensor([True, False, True, True])
    tracing.count_knn('cur', need, 4)      # off: nothing
    tracing.enable('cpu')
    try:
        a = tracing.snapshot()
        tracing.count_knn('cur', need, 4)
        tracing.count_knn('prop', need[:2], 2)
        d = tracing.delta(a, tracing.snapshot())
    finally:
        tracing.disable()
    assert d['launches']['knn_budget'] == dict(cur=4, prop=2)
    assert d['knn_need'] == dict(cur=3, prop=1)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


def flagship_case(device, k=5, Dm=16, lanes=16384, seed=7):
    """The flagship's query: 13 rows of 3,000 entries (rows 4 and 9 short,
    row 6 empty), lanes of dims 2-16 (14 and 16 clamped to row 12; with
    Dm 32 also 24 and 32), a third on a live entry exactly, a third within
    1e-3 of one; every row holds exact copies of its entries 0-99 at
    2,000-2,099. Returns (cache, dims, pss, opts) on device."""
    opts = dataclasses.replace(Options(), pss_knn=k)
    rng = np.random.default_rng(seed)
    counts = [3000] * (opts.pss_max_length + 1)
    counts[4], counts[9], counts[6] = 2100, 40, 0
    cache = _cache(opts, Dm, rng, counts)
    cache.pss[:, 2000:2100] = cache.pss[:, :100]
    choices = [2, 4, 6, 8, 9, 10, 12, 14, 16] + ([24, 32] if Dm > 16 else [])
    dims = rng.choice(choices, lanes).astype(np.int32)
    pss = cache.pss.numpy()
    q = rng.random((lanes, Dm), dtype=np.float32)
    for c in range(lanes):
        row = min(int(dims[c]), opts.pss_max_length)
        if c % 3 < 2 and counts[row] > 0:
            e = pss[row, rng.integers(0, min(counts[row], 100))]
            q[c] = e if c % 3 == 0 else \
                e + (rng.normal(size=Dm) * 1e-3).astype(np.float32)
    cache = dataclasses.replace(
        cache, **{f.name: getattr(cache, f.name).to(device)
                  for f in dataclasses.fields(cache)
                  if isinstance(getattr(cache, f.name), torch.Tensor)})
    return (cache, torch.as_tensor(dims, device=device),
            torch.as_tensor(q, device=device), opts)


def _kernel_equals_plain(cache, dims, q, opts):
    cache_mod.reset_launch_counts()
    got = cache_mod.query_knn(cache, dims, q, opts)
    assert cache_mod.launch_counts == {'query': 1}
    want = cache_mod.knn_reference(cache, dims, q, opts)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0.0)
    return want


@pytest.mark.cuda
def test_kernel_matches_plain_at_the_flagship_shapes():
    dev = _card()
    cache, dims, q, opts = flagship_case(dev)
    found, _, _ = _kernel_equals_plain(cache, dims, q, opts)
    on_entry = (torch.arange(len(dims), device=dev) % 3 == 0) & (dims != 6)
    assert found[on_entry].all() and not found[dims == 6].any()
    assert int(found.sum()) < len(found)


@pytest.mark.cuda
@pytest.mark.parametrize('k,Dm', [(8, 32), (1, 6)])
def test_kernel_matches_plain_at_the_bounds(k, Dm):
    dev = _card()
    cache, dims, q, opts = flagship_case(dev, k=k, Dm=Dm, lanes=4096,
                                         seed=8)
    _kernel_equals_plain(cache, dims, q, opts)
    with pytest.raises(ValueError):
        cache_mod.query_knn(cache, dims, q,
                            dataclasses.replace(opts, pss_knn=9))


@pytest.mark.cuda
def test_kernel_query_captures():
    """No host read: a query captured in a CUDA graph replays to the
    eager answer."""
    dev = _card()
    cache, dims, q, opts = flagship_case(dev, lanes=4096, seed=9)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        want = cache_mod.query_knn(cache, dims, q, opts)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = cache_mod.query_knn(cache, dims, q, opts)
    for o in out:
        o.zero_()
    g.replay()
    torch.cuda.synchronize()
    for a, b in zip(want, out):
        assert torch.equal(a, b)


def _prefill(banked, opts, times=2):
    """Every seed state pushed `times` times into the cache, so that the
    rows with at least pss_max_size / times seed states fill."""
    from langevin_mcmc_tpu_torch.path.records import get_path_pss, pss_dim
    st = banked.state
    C, Dm = opts.num_chains, 2 * opts.max_depth
    dev = st.ls_score.device
    zero = torch.zeros((C, Dm), device=dev)
    cache = banked.cache
    for _ in range(times):
        cache = cache_mod.push_batch(
            cache, pss_dim(st.rec), get_path_pss(st.rec, Dm), zero, zero,
            st.ls_score, torch.ones(C, dtype=torch.bool, device=dev), opts)
    return dataclasses.replace(banked, cache=cache)


@pytest.mark.cuda
def test_captured_mala_cache_steps_equal_eager(tmp_path):
    """From one bootstrapped state with full cache rows and one generator
    state: 4 eager MALA steps against one call of the multi-step (warm-up,
    capture, replays). The chain state is equal bit for bit, and each
    side queries the kernel once an iteration."""
    from langevin_mcmc_tpu_torch.integrators import mlt
    from langevin_mcmc_tpu_torch.scene.parse import parse_scene
    from langevin_mcmc_tpu_torch.utils.tree import tree_leaves
    dev = _card()
    xml = testscenes.write_scene(str(tmp_path), small=True, width=32,
                                 height=24, num_chains=4096,
                                 num_init_samples=4096)
    scene, opts, _ = parse_scene(xml, device='cuda')
    opts = dataclasses.replace(opts, pss_max_size=1024)
    steps, lsp = 4, opts.large_step_probability
    gen = torch.Generator(device=dev).manual_seed(2)
    shape = (scene.height, scene.width, 3)
    with torch.no_grad():
        b, ld, init = mlt.bootstrap(scene, opts, gen, chunk=4096)
        banked0 = _prefill(mlt.attach_cache(init, opts), opts)
        assert int((banked0.cache.count >= banked0.cache.size).sum()) > 0
        state0 = gen.get_state()
        step = mlt.make_mlt_step(scene, opts, b, lsp, length_dist=ld)
        cache_mod.reset_launch_counts()
        want = banked0
        for _ in range(steps):
            want = step(gen, want, torch.zeros(shape, device=dev), init)
        torch.cuda.synchronize()
        eager = dict(cache_mod.launch_counts)
        gen.set_state(state0)
        multi = mlt.make_mlt_multi_step(scene, opts, b, lsp, steps,
                                        length_dist=ld)
        cache_mod.reset_launch_counts()
        got, _, n_done = multi(gen, banked0, torch.zeros(shape, device=dev),
                               init)
        torch.cuda.synchronize()
    assert int(n_done) == steps
    assert eager == cache_mod.launch_counts == {'query': 2 * steps}
    for a, c in zip(tree_leaves(want.state), tree_leaves(got.state)):
        assert torch.equal(a, c)
