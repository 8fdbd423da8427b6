"""Global PSS cache: per-dimension moment store with radius-kNN
interpolation, and the path store the cache-seeded large steps sample from
(port of mcmc/cache.py).

Storage is a dense [NDIM, SIZE, Dm] store of (pss, v1, v2) plus path
weights and (s, t) tags, one row per PSS dimension; with cache sampling on,
also the whole path records, [NDIM, SIZE, ...] per record field. Each MLT
step's pushes are scattered into their dimension rows at count + rank.

* query_knn: brute-force radius-kNN over the lane's dimension row
  (k = pss_knn, radius^2 = dim * pss_query_dist^2) with weights
  1 / (d_sq^2 + 1e-6). Distances are computed subtract-then-square,
  exactly; the JAX package uses the f32 expansion |q|^2 - 2 q.e + |e|^2,
  which differs for near-coincident entries. On CUDA tensors it is the
  kernel csrc/knn.cu (knn_kernel), on CPU tensors its plain version
  knn_reference, bit for bit the same.
* eval_pdf_cache: the torus-wrapped Gaussian KDE pdf over the row's
  same-(s, t) entries, each kernel weighted by its path weight over the
  row's weight sum.
* sample_cache: a stored entry drawn by the path-weight CDF.
"""

import dataclasses
import math

import torch

from ..ops import cuda_build
from ..ops.tracing import launch_counter
from ..utils.tree import tree_map

# the kNN kernel's launches (csrc/knn.cu); a captured step counts them at
# every replay
launch_counts = launch_counter(('query',), 'mcmc.cache')
# the kernel's compile-time bounds: the best entries a lane keeps and the
# coordinates of an entry
KNN_MAX_K = 8
KNN_MAX_DIM = 32


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass
class GlobalCache:
    pss: torch.Tensor        # [NDIM, SIZE, Dm]
    v1: torch.Tensor         # [NDIM, SIZE, Dm]
    v2: torch.Tensor         # [NDIM, SIZE, Dm]
    weight: torch.Tensor     # [NDIM, SIZE] pathWeight
    s_tag: torch.Tensor      # [NDIM, SIZE] int32
    t_tag: torch.Tensor      # [NDIM, SIZE] int32
    count: torch.Tensor      # [NDIM] int32
    score_sum: torch.Tensor  # [NDIM]
    rec: object = None       # PathRecord [NDIM, SIZE, ...] | None

    @property
    def size(self):
        return self.pss.shape[1]


def make_cache(opts, max_dim, device, rec_proto=None):
    """rec_proto: a PathRecord of [C, ...] fields whose per-lane shapes and
    dtypes the path store takes; None keeps no paths."""
    ndim = opts.pss_max_length + 1          # rows indexed by dim directly
    size = opts.pss_max_size
    z = lambda: torch.zeros((ndim, size, max_dim), device=device)
    zi = lambda: torch.zeros((ndim, size), dtype=torch.int32, device=device)
    rec = None
    if rec_proto is not None:
        rec = tree_map(lambda a: torch.zeros((ndim, size) + a.shape[1:],
                                             dtype=a.dtype, device=device),
                       rec_proto)
    return GlobalCache(pss=z(), v1=z(), v2=z(),
                       weight=torch.zeros((ndim, size), device=device),
                       s_tag=zi(), t_tag=zi(),
                       count=torch.zeros(ndim, dtype=torch.int32,
                                         device=device),
                       score_sum=torch.zeros(ndim, device=device), rec=rec)


def push_batch(cache: GlobalCache, dims, pss, v1, v2, weight, mask, opts,
               s_tag=None, t_tag=None, rec=None):
    """Scatter a batch of chain entries into their dimension rows.
    dims [C] int; pss/v1/v2 [C, Dm]; weight [C]; mask [C] bool; rec: the
    lanes' PathRecord, stored when the cache keeps paths. Lanes of one
    dimension take consecutive slots in lane order. Returns a new
    cache."""
    ndim, size = cache.weight.shape
    C = dims.shape[0]
    dev = dims.device
    d = torch.clamp(dims, 0, ndim - 1).long()
    ok = (mask & (dims >= opts.pss_min_length) & (dims <= opts.pss_max_length)
          & (weight > 1e-10) & (cache.count[d] < size))
    # rank of each lane among this step's same-dim lanes (stable sort)
    okd = torch.where(ok, d, torch.full_like(d, ndim))
    order = torch.argsort(okd, stable=True)
    ds = okd[order]
    pos = torch.arange(C, device=dev)
    is_start = torch.ones(C, dtype=torch.bool, device=dev)
    is_start[1:] = ds[1:] != ds[:-1]
    seg_start = torch.cummax(torch.where(is_start, pos, torch.zeros_like(pos)),
                             0).values
    rank = torch.empty(C, dtype=torch.long, device=dev)
    rank[order] = pos - seg_start
    slot = cache.count[d].long() + rank
    ok = ok & (slot < size)
    # every lane scatters: the lanes that push none write one spare row
    # past the end (static shapes, no host read)
    flat_idx = torch.where(ok, d * size + slot,
                           torch.full_like(slot, ndim * size))

    def scat(buf, val):
        flat = torch.cat([buf.reshape((ndim * size,) + buf.shape[2:]),
                          buf.new_zeros((1,) + buf.shape[2:])])
        flat[flat_idx] = val.to(buf.dtype)
        return flat[:-1].reshape(buf.shape)

    zero_i = torch.zeros(C, dtype=torch.int32, device=dev)
    add = torch.zeros(ndim, dtype=torch.int32, device=dev).index_add_(
        0, d, ok.to(torch.int32))
    add_w = torch.zeros(ndim, device=dev).index_add_(
        0, d, torch.where(ok, weight, torch.zeros_like(weight)))
    new_rec = cache.rec
    if cache.rec is not None and rec is not None:
        new_rec = tree_map(scat, cache.rec, rec)
    return GlobalCache(
        pss=scat(cache.pss, pss), v1=scat(cache.v1, v1),
        v2=scat(cache.v2, v2), weight=scat(cache.weight, weight),
        s_tag=scat(cache.s_tag, zero_i if s_tag is None else s_tag),
        t_tag=scat(cache.t_tag, zero_i if t_tag is None else t_tag),
        count=torch.clamp(cache.count + add, max=size),
        score_sum=cache.score_sum + add_w, rec=new_rec)


def query_knn(cache: GlobalCache, dims, pss, opts):
    """Radius-kNN moment interpolation over each lane's dimension row: the
    k = pss_knn live entries nearest to pss (by distance, then entry
    index), weighted 1 / (d_sq^2 + 1e-6) where d_sq <= dims *
    pss_query_dist^2. The kernel (knn_kernel) on CUDA tensors, its plain
    version (knn_reference) on CPU tensors. Returns (found [C] bool,
    v1 [C, Dm], v2 [C, Dm])."""
    if pss.device.type == 'cuda':
        return knn_kernel(cache, dims, pss, opts)
    return knn_reference(cache, dims, pss, opts)


def knn_reference(cache: GlobalCache, dims, pss, opts, chunk=256):
    """query_knn in torch, by the kernel's rules: a lane's row is
    clamp(dims, 0, NDIM - 1) and its live entries those below the row's
    count; a distance is (q_j - e_j)^2 summed over the coordinates j <
    dims in ascending order; the k best are ordered by distance, then by
    entry index (a stable sort of the running best, whose indices are
    lower, ahead of each chunk of the row in index order); the weights and
    the weighted v1/v2 rows are summed over the best in that order, a
    product rounded before each add. Returns (found [C] bool, v1 [C, Dm],
    v2 [C, Dm])."""
    ndim, size = cache.weight.shape
    C, Dm = pss.shape
    dev = pss.device
    k = opts.pss_knn
    d = torch.clamp(dims, 0, ndim - 1).long()
    dim_mask = (torch.arange(Dm, device=dev)[None, :] < dims[:, None]
                ).to(pss.dtype)
    q = pss * dim_mask
    best_d = torch.full((C, k), float('inf'), device=dev)
    best_i = torch.zeros((C, k), dtype=torch.long, device=dev)
    live_n = cache.count[d].long()
    for s in range(0, size, chunk):
        idx = torch.arange(s, min(s + chunk, size), device=dev)
        diff = q[:, None, :] - cache.pss[d[:, None], idx[None, :]] \
            * dim_mask[:, None, :]
        dist = torch.zeros(diff.shape[:2], device=dev)
        for j in range(Dm):
            dist = dist + torch.square(diff[..., j])
        dist = torch.where(idx[None, :] < live_n[:, None], dist,
                           torch.full_like(dist, float('inf')))
        all_d, sel = torch.sort(torch.cat([best_d, dist], 1), dim=1,
                                stable=True)
        all_i = torch.cat([best_i, torch.broadcast_to(idx[None], dist.shape)],
                          1)
        best_d = all_d[:, :k]
        best_i = torch.gather(all_i, 1, sel[:, :k])
    radius_sq = dims.to(torch.float32) * opts.pss_query_dist ** 2
    in_r = best_d <= radius_sq[:, None]
    w = torch.where(in_r, 1.0 / (torch.square(best_d) + 1e-6),
                    torch.zeros_like(best_d))
    wsum = torch.zeros(C, device=dev)
    v1 = torch.zeros((C, Dm), device=dev)
    v2 = torch.zeros((C, Dm), device=dev)
    for j in range(k):
        wsum = wsum + w[:, j]
        on = in_r[:, j, None]
        v1 = v1 + torch.where(on, w[:, j, None] * cache.v1[d, best_i[:, j]],
                              torch.zeros_like(v1))
        v2 = v2 + torch.where(on, w[:, j, None] * cache.v2[d, best_i[:, j]],
                              torch.zeros_like(v2))
    wsum = torch.clamp(wsum, min=1e-30)
    return in_r.any(1), v1 / wsum[:, None], v2 / wsum[:, None]


def knn_kernel(cache: GlobalCache, dims, pss, opts):
    """query_knn by the kernel csrc/knn.cu on CUDA tensors: the lanes
    ordered by dims, descending (an argsort), so a block's lanes share its
    row; one launch counted, no host read. Raises on k or Dm past the kernel's
    bounds (KNN_MAX_K, KNN_MAX_DIM), on inputs it does not take and on a
    failed launch."""
    ndim, size = cache.weight.shape
    C, Dm = pss.shape
    k = opts.pss_knn
    if not 1 <= k <= KNN_MAX_K:
        raise ValueError(f'pss_knn {k}: the kNN kernel keeps 1 to '
                         f'{KNN_MAX_K} entries a lane')
    if not 1 <= Dm <= KNN_MAX_DIM:
        raise ValueError(f'{Dm} coordinates: the kNN kernel takes 1 to '
                         f'{KNN_MAX_DIM}')
    dev = pss.device
    check = cuda_build.check
    for x, name in ((cache.pss, 'cache.pss'), (cache.v1, 'cache.v1'),
                    (cache.v2, 'cache.v2')):
        check(x, name, torch.float32, (ndim, size, Dm), dev)
    check(cache.count, 'cache.count', torch.int32, (ndim,), dev)
    dims = dims.to(torch.int32).contiguous()
    pss = pss.contiguous()
    check(dims, 'dims', torch.int32, (C,), dev)
    check(pss, 'pss', torch.float32, (C, Dm), dev)
    found = torch.empty(C, dtype=torch.bool, device=dev)
    v1 = torch.empty((C, Dm), device=dev)
    v2 = torch.empty((C, Dm), device=dev)
    if C == 0:
        return found, v1, v2
    # a lane's row and its coordinates' count both grow with dims: the
    # lanes by row, the most work first
    order = torch.argsort(dims, descending=True)
    ptr = lambda x: x.data_ptr()
    err = cuda_build.load_library().knn_query(
        *map(ptr, (cache.pss, cache.v1, cache.v2, cache.count)), ndim, size,
        Dm, *map(ptr, (dims, pss, order)), C, k,
        opts.pss_query_dist ** 2, *map(ptr, (found, v1, v2)),
        cuda_build.stream_of(dev))
    cuda_build.raise_on_error(err, 'knn_query')
    launch_counts['query'] += 1
    return found, v1, v2


def eval_pdf_cache(cache: GlobalCache, dims, pss, s, t, opts, chunk=256):
    """Torus-wrapped Gaussian KDE pdf of pss [C, Dm] over the same-(s, t)
    entries of each lane's dimension row: sum_i w_i N_wrap(pss; e_i,
    cache_sig^2 I) / score_sum, in the first dims coordinates. The row is
    walked in chunks so the [C, chunk, Dm] temporaries stay small.
    Returns [C]."""
    ndim, size = cache.weight.shape
    C, Dm = pss.shape
    dev = pss.device
    d = torch.clamp(dims, 0, ndim - 1).long()
    sig = opts.cache_sig
    dim_mask = torch.arange(Dm, device=dev)[None, :] < dims[:, None]
    log_norm_1d = -0.5 * math.log(2.0 * math.pi) - math.log(sig)
    live_n = cache.count[d]
    acc = torch.zeros(C, device=dev)
    for lo in range(0, size, chunk):
        idx = torch.arange(lo, min(lo + chunk, size), device=dev)
        e = cache.pss[d[:, None], idx[None, :]]              # [C, n, Dm]
        diff = torch.abs(e - pss[:, None, :])
        diff = torch.minimum(diff, 1.0 - diff)               # torus wrap
        log_k = -0.5 * torch.square(diff / sig) + log_norm_1d
        log_k = torch.where(dim_mask[:, None, :], log_k,
                            torch.zeros_like(log_k))
        kern = torch.exp(torch.sum(log_k, -1))               # [C, n]
        valid = ((idx[None, :] < live_n[:, None])
                 & (cache.s_tag[d[:, None], idx[None, :]] == s[:, None])
                 & (cache.t_tag[d[:, None], idx[None, :]] == t[:, None]))
        w = cache.weight[d[:, None], idx[None, :]]
        acc = acc + torch.sum(torch.where(valid, kern * w,
                                          torch.zeros_like(kern)), 1)
    return acc / torch.clamp(cache.score_sum[d], min=1e-30)


def sample_cache(cache: GlobalCache, dims, u):
    """Draw a stored entry of each lane's dimension row by the path-weight
    CDF at the uniform u [C]. Returns (idx [C], pss [C, Dm], weight [C],
    PathRecord of the entries or None)."""
    ndim, size = cache.weight.shape
    dev = u.device
    d = torch.clamp(dims, 0, ndim - 1).long()
    w = cache.weight[d]                                      # [C, SIZE]
    valid = torch.arange(size, device=dev)[None, :] < cache.count[d][:, None]
    w = torch.where(valid, w, torch.zeros_like(w))
    cdf = torch.cumsum(w, 1)
    x = u[:, None] * cdf[:, -1:]
    idx = torch.clamp(torch.sum((cdf <= x).to(torch.int64), 1), 0, size - 1)
    rec = None
    if cache.rec is not None:
        rec = tree_map(lambda a: a[d, idx], cache.rec)
    return idx, cache.pss[d, idx], cache.weight[d, idx], rec
