// Radius-kNN moments of MALA's cache phase for Hopper (sm_90a): for each
// query lane, the k = pss_knn live entries of its dimension row of the
// global cache nearest to its PSS point, and the weighted mean of their
// v1 and v2 rows over those within the query radius.
//
// It replaces no Pallas kernel: the JAX package's query_knn
// (langevin_mcmc_tpu/mcmc/cache.py) is XLA ops (a dense distance matrix,
// top_k and a gather). The port ran the same as torch ops, 256 entries at
// a time: a [lanes, 256, Dm] gather written to device memory and read
// back by four elementwise and reduce passes, then a concatenation, a
// top-k and a gather, twelve times a query. Its contract is the plain
// version knn_reference (langevin_mcmc_tpu_torch/mcmc/cache.py), which
// it equals bit for bit (built with --fmad=false):
//  * a lane's row is clamp(dims, 0, ndim - 1); its distance to an entry
//    is (q_j - e_j)^2 summed over the coordinates j < min(dims, Dm) in
//    ascending order, starting from 0; only entries below the row's count
//    are live;
//  * the best are ordered by distance, then by entry index (the lower
//    index wins a tie);
//  * an entry is in range when its distance is <= dims * r2; its weight
//    is 1 / (d^2 + 1e-6); the weights and the weighted rows are summed
//    over the best in that order, each product rounded before its add,
//    and the sums divided by max(sum of weights, 1e-30); found is
//    whether any of the best is in range.
//
// What bounds it: f32 operations, 3 a coordinate of every (lane, live
// entry) pair: at most 16,384 lanes x 3,000 entries x 16 coordinates x 3
// = 2.4 GFLOP, 0.035 ms at 67 TFLOP/s, at the flagship's shapes. Its
// bytes are few (the whole store is 13 rows x 3,000 x 16 x 4 B = 2.5 MB,
// and lives in L2). So the design keeps every intermediate on the SM and
// spends its instructions on the distances:
//  * the wrapper orders the lanes by dims, descending (a lane's row and
//    the coordinates it sums both grow with dims), so a block's lanes
//    mostly share one row and a warp's one count, and the blocks that take
//    longest start first; the kernel reads the lanes through that order
//    and writes each result at the lane's own index. A block whose lanes
//    span rows walks each of those rows for its own lanes;
//  * 32 lanes a block, one a thread of each of its eight warps: warp w
//    takes every eighth entry of each tile from w on, so the 32 threads of
//    a warp read one entry at a time (a broadcast from shared memory) and
//    each keeps its lane's query in registers;
//  * a thread sums the distances of 8 entries at once, 8 running sums in
//    registers, so one entry's adds wait on nothing but each other; the
//    coordinates go 4 at a time, one 16-byte load of each entry a group,
//    up to the lane's own count;
//  * only an entry in range can reach the moments, and the in-range
//    entries of the k best are the k best in range: so an entry enters a
//    thread's list of (distance, index) in registers only when in range
//    and below its k-th, and most entries cost two compares. The eight
//    lists of a lane are merged through shared memory, and the warps then
//    split the output coordinates;
//  * the block streams the row's live entries through shared memory in
//    tiles, two buffers filled by cp.async (tile t + 1 in flight while
//    tile t is read).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "blocklist.cuh"

namespace {

constexpr int kThreads = 256;              // threads a block
constexpr int kWarps = kThreads / 32;      // threads a lane, one a warp
constexpr int kLanes = 32;                 // lanes a block
constexpr int kMaxK = 8;                   // best entries a lane keeps
constexpr int kMaxDim = 32;                // coordinates of an entry
constexpr int kGroups = kMaxDim / 4;       // of four coordinates
constexpr int kBatch = 8;                  // entries a thread sums at once
constexpr int kTileFloats = 3072;          // floats of one tile buffer
constexpr int kNoEntry = 0x7fffffff;       // the index of an empty slot

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// (da, ia) comes before (db, ib): by distance, then by entry index
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Insert (d, i) into the sorted first k slots of (bd, bi); the caller
// inserts only what comes before the k-th. Slots past the k-th hold
// whatever the shifts leave there.
__device__ __forceinline__ void insert(float (&bd)[kMaxK], int (&bi)[kMaxK],
                                       float d, int i) {
#pragma unroll
  for (int s = kMaxK - 1; s >= 0; --s) {
    if (s > 0 && before(d, i, bd[s - 1], bi[s - 1])) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (before(d, i, bd[s], bi[s])) {
      bd[s] = d;
      bi[s] = i;
    }
  }
}

// the k-th slot (k - 1 held in registers: no dynamic index)
__device__ __forceinline__ void kth(const float (&bd)[kMaxK],
                                    const int (&bi)[kMaxK], int k, float& d,
                                    int& i) {
  d = bd[0];
  i = bi[0];
#pragma unroll
  for (int s = 1; s < kMaxK; ++s) {
    if (s == k - 1) {
      d = bd[s];
      i = bi[s];
    }
  }
}

// Entries [first, first + ne) of the row at src into dst, entry e at
// dst + (e - first) * ds; one cp.async group a thread.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int first, int ne, int dm, int ds,
                                          bool vec) {
  const float* from = src + static_cast<size_t>(first) * dm;
  if (vec) {
    const int per = dm / 4;  // 16-byte pieces an entry
    for (int c = threadIdx.x; c < ne * per; c += kThreads) {
      const int e = c / per;
      cp_async16(dst + e * ds + 4 * (c - e * per), from + 4 * c);
    }
  } else {
    for (int c = threadIdx.x; c < ne * dm; c += kThreads) {
      const int e = c / dm;
      cp_async4(dst + e * ds + (c - e * dm), from + c);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ void add_sq(float& acc, float q, float x) {
  const float y = q - x;
  acc += y * y;
}

// The lane's distances to kBatch entries of the tile in buf at once (its
// entries e0 + kWarps * b), the coordinates j < nd in ascending order.
__device__ __forceinline__ void distances(const float* buf,
                                          const float4 (&q)[kGroups], int e0,
                                          int ds, int nd,
                                          float (&acc)[kBatch]) {
#pragma unroll
  for (int b = 0; b < kBatch; ++b) acc[b] = 0.f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (4 * g + 4 <= nd) {
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const float4 x = *reinterpret_cast<const float4*>(
            buf + (e0 + kWarps * b) * ds + 4 * g);
        add_sq(acc[b], q[g].x, x.x);
        add_sq(acc[b], q[g].y, x.y);
        add_sq(acc[b], q[g].z, x.z);
        add_sq(acc[b], q[g].w, x.w);
      }
    } else if (4 * g < nd) {  // the last, partial group
      const int rem = nd - 4 * g;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const float4 x = *reinterpret_cast<const float4*>(
            buf + (e0 + kWarps * b) * ds + 4 * g);
        add_sq(acc[b], q[g].x, x.x);
        if (rem > 1) add_sq(acc[b], q[g].y, x.y);
        if (rem > 2) add_sq(acc[b], q[g].z, x.z);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) knn_kernel(
    const float* __restrict__ cache_pss, const float* __restrict__ cache_v1,
    const float* __restrict__ cache_v2, const int* __restrict__ count,
    int ndim, int size, int dm, int ds, bool vec,
    const int* __restrict__ dims, const float* __restrict__ pss,
    const long long* __restrict__ order, int n, int k, float r2,
    bool* __restrict__ found, float* __restrict__ v1,
    float* __restrict__ v2) {
  __shared__ __align__(16) float s_tile[2][kTileFloats];
  __shared__ float s_bd[kWarps][kMaxK][kLanes];
  __shared__ int s_bi[kWarps][kMaxK][kLanes];
  __shared__ int s_lo, s_hi;
  const int w = threadIdx.x / 32;  // the lane's share of the entries
  const int l = threadIdx.x % 32;
  const int pos = blockIdx.x * kLanes + l;
  const bool active = pos < n;
  const int lane = active ? static_cast<int>(order[pos]) : 0;
  const int dim = active ? dims[lane] : 0;
  const int row = active ? min(max(dim, 0), ndim - 1) : -1;
  const int nd = min(max(dim, 0), dm);
  const float radius = static_cast<float>(dim) * r2;
  float4 q[kGroups];
  const float* ql = pss + static_cast<size_t>(lane) * dm;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    q[g].x = 4 * g < nd ? ql[4 * g] : 0.f;
    q[g].y = 4 * g + 1 < nd ? ql[4 * g + 1] : 0.f;
    q[g].z = 4 * g + 2 < nd ? ql[4 * g + 2] : 0.f;
    q[g].w = 4 * g + 3 < nd ? ql[4 * g + 3] : 0.f;
  }
  if (threadIdx.x == 0) {
    s_lo = ndim;
    s_hi = -1;
  }
  __syncthreads();
  if (active && w == 0) {
    atomicMin(&s_lo, row);
    atomicMax(&s_hi, row);
  }
  __syncthreads();
  const int lo = s_lo, hi = s_hi;

  float bd[kMaxK];
  int bi[kMaxK];
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = kNoEntry;
  }
  float worst = CUDART_INF_F;  // the k-th distance
  // entries a tile: a whole number of batches of the warps
  const int per_tile =
      kTileFloats / ds / (kWarps * kBatch) * (kWarps * kBatch);

  for (int r = lo; r <= hi; ++r) {
    if (!__syncthreads_or(row == r)) continue;
    const int live = min(max(count[r], 0), size);
    const int tiles = (live + per_tile - 1) / per_tile;
    const float* src = cache_pss + static_cast<size_t>(r) * size * dm;
    if (tiles > 0) {
      load_tile(s_tile[0], src, 0, min(per_tile, live), dm, ds, vec);
    }
    for (int t = 0; t < tiles; ++t) {
      const int first = t * per_tile;
      if (t + 1 < tiles) {
        const int next = first + per_tile;
        load_tile(s_tile[(t + 1) & 1], src, next,
                  min(per_tile, live - next), dm, ds, vec);
        cp_async_wait<1>();  // my copies of tile t
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (row == r) {
        const float* buf = s_tile[t & 1];
        const int ne = min(per_tile, live - first);
        for (int e0 = w; e0 < ne; e0 += kWarps * kBatch) {
          float acc[kBatch];
          distances(buf, q, e0, ds, nd, acc);
          // this thread's entries come in ascending index, so an equal
          // distance never comes before a slot it already holds
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            if (e0 + kWarps * b < ne && acc[b] <= radius &&
                acc[b] < worst) {
              insert(bd, bi, acc[b], first + e0 + kWarps * b);
              int wi;
              kth(bd, bi, k, worst, wi);
            }
          }
        }
      }
      __syncthreads();  // before tile t + 2 overwrites this buffer
    }
  }

  // merge the lane's lists: each of its threads ends with the same
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    s_bd[w][s][l] = bd[s];
    s_bi[w][s][l] = bi[s];
  }
  __syncthreads();
  for (int o = 1; o < kWarps; ++o) {
    const int other = (w + o) % kWarps;
#pragma unroll
    for (int s = 0; s < kMaxK; ++s) {
      const float d = s_bd[other][s][l];
      const int i = s_bi[other][s][l];
      float wd;
      int wi;
      kth(bd, bi, k, wd, wi);
      if (s < k && before(d, i, wd, wi)) insert(bd, bi, d, i);
    }
  }
  if (!active) return;

  float wt[kMaxK];
  float wsum = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    const bool in = s < k && bd[s] <= radius;
    wt[s] = in ? 1.f / (bd[s] * bd[s] + 1e-6f) : 0.f;
    if (in) wsum += wt[s];
  }
  const float den = fmaxf(wsum, 1e-30f);
  const size_t base = static_cast<size_t>(row) * size;
  for (int j = w; j < dm; j += kWarps) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxK; ++s) {
      if (s < k && bd[s] <= radius) {
        const size_t e = (base + bi[s]) * dm + j;
        a1 += wt[s] * cache_v1[e];
        a2 += wt[s] * cache_v2[e];
      }
    }
    v1[static_cast<size_t>(lane) * dm + j] = a1 / den;
    v2[static_cast<size_t>(lane) * dm + j] = a2 / den;
  }
  if (w == 0) found[lane] = bd[0] <= radius;
}

}  // namespace

// cache_pss, cache_v1, cache_v2: [ndim, size, dm] f32; count: [ndim]
// int32; dims: [n] int32; pss: [n, dm] f32; order: [n] int64, the lanes
// in the order the blocks take them; r2: pss_query_dist^2;
// found: [n] bool; v1, v2: [n, dm] f32.
extern "C" int knn_query(const float* cache_pss, const float* cache_v1,
                         const float* cache_v2, const int* count, int ndim,
                         int size, int dm, const int* dims, const float* pss,
                         const long long* order, int n, int k, float r2,
                         bool* found, float* v1, float* v2, void* stream) {
  if (ndim < 1 || size < 1 || dm < 1 || dm > kMaxDim || k < 1 ||
      k > kMaxK || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int ds = (dm + 3) & ~3;  // an entry's stride in shared memory
  const bool vec =
      dm % 4 == 0 && reinterpret_cast<uintptr_t>(cache_pss) % 16 == 0;
  const unsigned grid = static_cast<unsigned>((n + kLanes - 1) / kLanes);
  knn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cache_pss, cache_v1, cache_v2, count, ndim, size, dm, ds, vec, dims,
      pss, order, n, k, r2, found, v1, v2);
  return static_cast<int>(cudaGetLastError());
}
