// Chunk-walk ray/triangle intersection for Hopper (sm_90a).
//
// Two forms, each with a closest-hit (any_hit=False, intersect_chunkwalk)
// and an any-hit (any_hit=True, occluded_chunkwalk) variant:
//  * staged_kernel replaces the Pallas TPU kernel _walk_kernel
//    (langevin_mcmc_tpu/ops/chunkwalk.py:157, chunks fetched from HBM one
//    by one) together with the torch stage that fed it its per-block chunk
//    lists (_block_chunk_lists). Its contract is _block_chunk_lists
//    followed by walk_reference (langevin_mcmc_tpu_torch/ops/chunkwalk.py).
//  * resident_kernel replaces _walk_kernel_resident (chunkwalk.py:280, the
//    whole pack held in fast memory). It walks the lists that the torch
//    stage builds; its contract is walk_reference.
// Both compute the same function: rays in 256-ray blocks, each block
// testing its rays against the 128-triangle chunks whose AABB one of them
// crosses. Every ray is projected into each triangle frame:
//   t = -Ow / Qw,  u = Ou + t Qu,  v = Ov + t Qv,
// a hit needing |Qw| >= 1e-12, u, v >= 0, u + v <= 1, t in [min_t, max_t]
// and a valid triangle. Within a chunk the smallest t wins and ties go to
// the smallest id; across chunks a later chunk must be strictly closer.
//
// What bounds the staged walk on this card, and what the design does:
//  * Instruction rate. A test is 40 f32 operations that no FMA may fuse
//    (the result must round as torch does) plus an IEEE division and the
//    compares: about 60 instructions a test, on operands every ray of a
//    block shares. Bytes do not bound it: a chunk's 7 KB (13 rows and the
//    ids) is read once per CTA, from L2. Each thread owns one ray and
//    reads 4 triangles' rows at once as float4 broadcasts from shared
//    memory (13 loads feed 4 tests); the loop has no branch per triangle
//    or per ray (a dead ray or an invalid triangle fails the test anyway).
//    More rays a thread, and skipping the division where the test must
//    fail (min_t > 0 and t's sign bit set), measured slower on the card
//    (PERF.md has the table): they add registers or divergence, not fewer
//    instructions.
//  * Filling 132 SMs. A grid of one CTA per ray block (256 CTAs at 65,536
//    rays, 17 at a 4,261-ray large step) leaves most of the card idle and
//    ends with the block of the longest list. Here each block's chunk ids
//    are cut into `splits` contiguous ranges and one CTA walks one (block,
//    range); the wrapper sizes splits from the number of blocks. Closest
//    hit writes a partial (t, id, u, v) per range and merge_kernel takes
//    the ranges in ascending order with a strict <, which is the
//    across-chunk rule since the ranges are in ascending chunk order. Any
//    hit ORs straight into the zeroed output, and a range also reads the
//    flags other ranges set, so it stops once all of its rays are occluded
//    by any range; a warp whose rays are all done leaves the chunk.
//  * Staging. Chunks arrive through a ring of two shared-memory buffers
//    filled by cp.async: chunk j + 1 is in flight while chunk j is
//    tested, with one barrier per chunk. Every copy is waited
//    for before its buffer is reused and before the CTA exits, the
//    any-hit early exit included (leaving a prefetch in flight was a fault
//    of the TPU kernel). With three CTAs resident on an SM the others
//    run while one waits, so one stage measures the same.
//  * The chunk lists. The CTA slab-tests its 256 rays against the AABBs
//    of its range with the f32 operations of _block_chunk_lists in its
//    order (NaN propagating as torch.minimum / amax do), ORs per chunk by
//    warp ballot into a shared bit mask, and compacts the set bits into an
//    ascending list: no [R, K, 3] temporaries, argsort or list tensors.
//
// resident_kernel, one CTA of 256 threads per ray block, thread i owning
// ray i, reads rows straight from global memory: a pack of a few MB (1.58
// MB on the 24,588-triangle flagship scene) stays in the 50 MB L2 and a
// warp's threads read one address, a broadcast. Any hit leaves per warp
// (__all_sync).
//
// Rounding. Built with --fmad=false, every product and sum is rounded on
// its own, in the same order as the torch version, so the two agree
// exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRayBlock = 256;
constexpr int kTriChunk = 128;
constexpr int kPackRows = 16;   // rows of a chunk in the pack
constexpr int kRows = 13;       // rows a test reads: frame 0-8, 9-11, valid 12
constexpr int kMaxRange = 1024; // chunks in one range at most
constexpr int kStages = 2;      // shared-memory chunk buffers of the ring
constexpr float kBig = 3.0e38f;

// ---------------------------------------------------------------------------
// staged form
// ---------------------------------------------------------------------------

struct Stage {
  float4 rows[kRows * kTriChunk / 4];  // row m of triangles 4g..4g+3: [m*32+g]
  int4 ids[kTriChunk / 4];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of chunk cid's rows 0-12 and ids (448 x 16 bytes).
__device__ __forceinline__ void stage_chunk(Stage& st, const float* pack,
                                            const int* ids, int cid,
                                            int tid) {
  constexpr int kRowVecs = kRows * kTriChunk / 4;
  constexpr int kVecs = kRowVecs + kTriChunk / 4;
  const float4* rows = reinterpret_cast<const float4*>(
      pack + static_cast<int64_t>(cid) * kPackRows * kTriChunk);
  const int4* tri_ids =
      reinterpret_cast<const int4*>(ids + static_cast<int64_t>(cid) * kTriChunk);
  for (int e = tid; e < kVecs; e += kRayBlock) {
    if (e < kRowVecs) {
      cp_async16(&st.rows[e], rows + e);
    } else {
      cp_async16(&st.ids[e - kRowVecs], tri_ids + (e - kRowVecs));
    }
  }
}

// torch.minimum / torch.maximum / amax / amin return NaN when an operand
// is NaN; fminf / fmaxf would return the other operand.
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float safe_dir(float d) {
  return fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
}

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// Closest hit writes (t, id, u, v) of its range to out_* [splits, rays];
// any hit ORs into out_occ. chunk_mask is a test hook: null on every
// render path, else [blocks, num_chunks] bytes that receive the block's
// chunk hit set, so the card tests can hold it against the torch lists.
template <bool AnyHit>
__global__ void __launch_bounds__(kRayBlock)
staged_kernel(const float* __restrict__ pack, const int* __restrict__ ids,
              const float* __restrict__ chunk_lo,
              const float* __restrict__ chunk_hi,
              const float* __restrict__ org, const float* __restrict__ dir,
              const float* __restrict__ rng, int num_chunks, int splits,
              int64_t num_rays, float* __restrict__ out_t,
              int* __restrict__ out_id, float* __restrict__ out_u,
              float* __restrict__ out_v, unsigned char* out_occ,
              unsigned char* __restrict__ chunk_mask) {
  __shared__ Stage s_stage[kStages];
  __shared__ int s_list[kMaxRange];
  __shared__ unsigned s_mask[kMaxRange / 32];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / splits;
  const int s = blockIdx.x % splits;
  const int c0 = static_cast<int>(static_cast<int64_t>(s) * num_chunks / splits);
  const int c1 =
      static_cast<int>(static_cast<int64_t>(s + 1) * num_chunks / splits);
  const int len = c1 - c0;
  const int words = (len + 31) / 32;

  const int64_t r = static_cast<int64_t>(b) * kRayBlock + tid;
  const float ox = org[3 * r + 0], oy = org[3 * r + 1], oz = org[3 * r + 2];
  const float dx = dir[3 * r + 0], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
  const float mn = rng[2 * r + 0], mx = rng[2 * r + 1];
  // dead rays (not max_t >= min_t) fail every test; any hit counts them
  // as done
  const bool alive = mx >= mn;

  // 1. this range's part of the block's chunk list
  for (int w = tid; w < words; w += kRayBlock) s_mask[w] = 0u;
  __syncthreads();
  {
    const float ix = 1.0f / safe_dir(dx);
    const float iy = 1.0f / safe_dir(dy);
    const float iz = 1.0f / safe_dir(dz);
    for (int c = c0; c < c1; ++c) {
      const float lx = __ldg(chunk_lo + 3 * c + 0);
      const float ly = __ldg(chunk_lo + 3 * c + 1);
      const float lz = __ldg(chunk_lo + 3 * c + 2);
      const float hx = __ldg(chunk_hi + 3 * c + 0);
      const float hy = __ldg(chunk_hi + 3 * c + 1);
      const float hz = __ldg(chunk_hi + 3 * c + 2);
      const float t0x = (lx - ox) * ix, t1x = (hx - ox) * ix;
      const float t0y = (ly - oy) * iy, t1y = (hy - oy) * iy;
      const float t0z = (lz - oz) * iz, t1z = (hz - oz) * iz;
      const float tn = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                               nan_min(t0z, t1z));
      const float tf = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                               nan_max(t0z, t1z));
      const bool hit = tn <= tf && tf >= mn && tn <= mx && alive;
      if (__ballot_sync(0xffffffffu, hit) != 0u && (tid & 31) == 0) {
        atomicOr(&s_mask[(c - c0) >> 5], 1u << ((c - c0) & 31));
      }
    }
  }
  __syncthreads();
  int n = 0;
  for (int w = 0; w < words; ++w) n += __popc(s_mask[w]);
  for (int k = tid; k < len; k += kRayBlock) {
    const unsigned word = s_mask[k >> 5];
    const bool hit = (word >> (k & 31)) & 1u;
    if (hit) {
      int pos = __popc(word & ((1u << (k & 31)) - 1u));
      for (int w = 0; w < (k >> 5); ++w) pos += __popc(s_mask[w]);
      s_list[pos] = c0 + k;
    }
    if (chunk_mask != nullptr) {
      chunk_mask[static_cast<int64_t>(b) * num_chunks + c0 + k] = hit;
    }
  }
  __syncthreads();

  // 2. the walk over the list, chunks staged through the ring
  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1, best_cid = -1;
  bool occ = false, stored = false, seen = false;

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < n) stage_chunk(s_stage[q], pack, ids, s_list[q], tid);
    cp_async_commit();
  }
  for (int j = 0; j < n; ++j) {
    cp_async_wait<kStages - 2>();  // my copies of chunk j
    if (AnyHit) {
      occ |= seen;
      stored |= seen;
      // every thread reaches this barrier: n is uniform in the CTA
      if (__syncthreads_and(occ || !alive)) break;
    } else {
      __syncthreads();
    }
    // into the buffer chunk j - 1 was read from, which every thread has
    // left (the barrier above)
    const int nxt = j + kStages - 1;
    if (nxt < n) {
      stage_chunk(s_stage[nxt % kStages], pack, ids, s_list[nxt], tid);
    }
    cp_async_commit();
    if (AnyHit) {
      // the flag another range set, read now and used at the next barrier
      seen = !occ && alive && __ldcg(out_occ + r) != 0;
    }
    const Stage& st = s_stage[j % kStages];
    const int* tri_ids = reinterpret_cast<const int*>(st.ids);
    const int cid = s_list[j];
#pragma unroll 1
    for (int g = 0; g < kTriChunk / 4; ++g) {
      // a warp whose rays are all done leaves the chunk
      if (AnyHit && __all_sync(0xffffffffu, occ || !alive)) break;
      float4 p[kRows];
#pragma unroll
      for (int m = 0; m < kRows; ++m) p[m] = st.rows[m * (kTriChunk / 4) + g];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // no test is skipped for a dead ray: t >= min_t && t <= max_t
        // fails for it anyway, and a branch would cost more
        const float w0 = lane(p[6], q), w1 = lane(p[7], q), w2 = lane(p[8], q);
        const float ow = ox * w0 + oy * w1 + oz * w2 - lane(p[11], q);
        const float qw = dx * w0 + dy * w1 + dz * w2;
        const bool tiny = fabsf(qw) < 1e-12f;
        const float ou = ox * lane(p[0], q) + oy * lane(p[1], q) +
                         oz * lane(p[2], q) - lane(p[9], q);
        const float qu =
            dx * lane(p[0], q) + dy * lane(p[1], q) + dz * lane(p[2], q);
        const float ov = ox * lane(p[3], q) + oy * lane(p[4], q) +
                         oz * lane(p[5], q) - lane(p[10], q);
        const float qv =
            dx * lane(p[3], q) + dy * lane(p[4], q) + dz * lane(p[5], q);
        // a tiny Qw fails whatever t is, so t needs no clamped divisor
        const float t = -ow / qw;
        const float u = ou + t * qu;
        const float v = ov + t * qv;
        const bool ok = !tiny && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                        t >= mn && t <= mx && lane(p[12], q) > 0.5f;
        if (!ok) continue;
        if (AnyHit) {
          occ = true;
        } else {
          // the least (t, chunk, id): a tie on t keeps an earlier chunk
          const int k = 4 * g + q;
          bool take = t < best_t;
          int id = 0;
          if (take) {
            id = tri_ids[k];
          } else if (t == best_t && cid == best_cid) {
            id = tri_ids[k];
            take = id < best_id;
          }
          if (take) {
            best_t = t;
            best_id = id;
            best_cid = cid;
            best_u = u;
            best_v = v;
          }
        }
      }
    }
    if (AnyHit && occ && !stored) {
      out_occ[r] = 1;
      stored = true;
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA, early exit included

  if (!AnyHit) {
    const int64_t k = static_cast<int64_t>(s) * num_rays + r;
    out_t[k] = best_t;
    out_id[k] = best_id;
    out_u[k] = best_u;
    out_v[k] = best_v;
  }
}

// Closest hit over the ranges' partials [splits, rays]: ascending range
// order, strict <.
__global__ void merge_kernel(const float* __restrict__ part_t,
                             const int* __restrict__ part_id,
                             const float* __restrict__ part_u,
                             const float* __restrict__ part_v, int splits,
                             int64_t num_rays, float* __restrict__ t,
                             int* __restrict__ id, float* __restrict__ u,
                             float* __restrict__ v) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= num_rays) return;
  float bt = part_t[r], bu = part_u[r], bv = part_v[r];
  int bi = part_id[r];
  for (int s = 1; s < splits; ++s) {
    const int64_t k = s * num_rays + r;
    const float ts = part_t[k];
    if (ts < bt) {
      bt = ts;
      bi = part_id[k];
      bu = part_u[k];
      bv = part_v[k];
    }
  }
  t[r] = bt;
  id[r] = bi;
  u[r] = bu;
  v[r] = bv;
}

// ---------------------------------------------------------------------------
// resident form
// ---------------------------------------------------------------------------

template <bool AnyHit>
__global__ void __launch_bounds__(kRayBlock)
resident_kernel(const float* __restrict__ pack, const int* __restrict__ ids,
                const int* __restrict__ chunk_idx,
                const int* __restrict__ counts, const float* __restrict__ org,
                const float* __restrict__ dir, const float* __restrict__ rng,
                int num_chunks, float* __restrict__ out_t,
                int* __restrict__ out_id, float* __restrict__ out_u,
                float* __restrict__ out_v, bool* __restrict__ out_occ) {
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int64_t r = static_cast<int64_t>(b) * kRayBlock + i;
  const float ox = org[3 * r + 0], oy = org[3 * r + 1], oz = org[3 * r + 2];
  const float dx = dir[3 * r + 0], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
  const float min_t = rng[2 * r + 0], max_t = rng[2 * r + 1];

  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  bool occluded = false;

  const int count = counts[b];
  const int* list = chunk_idx + static_cast<int64_t>(b) * num_chunks;
  for (int j = 0; j < count; ++j) {
    const int64_t cid = list[j];
    const float* rows = pack + cid * kPackRows * kTriChunk;
    const int* tri_ids = ids + cid * kTriChunk;

    float c_t = kBig, c_u = 0.0f, c_v = 0.0f;
    int c_id = 0x7fffffff;
    bool c_any = false;
    if (!(AnyHit && occluded)) {
      for (int k = 0; k < kTriChunk; ++k) {
        const float* p = rows + k;
        // row `row` of triangle k lives at p[row * kTriChunk]
        const float ou = ox * p[0 * kTriChunk] + oy * p[1 * kTriChunk] +
                         oz * p[2 * kTriChunk] - p[9 * kTriChunk];
        const float qu = dx * p[0 * kTriChunk] + dy * p[1 * kTriChunk] +
                         dz * p[2 * kTriChunk];
        const float ov = ox * p[3 * kTriChunk] + oy * p[4 * kTriChunk] +
                         oz * p[5 * kTriChunk] - p[10 * kTriChunk];
        const float qv = dx * p[3 * kTriChunk] + dy * p[4 * kTriChunk] +
                         dz * p[5 * kTriChunk];
        const float ow = ox * p[6 * kTriChunk] + oy * p[7 * kTriChunk] +
                         oz * p[8 * kTriChunk] - p[11 * kTriChunk];
        const float qw = dx * p[6 * kTriChunk] + dy * p[7 * kTriChunk] +
                         dz * p[8 * kTriChunk];
        const bool tiny = fabsf(qw) < 1e-12f;
        const float qw_safe = tiny ? (qw < 0.0f ? -1e-12f : 1e-12f) : qw;
        const float t = -ow / qw_safe;
        const float u = ou + t * qu;
        const float v = ov + t * qv;
        const bool ok = !tiny && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                        t >= min_t && t <= max_t && p[12 * kTriChunk] > 0.5f;
        if (AnyHit) {
          c_any |= ok;
        } else if (ok) {
          const int id = tri_ids[k];
          if (t < c_t || (t == c_t && id < c_id)) {
            c_t = t;
            c_id = id;
            c_u = u;
            c_v = v;
          }
        }
      }
    }
    if (AnyHit) {
      occluded |= c_any;
      if (__all_sync(0xffffffffu, occluded)) break;
    } else if (c_t < best_t) {
      best_t = c_t;
      best_id = c_id;
      best_u = c_u;
      best_v = c_v;
    }
  }
  if (AnyHit) {
    out_occ[r] = occluded;
  } else {
    out_t[r] = best_t;
    out_id[r] = best_id;
    out_u[r] = best_u;
    out_v[r] = best_v;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). Rays are padded to whole
// 256-ray blocks by the caller; every pointer is device memory; the
// launches go on `stream`. Each returns cudaGetLastError() of its launches
// (cudaErrorInvalidValue for arguments the kernel does not take).

// The staged walk. splits: chunk ranges per ray block, at least
// ceil(num_chunks / 1024); part_*: [splits, rays] scratch of the
// closest-hit partials when splits > 1; chunk_mask: null on the render
// paths; a test hook, else [num_blocks, num_chunks] bytes that receive the
// blocks' chunk hit sets.
extern "C" int chunkwalk_staged_closest(
    const float* pack, const int* ids, const float* chunk_lo,
    const float* chunk_hi, const float* org, const float* dir,
    const float* rng, int num_blocks, int num_chunks, int splits,
    float* part_t, int* part_id, float* part_u, float* part_v, float* t,
    int* id, float* u, float* v, unsigned char* chunk_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || static_cast<int64_t>(splits) * kMaxRange < num_chunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_blocks == 0) return static_cast<int>(cudaGetLastError());
  const bool merge = splits > 1;
  const int64_t num_rays = static_cast<int64_t>(num_blocks) * kRayBlock;
  staged_kernel<false><<<num_blocks * splits, kRayBlock, 0, s>>>(
      pack, ids, chunk_lo, chunk_hi, org, dir, rng, num_chunks, splits,
      num_rays, merge ? part_t : t, merge ? part_id : id, merge ? part_u : u,
      merge ? part_v : v, nullptr, chunk_mask);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return static_cast<int>(err);
  merge_kernel<<<static_cast<unsigned>((num_rays + 255) / 256), 256, 0, s>>>(
      part_t, part_id, part_u, part_v, splits, num_rays, t, id, u, v);
  return static_cast<int>(cudaGetLastError());
}

// occluded: [rays] bytes, zeroed by the caller.
extern "C" int chunkwalk_staged_any(
    const float* pack, const int* ids, const float* chunk_lo,
    const float* chunk_hi, const float* org, const float* dir,
    const float* rng, int num_blocks, int num_chunks, int splits,
    unsigned char* occluded, unsigned char* chunk_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || static_cast<int64_t>(splits) * kMaxRange < num_chunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_blocks == 0) return static_cast<int>(cudaGetLastError());
  staged_kernel<true><<<num_blocks * splits, kRayBlock, 0, s>>>(
      pack, ids, chunk_lo, chunk_hi, org, dir, rng, num_chunks, splits,
      static_cast<int64_t>(num_blocks) * kRayBlock, nullptr, nullptr, nullptr,
      nullptr, occluded, chunk_mask);
  return static_cast<int>(cudaGetLastError());
}

// The resident walk over the torch stage's lists chunk_idx [num_blocks,
// num_chunks] (ascending, counts[b] of them valid).
extern "C" int chunkwalk_resident_closest(const float* pack, const int* ids,
                                          const int* chunk_idx,
                                          const int* counts, const float* org,
                                          const float* dir, const float* rng,
                                          int num_blocks, int num_chunks,
                                          float* t, int* id, float* u,
                                          float* v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_blocks > 0) {
    resident_kernel<false><<<num_blocks, kRayBlock, 0, s>>>(
        pack, ids, chunk_idx, counts, org, dir, rng, num_chunks, t, id, u, v,
        nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chunkwalk_resident_any(const float* pack, const int* ids,
                                      const int* chunk_idx, const int* counts,
                                      const float* org, const float* dir,
                                      const float* rng, int num_blocks,
                                      int num_chunks, bool* occluded,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_blocks > 0) {
    resident_kernel<true><<<num_blocks, kRayBlock, 0, s>>>(
        pack, ids, chunk_idx, counts, org, dir, rng, num_chunks, nullptr,
        nullptr, nullptr, nullptr, occluded);
  }
  return static_cast<int>(cudaGetLastError());
}
