// Chunk-walk ray/triangle intersection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of langevin_mcmc_tpu/ops/chunkwalk.py:
// _walk_kernel (chunks fetched from HBM one by one; Resident = false) and
// _walk_kernel_resident (the whole pack held in fast memory; Resident =
// true), each in both of its variants: closest hit (any_hit=False, used by
// intersect_chunkwalk) and any hit (any_hit=True, used by
// occluded_chunkwalk). The contract is the one of walk_reference in
// langevin_mcmc_tpu_torch/ops/chunkwalk.py, which the CPU tests and
// chip_smoke.py hold this kernel against; both forms compute the same
// function.
//
// Design. One CTA of 256 threads per 256-ray block; thread i owns ray i of
// the block. The block walks its own ascending list of hit chunks
// (chunk_idx[b, 0:counts[b]]). Every thread projects its ray into each of
// the chunk's 128 triangle frames:
//   t = -Ow / Qw,  u = Ou + t Qu,  v = Ov + t Qv.
// A hit needs |Qw| >= 1e-12, u, v >= 0, u + v <= 1, t in [min_t, max_t] and
// a valid triangle. Within a chunk the smallest t wins and ties go to the
// smallest id; across chunks a later chunk must be strictly closer (the
// tie rule of the TPU kernel).
//  * Resident = false: each chunk's [16, 128] f32 packed rows (8 KB: Woop
//    inverse frame in rows 0-8, translation 9-11, valid 12) and its 128
//    int32 ids are staged in shared memory between two __syncthreads();
//    any hit leaves the chunk loop once every ray of the block is occluded
//    (__syncthreads_and).
//  * Resident = true: rows are read straight from global memory. A pack of
//    a few MB (1.58 MB on the 24,588-triangle flagship scene) stays in the
//    50 MB L2, and all threads of a warp read the same row element, so each
//    load is one broadcast. No staging and no barrier per chunk; any hit
//    leaves per warp (__all_sync), which gives the same output.
//
// What bounds it. Each ray-triangle test is ~40 f32 operations on operands
// every thread shares (a broadcast), and each chunk costs one 8.5 KB read
// that L2 serves. So the kernel is bound by f32 issue rate (and, staged, by
// the synchronisation around each chunk), not by device-memory bytes.
//
// Rounding. Built with --fmad=false, every product and sum is rounded on
// its own, in the same order as the torch version, so the two agree
// exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRayBlock = 256;
constexpr int kTriChunk = 128;
constexpr int kPackRows = 16;
constexpr float kBig = 3.0e38f;

template <bool AnyHit, bool Resident>
__global__ void __launch_bounds__(kRayBlock)
walk_kernel(const float* __restrict__ pack, const int* __restrict__ ids,
            const int* __restrict__ chunk_idx, const int* __restrict__ counts,
            const float* __restrict__ org, const float* __restrict__ dir,
            const float* __restrict__ rng, int num_chunks,
            float* __restrict__ out_t, int* __restrict__ out_id,
            float* __restrict__ out_u, float* __restrict__ out_v,
            bool* __restrict__ out_occ) {
  __shared__ float4 s_pack4[kPackRows * kTriChunk / 4];
  __shared__ int s_ids[kTriChunk];
  const float* s_pack = reinterpret_cast<const float*>(s_pack4);

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
    const float* rows;
    const int* tri_ids;
    if (Resident) {
      rows = pack + cid * kPackRows * kTriChunk;
      tri_ids = ids + cid * kTriChunk;
    } else {
      const float4* src =
          reinterpret_cast<const float4*>(pack + cid * kPackRows * kTriChunk);
      __syncthreads();  // the previous chunk is no longer read
      for (int e = i; e < kPackRows * kTriChunk / 4; e += kRayBlock) {
        s_pack4[e] = src[e];
      }
      if (i < kTriChunk) s_ids[i] = ids[cid * kTriChunk + i];
      __syncthreads();
      rows = s_pack;
      tri_ids = s_ids;
    }

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
      if (Resident) {
        if (__all_sync(0xffffffffu, occluded)) break;
      } else {
        // every thread reaches this barrier: count is uniform in the block
        if (__syncthreads_and(occluded)) break;
      }
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

template <bool AnyHit, bool Resident>
void launch(int num_blocks, cudaStream_t stream, const float* pack,
            const int* ids, const int* chunk_idx, const int* counts,
            const float* org, const float* dir, const float* rng,
            int num_chunks, float* t, int* id, float* u, float* v,
            bool* occluded) {
  walk_kernel<AnyHit, Resident><<<num_blocks, kRayBlock, 0, stream>>>(
      pack, ids, chunk_idx, counts, org, dir, rng, num_chunks, t, id, u, v,
      occluded);
}

}  // namespace

// Plain C entry points (bound with ctypes). Rays are padded to whole
// 256-ray blocks by the caller; every pointer is device memory; the launch
// goes on `stream`; `resident` picks the form. Each returns
// cudaGetLastError() of its launch.
extern "C" int chunkwalk_closest(const float* pack, const int* ids,
                                 const int* chunk_idx, const int* counts,
                                 const float* org, const float* dir,
                                 const float* rng, int num_blocks,
                                 int num_chunks, int resident, float* t,
                                 int* id, float* u, float* v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_blocks > 0 && resident) {
    launch<false, true>(num_blocks, s, pack, ids, chunk_idx, counts, org, dir,
                        rng, num_chunks, t, id, u, v, nullptr);
  } else if (num_blocks > 0) {
    launch<false, false>(num_blocks, s, pack, ids, chunk_idx, counts, org,
                         dir, rng, num_chunks, t, id, u, v, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chunkwalk_any(const float* pack, const int* ids,
                             const int* chunk_idx, const int* counts,
                             const float* org, const float* dir,
                             const float* rng, int num_blocks, int num_chunks,
                             int resident, bool* occluded, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_blocks > 0 && resident) {
    launch<true, true>(num_blocks, s, pack, ids, chunk_idx, counts, org, dir,
                       rng, num_chunks, nullptr, nullptr, nullptr, nullptr,
                       occluded);
  } else if (num_blocks > 0) {
    launch<true, false>(num_blocks, s, pack, ids, chunk_idx, counts, org, dir,
                        rng, num_chunks, nullptr, nullptr, nullptr, nullptr,
                        occluded);
  }
  return static_cast<int>(cudaGetLastError());
}
