// Culled-sweep ray/triangle intersection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel langevin_mcmc_tpu/ops/pallas_isect.py::
// _isect_kernel in both of its variants: closest hit (any_hit=False, used
// by intersect_sweep) and any hit (any_hit=True, used by occluded_sweep).
// The contract is the one of sweep_reference in
// langevin_mcmc_tpu_torch/ops/sweep_isect.py, which the CPU tests and
// chip_smoke.py hold this kernel against.
//
// Design. The TPU kernel runs a grid of (256-ray block x 512-triangle
// chunk) with the chunk axis innermost and in order, accumulating the
// closest hit in its output block; a per-(block, chunk) slab-test mask
// skips chunks. On Hopper, blocks run in parallel and in no order, so the
// sequential chunk axis becomes a loop inside the CTA: one CTA of 256
// threads per ray block (thread i owns ray i) walks the chunks in
// ascending order and skips those the mask clears. The strict "<" across
// chunks then needs no cross-block state. For each visited chunk the 13
// packed rows (Woop inverse frame 0-8, translation 9-11, valid 12) and the
// 512 int32 ids (28 KB) are staged in shared memory between two
// __syncthreads(); every thread reads the same word (a broadcast) while it
// tests its ray against the 512 triangles:
//   t = -Ow / Qw,  u = Ou + t Qu,  v = Ov + t Qv,
// a hit needing |Qw| >= 1e-12, u, v >= 0, u + v <= 1, t in [min_t, max_t]
// and a valid triangle. Within a chunk the smallest t wins and ties go to
// the smallest id; across chunks a later chunk must be strictly closer.
// Any hit visits a chunk only while some ray of the block is unhit (the
// TPU kernel's max(best_t) >= BIG gate), decided block-wide with
// __syncthreads_and; a thread whose ray is already occluded skips the
// chunk's tests.
//
// What bounds it. ~40 f32 operations per ray-triangle test over the mask's
// visited (block, chunk) pairs; the bytes (rays, tables, mask, hits) are a
// few MB. So it is bound by f32 issue rate, not by device memory.
//
// Rounding. Built with --fmad=false, every product and sum rounds on its
// own in the order of the torch version (and of the chunk walk), so the
// kernel, its plain version and the chunk walk give bit-identical t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRayBlock = 256;
constexpr int kTriChunk = 512;
constexpr int kPackRows = 16;  // rows per chunk in the table
constexpr int kStageRows = 13;  // rows the test reads
constexpr float kBig = 3.0e38f;

template <bool AnyHit>
__global__ void __launch_bounds__(kRayBlock)
sweep_kernel(const float* __restrict__ pack, const int* __restrict__ ids,
             const int* __restrict__ mask, const float* __restrict__ org,
             const float* __restrict__ dir, const float* __restrict__ rng,
             int num_chunks, float* __restrict__ out_t,
             int* __restrict__ out_id, float* __restrict__ out_u,
             float* __restrict__ out_v, bool* __restrict__ out_occ) {
  __shared__ float4 s_rows4[kStageRows * kTriChunk / 4];
  __shared__ int s_ids[kTriChunk];
  const float* s_rows = reinterpret_cast<const float*>(s_rows4);

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int64_t r = static_cast<int64_t>(b) * kRayBlock + i;
  const float ox = org[3 * r + 0], oy = org[3 * r + 1], oz = org[3 * r + 2];
  const float dx = dir[3 * r + 0], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
  const float min_t = rng[2 * r + 0], max_t = rng[2 * r + 1];

  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  bool occluded = false;

  const int* block_mask = mask + static_cast<int64_t>(b) * num_chunks;
  for (int j = 0; j < num_chunks; ++j) {
    // the mask entry is the same for every thread of the block, so every
    // thread reaches the barriers below
    if (block_mask[j] == 0) continue;
    if (AnyHit) {
      if (__syncthreads_and(occluded)) break;
    }
    const float4* src = reinterpret_cast<const float4*>(
        pack + static_cast<int64_t>(j) * kPackRows * kTriChunk);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = i; e < kStageRows * kTriChunk / 4; e += kRayBlock) {
      s_rows4[e] = src[e];
    }
    for (int e = i; e < kTriChunk; e += kRayBlock) {
      s_ids[e] = ids[static_cast<int64_t>(j) * kTriChunk + e];
    }
    __syncthreads();
    if (AnyHit && occluded) continue;

    float c_t = kBig, c_u = 0.0f, c_v = 0.0f;
    int c_id = 0x7fffffff;
    for (int k = 0; k < kTriChunk; ++k) {
      const float* p = s_rows + k;
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
        if (ok) {
          occluded = true;
          break;
        }
      } else if (ok) {
        const int id = s_ids[k];
        if (t < c_t || (t == c_t && id < c_id)) {
          c_t = t;
          c_id = id;
          c_u = u;
          c_v = v;
        }
      }
    }
    if (!AnyHit && c_t < best_t) {
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
// 256-ray blocks by the caller; every pointer is device memory; the launch
// goes on `stream`. Each returns cudaGetLastError() of its launch.
extern "C" int sweep_closest(const float* pack, const int* ids,
                             const int* mask, const float* org,
                             const float* dir, const float* rng,
                             int num_blocks, int num_chunks, float* t, int* id,
                             float* u, float* v, void* stream) {
  if (num_blocks > 0) {
    sweep_kernel<false><<<num_blocks, kRayBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        pack, ids, mask, org, dir, rng, num_chunks, t, id, u, v, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sweep_any(const float* pack, const int* ids, const int* mask,
                         const float* org, const float* dir, const float* rng,
                         int num_blocks, int num_chunks, bool* occluded,
                         void* stream) {
  if (num_blocks > 0) {
    sweep_kernel<true><<<num_blocks, kRayBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        pack, ids, mask, org, dir, rng, num_chunks, nullptr, nullptr, nullptr,
        nullptr, occluded);
  }
  return static_cast<int>(cudaGetLastError());
}
