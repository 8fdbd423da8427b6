// Pieces shared by the kernels that walk a ray block's list of triangle
// chunks or tiles: csrc/walk.cuh (the chunk walk and the culled sweep)
// and csrc/brute.cu (the brute force). A block slab-tests its rays
// against the boxes of a range of chunks, ORs the results per chunk by
// warp ballot into a shared bit mask, and compacts the set bits into an
// ascending list; the chunks' rows then reach shared memory through a
// cp.async ring.

#pragma once

#include <cuda_runtime.h>

namespace {

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

// The near and far t of the ray (origin o, inverse direction i) through
// the box [l, h], in the order of the torch stages (per axis the min and
// max of (l - o) i and (h - o) i, then the max of the mins and the min of
// the maxes), NaN propagating.
__device__ __forceinline__ void slab(float lx, float ly, float lz, float hx,
                                     float hy, float hz, float ox, float oy,
                                     float oz, float ix, float iy, float iz,
                                     float* tn, float* tf) {
  const float t0x = (lx - ox) * ix, t1x = (hx - ox) * ix;
  const float t0y = (ly - oy) * iy, t1y = (hy - oy) * iy;
  const float t0z = (lz - oz) * iz, t1z = (hz - oz) * iz;
  *tn = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                nan_min(t0z, t1z));
  *tf = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                nan_max(t0z, t1z));
}

// The block's list: mask bit k for entry k of the range, set where some
// ray of the warp hits it (every thread of the warp calls list_mark with
// the same k).
template <int kThreads>
__device__ __forceinline__ void list_clear(unsigned* mask, int len,
                                           int tid) {
  for (int w = tid; w < (len + 31) / 32; w += kThreads) mask[w] = 0u;
}

__device__ __forceinline__ void list_mark(unsigned* mask, int k, bool hit) {
  if (__ballot_sync(0xffffffffu, hit) != 0u && (threadIdx.x & 31) == 0) {
    atomicOr(&mask[k >> 5], 1u << (k & 31));
  }
}

__device__ __forceinline__ bool list_bit(const unsigned* mask, int k) {
  return (mask[k >> 5] >> (k & 31)) & 1u;
}

// The set bits of mask [len bits] as the ascending list first + k; returns
// the list's length (every thread).
template <int kThreads>
__device__ __forceinline__ int list_compact(const unsigned* mask, int len,
                                            int first, int* list, int tid) {
  const int words = (len + 31) / 32;
  int n = 0;
  for (int w = 0; w < words; ++w) n += __popc(mask[w]);
  for (int k = tid; k < len; k += kThreads) {
    const unsigned word = mask[k >> 5];
    if ((word >> (k & 31)) & 1u) {
      int pos = __popc(word & ((1u << (k & 31)) - 1u));
      for (int w = 0; w < (k >> 5); ++w) pos += __popc(mask[w]);
      list[pos] = first + k;
    }
  }
  return n;
}

}  // namespace
