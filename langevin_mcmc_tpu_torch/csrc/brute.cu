// Brute-force ray/triangle intersection for Hopper (sm_90a): every live
// ray against every triangle, closest hit (any_hit=0,
// intersect_bruteforce) and any hit (any_hit=1, occluded_bruteforce), on
// a static or a moving scene (kMotion: each vertex lerped between the two
// keyframes at the ray's time).
//
// It replaces no Pallas kernel: the JAX package's brute force
// (langevin_mcmc_tpu/ops/intersect.py:59, intersect_bruteforce) is a
// lax.scan over 1024-triangle chunks that XLA runs as one device loop, and
// it is the query of every moving scene without a BVH. In torch that scan
// costs a launch per op per chunk and a host gather of the live rays, so
// this kernel is its counterpart on the card. Its contract is the plain
// version _bruteforce_block (langevin_mcmc_tpu_torch/ops/intersect.py),
// which it equals bit for bit: the test is tri.cuh's, in the plain
// version's order, built with --fmad=false; and the plain version's tie
// rule (the first minimum within a chunk, strict < across chunks) is the
// smallest id among the minimal t, which a strict < over the ids in
// ascending order gives. t stays inf where nothing is hit; the id, u and v
// of a ray stay 0 until a test passes.
//
// What bounds it: f32 operations, live rays x triangles x (61, + 28 to
// lerp a moving triangle's vertices), about 2 ms at the flagship's
// moving queries over the card's 67 TFLOP/s; with --fmad=false no
// product fuses into a sum, so the practical floor is about twice that.
// The design keeps the f32 pipes fed and nothing else in the way:
//  * one thread a ray; a block's 128 rays test the scene's triangles in
//    tiles of 128 staged through shared memory (each thread loads one
//    triangle: p0, e1, e2 of a static scene, which the plain version
//    computes once a chunk too; both keyframes' vertices of a moving
//    one), every thread reading the same triangle at once (a broadcast);
//  * the triangles are split into S ranges of tiles across the grid's y
//    (S from the wrapper, ops/intersect.brute_splits, so that a query of
//    a few thousand rays still fills the card), each range writing its
//    partial best; merge_kernel then takes the first strictly smaller t
//    over the ranges in order, which is the order of the ids;
//  * a dead ray (max_t < min_t, or NaN) tests nothing, and a block whose
//    rays are all dead returns before its first tile;
//  * any hit: a ray stops at its first valid test (its t is finite: t >=
//    min_t > -inf and t < inf) and a block leaves once all its rays have;
//    a ray with min_t = -inf runs the closest hit's loop, since a later
//    t = -inf would make the plain version's best t infinite (no hit).
// Left for later, if it stays far from its bound: culling tiles by the
// union box of both keyframes, and tensor-core forms.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "tri.cuh"

namespace {

constexpr int kThreads = 128;   // rays a block, triangles a tile

template <bool kMotion, bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
brute_kernel(const float* __restrict__ tri_p, int num_tris,
             int tiles_per_split, const float* __restrict__ org,
             const float* __restrict__ dir,
             const float* __restrict__ ray_time,
             const float* __restrict__ min_t,
             const float* __restrict__ max_t, int num_rays,
             float* __restrict__ part_t, int* __restrict__ part_id,
             float* __restrict__ part_u, float* __restrict__ part_v) {
  // static: p0, e1, e2 of each triangle; moving: v0, v1, v2 of keyframe 0,
  // then of keyframe 1 at + 3 * kThreads
  __shared__ float4 tile[(kMotion ? 6 : 3) * kThreads];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in = r < num_rays;
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
  float time = 0.f, mn = 0.f, mx = -1.f;
  if (in) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = __ldg(org + 3 * r + k);
      d[k] = __ldg(dir + 3 * r + k);
    }
    if (kMotion) time = __ldg(ray_time + r);
    mn = __ldg(min_t + r);
    mx = __ldg(max_t + r);
  }
  const float a = 1.0f - time;
  bool done = !(mx >= mn);
  float best_t = CUDART_INF_F, best_u = 0.f, best_v = 0.f;
  int best_id = 0;
  const bool stop_early = kAnyHit && mn > -CUDART_INF_F;

  const int num_tiles = (num_tris + kThreads - 1) / kThreads;
  const int tile0 = blockIdx.y * tiles_per_split;
  const int tile1 = min(tile0 + tiles_per_split, num_tiles);
  if (__syncthreads_or(!done)) {
    for (int tt = tile0; tt < tile1; ++tt) {
      const int base = tt * kThreads;
      const int n = min(kThreads, num_tris - base);
      __syncthreads();   // the last tile is no longer read
      if (threadIdx.x < n) {
        const float* p =
            tri_p + 9 * static_cast<long long>(base + threadIdx.x);
        float4 v[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          v[c] = make_float4(__ldg(p + 3 * c), __ldg(p + 3 * c + 1),
                             __ldg(p + 3 * c + 2), 0.f);
        if (kMotion) {
          const float* q = p + 9 * static_cast<long long>(num_tris);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            tile[3 * threadIdx.x + c] = v[c];
            tile[3 * (kThreads + threadIdx.x) + c] =
                make_float4(__ldg(q + 3 * c), __ldg(q + 3 * c + 1),
                            __ldg(q + 3 * c + 2), 0.f);
          }
        } else {
          tile[3 * threadIdx.x] = v[0];
          tile[3 * threadIdx.x + 1] = make_float4(
              v[1].x - v[0].x, v[1].y - v[0].y, v[1].z - v[0].z, 0.f);
          tile[3 * threadIdx.x + 2] = make_float4(
              v[2].x - v[0].x, v[2].y - v[0].y, v[2].z - v[0].z, 0.f);
        }
      }
      __syncthreads();
      if (!done) {
#pragma unroll 2
        for (int k = 0; k < n; ++k) {
          float p0[3], e1[3], e2[3];
          if (kMotion) {
            float w[3][3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float4 x = tile[3 * k + c];
              const float4 y = tile[3 * (kThreads + k) + c];
              w[c][0] = a * x.x + time * y.x;
              w[c][1] = a * x.y + time * y.y;
              w[c][2] = a * x.z + time * y.z;
            }
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              p0[j] = w[0][j];
              e1[j] = w[1][j] - w[0][j];
              e2[j] = w[2][j] - w[0][j];
            }
          } else {
            const float4 x = tile[3 * k], y = tile[3 * k + 1],
                         z = tile[3 * k + 2];
            p0[0] = x.x; p0[1] = x.y; p0[2] = x.z;
            e1[0] = y.x; e1[1] = y.y; e1[2] = y.z;
            e2[0] = z.x; e2[1] = z.y; e2[2] = z.z;
          }
          float t, u, v;
          if (tri_test_edges(p0, e1, e2, o, d, mn, mx, best_t, &t, &u, &v)) {
            best_t = t;
            best_id = base + k;
            best_u = u;
            best_v = v;
            if (stop_early) {
              done = true;
              break;
            }
          }
        }
      }
      if (kAnyHit && !__syncthreads_or(!done)) break;
    }
  }
  if (in) {
    const long long i = static_cast<long long>(blockIdx.y) * num_rays + r;
    part_t[i] = best_t;
    if (!kAnyHit) {
      part_id[i] = best_id;
      part_u[i] = best_u;
      part_v[i] = best_v;
    }
  }
}

// Per ray, the partial bests of the S tile ranges in order: the closest
// hit takes a range's only where its t is strictly smaller (the smaller id
// on a tie); the any hit is occluded where the smallest t is finite.
template <bool kAnyHit>
__global__ void merge_kernel(const float* __restrict__ part_t,
                             const int* __restrict__ part_id,
                             const float* __restrict__ part_u,
                             const float* __restrict__ part_v, int splits,
                             int num_rays, float* __restrict__ t,
                             int* __restrict__ id, float* __restrict__ u,
                             float* __restrict__ v,
                             unsigned char* __restrict__ occluded) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= num_rays) return;
  int best = 0;
  float best_t = part_t[r];
  for (int s = 1; s < splits; ++s) {
    const float x = part_t[static_cast<long long>(s) * num_rays + r];
    if (x < best_t) {
      best_t = x;
      best = s;
    }
  }
  if (kAnyHit) {
    occluded[r] = isfinite(best_t) ? 1 : 0;
  } else {
    const long long i = static_cast<long long>(best) * num_rays + r;
    t[r] = best_t;
    id[r] = part_id[i];
    u[r] = part_u[i];
    v[r] = part_v[i];
  }
}

template <bool kMotion, bool kAnyHit>
int launch(const float* tri_p, int num_tris, const float* org,
           const float* dir, const float* time, const float* min_t,
           const float* max_t, int num_rays, int splits, float* part_t,
           int* part_id, float* part_u, float* part_v, float* t, int* id,
           float* u, float* v, unsigned char* occluded, cudaStream_t stream) {
  const int num_tiles = (num_tris + kThreads - 1) / kThreads;
  const int per = (num_tiles + splits - 1) / splits;
  const dim3 grid((num_rays + kThreads - 1) / kThreads, splits);
  brute_kernel<kMotion, kAnyHit><<<grid, kThreads, 0, stream>>>(
      tri_p, num_tris, per, org, dir, time, min_t, max_t, num_rays, part_t,
      part_id, part_u, part_v);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<kAnyHit><<<(num_rays + 255) / 256, 256, 0, stream>>>(
      part_t, part_id, part_u, part_v, splits, num_rays, t, id, u, v,
      occluded);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes by ops/cuda_build.py): the
// scene's triangles tri_p [2, T, 3, 3] f32 (the second keyframe read only
// when motion), rays org / dir [R, 3], time / min_t / max_t [R], the tile
// ranges S (each of ceil(ceil(T / 128) / S) tiles; a range past the
// last tile finds nothing), S partial bests part_t / part_id / part_u / part_v [S, R] (the
// any hit writes part_t only); the closest hit writes t (inf on a miss),
// id, u, v, the any hit occluded. Returns cudaGetLastError() of the
// launches.
extern "C" int brute_force(const float* tri_p, int num_tris,
                           const float* org, const float* dir,
                           const float* time, const float* min_t,
                           const float* max_t, int num_rays, int splits,
                           int motion, int any_hit, float* part_t,
                           int* part_id, float* part_u, float* part_v,
                           float* t, int* id, float* u, float* v,
                           unsigned char* occluded, void* stream) {
  if (num_rays <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LMCMC_BRUTE_LAUNCH(M, A)                                            \
  return launch<M, A>(tri_p, num_tris, org, dir, time, min_t, max_t,       \
                      num_rays, splits, part_t, part_id, part_u, part_v, t, \
                      id, u, v, occluded, s)
  if (motion) {
    if (any_hit) LMCMC_BRUTE_LAUNCH(true, true);
    LMCMC_BRUTE_LAUNCH(true, false);
  }
  if (any_hit) LMCMC_BRUTE_LAUNCH(false, true);
  LMCMC_BRUTE_LAUNCH(false, false);
#undef LMCMC_BRUTE_LAUNCH
}
