// BVH traversal for Hopper (sm_90a): one thread per ray, closest hit
// (any_hit=0, intersect_bvh) and any hit (any_hit=1, occluded_bvh).
//
// It replaces no Pallas kernel: the JAX package traverses its BVH with a
// per-ray lax.while_loop under vmap (langevin_mcmc_tpu/ops/bvh.py:146,
// _traverse_one), which XLA runs as one loop on the device. Eager torch
// would pay a launch per op per round of that loop, so this kernel is its
// counterpart on the card. Its contract is traverse_reference
// (langevin_mcmc_tpu_torch/ops/bvh.py), which it equals bit for bit: the
// library is built with --fmad=false and every product and sum below is
// written in the plain version's order; the slab test's min / max
// propagate NaN as torch.minimum / torch.maximum do.
//
// What bounds it: a ray's walk is a chain of dependent loads (each node
// says where the next one is) and, on a moving scene, of long triangle
// tests, and the lanes of a warp walk paths of different lengths, so the
// kernel is bound by the latency of the slowest lane's chain, not by the
// card's f32 rate or its bandwidth (the chip's trees and triangles fit
// in L2). The design shortens that chain and keeps the lanes together.
// It walks the tables of ops/bvh.py pack_bvh, built once per tree:
//  * an inner node is one 64-byte record holding both children's boxes
//    and references, so a step is one load and two slab tests; the next
//    node stays in a register (both children hit: the right one is
//    pushed and the left one taken; one hit: it is taken; none: a pop),
//    which visits the nodes of traverse_reference's "push right, push
//    left, pop" in its order, each box tested with the same t_max;
//  * a reference to a leaf carries its (first, count), so a leaf costs
//    no node load, and its triangles sit in leaf order as three float4
//    a keyframe (the triangle's id bit-cast into a spare lane), so a
//    leaf is one burst of independent loads with no prim-id indirection;
//  * the loop is while-while: a lane walks inner nodes until it stands
//    on a leaf, then the warp's lanes test their leaves together, so a
//    round no longer issues both the inner and the leaf branch;
//  * the slab test's NaN-propagating min / max are single instructions
//    (min.NaN / max.NaN).
// Each of the register-held next node, the leaf order and the while-while
// loop was also undone alone in a patched copy (bvh_designs.py, PERF.md):
// each copy was slower on the 65,536-ray rows. Storing p0, e1, e2 for a
// static scene instead of the vertices was no faster, so one layout
// serves static and moving scenes.
// Measured and left out (bvh_designs.py, PERF.md): the top levels of the
// tree in shared memory (255 or 1,023 records a block: no faster than
// the L1 that __ldg reads through, slower with the larger copy); and
// persistent warps: at 65,536 rays every block is resident in one wave,
// so there is no tail of blocks to take over, and the tail that remains
// is within a warp (its slowest lane). The stack of references lives in
// the thread's local memory (L1); a moving scene's vertices are lerped in
// registers at the ray's time; a block is 64 threads (kThreads: 32 to 256
// were within a few percent of each other, bvh_designs.py).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "tri.cuh"

namespace {

constexpr int kStackDepth = 64;   // ops/bvh.py STACK_DEPTH
constexpr int kMaxLeaf = 4;       // ops/bvh.py MAX_LEAF
constexpr int kThreads = 64;      // threads a block

// torch.minimum / torch.maximum: NaN if either operand is NaN (the box
// test only compares the results, so the sign of a zero does not matter)
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// _ray_box: near = max(max_k min(t0, t1), t_min), far = min(min_k max(t0,
// t1), t_max); near <= far
__device__ __forceinline__ bool ray_box(const float lo[3], const float hi[3],
                                        const float o[3], const float inv[3],
                                        float t_min, float t_max) {
  float near = 0.f, far = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t0 = (lo[k] - o[k]) * inv[k];
    const float t1 = (hi[k] - o[k]) * inv[k];
    const float tn = nan_min(t0, t1);
    const float tf = nan_max(t0, t1);
    near = k == 0 ? tn : nan_max(near, tn);
    far = k == 0 ? tf : nan_min(far, tf);
  }
  return nan_max(near, t_min) <= nan_min(far, t_max);
}

// a leaf's triangles (reference < 0): every triangle's loads issued
// before the first test; a hit strictly closer than best_t replaces it
template <bool kMotion>
__device__ __forceinline__ void leaf(const float4* __restrict__ tris0,
                                     const float4* __restrict__ tris1,
                                     int ref, float time, const float o[3],
                                     const float d[3], float mn, float mx,
                                     float* best_t, int* best_id,
                                     float* best_u, float* best_v) {
  const int first = (~ref) >> 3;
  const int count = (~ref) & 7;
  float4 v[kMaxLeaf][3];
#pragma unroll
  for (int k = 0; k < kMaxLeaf; ++k)
    if (k < count) load_tri<kMotion>(tris0, tris1, first + k, time, v[k]);
#pragma unroll
  for (int k = 0; k < kMaxLeaf; ++k) {
    float t, u, w;
    if (k < count && tri_test(v[k], o, d, mn, mx, *best_t, &t, &u, &w)) {
      *best_t = t;
      *best_id = __float_as_int(v[k][0].w);
      *best_u = u;
      *best_v = w;
    }
  }
}

template <bool kMotion, bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
bvh_kernel(const float4* __restrict__ records, int root,
           const float4* __restrict__ tris0, const float4* __restrict__ tris1,
           const float* __restrict__ org, const float* __restrict__ dir,
           const float* __restrict__ ray_time, const float* __restrict__ min_t,
           const float* __restrict__ max_t, int num_rays,
           float* __restrict__ out_t, int* __restrict__ out_id,
           float* __restrict__ out_u, float* __restrict__ out_v,
           unsigned char* __restrict__ occluded) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= num_rays) return;
  float o[3], d[3], inv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = __ldg(org + 3 * r + k);
    d[k] = __ldg(dir + 3 * r + k);
    inv[k] = 1.0f / (d[k] == 0.0f ? 1e-20f : d[k]);
  }
  const float time = kMotion ? __ldg(ray_time + r) : 0.0f;
  const float mn = __ldg(min_t + r);
  const float mx = __ldg(max_t + r);

  // a reference: >= 0 an inner record; < 0 a leaf, ~ref = first << 3 | count
  int stack[kStackDepth];
  int sp = 0;
  int node = root;
  bool done = false;
  float best_t = CUDART_INF_F, best_u = 0.f, best_v = 0.f;
  int best_id = 0;
  // while-while: a lane walks inner nodes until it stands on a leaf (or is
  // done), then the warp's lanes test their leaves together
  while (!done) {
    while (node >= 0) {
      const float4 a = __ldg(records + 4 * node);
      const float4 b = __ldg(records + 4 * node + 1);
      const float4 c = __ldg(records + 4 * node + 2);
      const float4 e = __ldg(records + 4 * node + 3);
      const float tmax = nan_min(mx, best_t);
      const float llo[3] = {a.x, a.y, a.z}, lhi[3] = {a.w, b.x, b.y};
      const float rlo[3] = {b.z, b.w, c.x}, rhi[3] = {c.y, c.z, c.w};
      const bool lhit = ray_box(llo, lhi, o, inv, mn, tmax);
      const bool rhit = ray_box(rlo, rhi, o, inv, mn, tmax);
      if (lhit) {
        if (rhit) stack[sp++] = __float_as_int(e.y);
        node = __float_as_int(e.x);
      } else if (rhit) {
        node = __float_as_int(e.y);
      } else if (sp > 0) {
        node = stack[--sp];
      } else {
        done = true;
        break;
      }
    }
    while (!done && node < 0) {
      leaf<kMotion>(tris0, tris1, node, time, o, d, mn, mx, &best_t,
                    &best_id, &best_u, &best_v);
      if ((kAnyHit && isfinite(best_t)) || sp == 0)
        done = true;
      else
        node = stack[--sp];
    }
  }

  if (kAnyHit) {
    occluded[r] = isfinite(best_t) ? 1 : 0;
  } else {
    out_t[r] = best_t;
    out_id[r] = best_id;
    out_u[r] = best_u;
    out_v[r] = best_v;
  }
}

template <bool kMotion, bool kAnyHit>
int launch(const float4* records, int root, const float4* tris0,
           const float4* tris1, const float* org, const float* dir,
           const float* time, const float* min_t, const float* max_t,
           int num_rays, float* t, int* id, float* u, float* v,
           unsigned char* occluded, cudaStream_t stream) {
  const int grid = (num_rays + kThreads - 1) / kThreads;
  bvh_kernel<kMotion, kAnyHit><<<grid, kThreads, 0, stream>>>(
      records, root, tris0, tris1, org, dir, time, min_t, max_t, num_rays, t,
      id, u, v, occluded);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes by ops/cuda_build.py): the packed
// tables of ops/bvh.py pack_bvh (records [M, 16] f32, the root's
// reference, leaf-ordered triangles [2, T, 3, 4] f32, both 16-byte
// aligned; the second keyframe read only when motion), rays org / dir
// [R, 3], time / min_t / max_t [R]; closest hit writes t (inf on a
// miss), id, u, v, any hit writes occluded. Returns cudaGetLastError() of
// the launch.
extern "C" int bvh_traverse(const float* records, int root, const float* tris,
                            int num_tris, const float* org, const float* dir,
                            const float* time, const float* min_t,
                            const float* max_t, int num_rays, int motion,
                            int any_hit, float* t, int* id, float* u,
                            float* v, unsigned char* occluded, void* stream) {
  if (num_rays <= 0) return static_cast<int>(cudaGetLastError());
  const float4* rec = reinterpret_cast<const float4*>(records);
  const float4* tris0 = reinterpret_cast<const float4*>(tris);
  const float4* tris1 = tris0 + 3 * static_cast<long long>(num_tris);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LMCMC_BVH_LAUNCH(M, A)                                              \
  return launch<M, A>(rec, root, tris0, tris1, org, dir, time, min_t, max_t, \
                      num_rays, t, id, u, v, occluded, s)
  if (motion) {
    if (any_hit) LMCMC_BVH_LAUNCH(true, true);
    LMCMC_BVH_LAUNCH(true, false);
  }
  if (any_hit) LMCMC_BVH_LAUNCH(false, true);
  LMCMC_BVH_LAUNCH(false, false);
#undef LMCMC_BVH_LAUNCH
}
