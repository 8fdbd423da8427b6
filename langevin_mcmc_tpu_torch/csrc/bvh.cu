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
// What bounds it: the walk is a divergent per-thread loop of dependent
// loads (a node's two children, then up to four triangles a leaf), so it
// is bound by the latency of those loads, not by the card's f32 rate or
// its bandwidth. The design keeps it simple: the stack of 64 node ids
// lives in the thread's local memory, nodes are read as two float4
// through the read-only path and triangle rows with __ldg, and a moving
// scene's vertices are lerped in registers at the ray's time. Ray sorting,
// wide nodes and a short stack are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kStackDepth = 64;   // ops/bvh.py STACK_DEPTH
constexpr int kMaxLeaf = 4;       // ops/bvh.py MAX_LEAF
constexpr int kThreads = 128;

// torch.minimum / torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

// _ray_box: near = max(max_k min(t0, t1), t_min), far = min(min_k max(t0,
// t1), t_max); near <= far
__device__ __forceinline__ bool ray_box(const float4 a, const float4 b,
                                        const float o[3], const float inv[3],
                                        float t_min, float t_max) {
  const float lo[3] = {a.x, a.y, a.z};
  const float hi[3] = {a.w, b.x, b.y};
  float near = 0.f, far = 0.f;
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

__device__ __forceinline__ void vertex(const float* __restrict__ p0,
                                       const float* __restrict__ p1,
                                       bool motion, float time, int base,
                                       float out[3]) {
  for (int k = 0; k < 3; ++k) {
    const float a = __ldg(p0 + base + k);
    out[k] = motion ? (1.0f - time) * a + time * __ldg(p1 + base + k) : a;
  }
}

__global__ void __launch_bounds__(kThreads)
bvh_kernel(const float4* __restrict__ nodes, const int* __restrict__ prims,
           const float* __restrict__ tri_p0, const float* __restrict__ tri_p1,
           const float* __restrict__ org, const float* __restrict__ dir,
           const float* __restrict__ ray_time, const float* __restrict__ min_t,
           const float* __restrict__ max_t, int num_rays, int num_tris,
           int motion, int any_hit, float* __restrict__ out_t,
           int* __restrict__ out_id, float* __restrict__ out_u,
           float* __restrict__ out_v, unsigned char* __restrict__ occluded) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= num_rays) return;
  float o[3], d[3], inv[3];
  for (int k = 0; k < 3; ++k) {
    o[k] = __ldg(org + 3 * r + k);
    d[k] = __ldg(dir + 3 * r + k);
    inv[k] = 1.0f / (d[k] == 0.0f ? 1e-20f : d[k]);
  }
  const float time = __ldg(ray_time + r);
  const float mn = __ldg(min_t + r);
  const float mx = __ldg(max_t + r);

  int stack[kStackDepth];
  stack[0] = 0;
  int sp = 1;
  float best_t = CUDART_INF_F, best_u = 0.f, best_v = 0.f;
  int best_id = 0;
  do {
    const int node = stack[--sp];
    const float4 a = __ldg(nodes + 2 * node);
    const float4 b = __ldg(nodes + 2 * node + 1);
    if (b.w > 0.0f) {  // leaf: b.z first primitive, b.w count
      const int first = static_cast<int>(b.z);
      const int n = static_cast<int>(b.w);
      for (int k = 0; k < kMaxLeaf && k < n; ++k) {
        const int pid = __ldg(prims + min(first + k, num_tris - 1));
        float v0[3], v1[3], v2[3];
        vertex(tri_p0, tri_p1, motion, time, 9 * pid, v0);
        vertex(tri_p0, tri_p1, motion, time, 9 * pid + 3, v1);
        vertex(tri_p0, tri_p1, motion, time, 9 * pid + 6, v2);
        float e1[3], e2[3], s[3];
        for (int c = 0; c < 3; ++c) {
          e1[c] = v1[c] - v0[c];
          e2[c] = v2[c] - v0[c];
          s[c] = o[c] - v0[c];
        }
        // moller_trumbore (ops/intersect.py), in traverse_reference's order
        const float s1x = d[1] * e2[2] - d[2] * e2[1];
        const float s1y = d[2] * e2[0] - d[0] * e2[2];
        const float s1z = d[0] * e2[1] - d[1] * e2[0];
        const float div = s1x * e1[0] + s1y * e1[1] + s1z * e1[2];
        const float clamped = fabsf(div) < 1e-12f
                                  ? (div < 0.0f ? -1e-12f : 1e-12f)
                                  : div;
        const float inv_div = 1.0f / clamped;
        const float u = (s[0] * s1x + s[1] * s1y + s[2] * s1z) * inv_div;
        const float s2x = s[1] * e1[2] - s[2] * e1[1];
        const float s2y = s[2] * e1[0] - s[0] * e1[2];
        const float s2z = s[0] * e1[1] - s[1] * e1[0];
        const float v = (d[0] * s2x + d[1] * s2y + d[2] * s2z) * inv_div;
        const float t = (e2[0] * s2x + e2[1] * s2y + e2[2] * s2z) * inv_div;
        if (div != 0.0f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
            t >= mn && t <= mx && t < best_t) {
          best_t = t;
          best_id = pid;
          best_u = u;
          best_v = v;
        }
      }
    } else {  // inner: b.z left child, -b.w right child
      const int left = static_cast<int>(b.z);
      const int right = static_cast<int>(-b.w);
      const float tmax = nan_min(mx, best_t);
      const bool lhit = ray_box(__ldg(nodes + 2 * left),
                                __ldg(nodes + 2 * left + 1), o, inv, mn, tmax);
      const bool rhit = ray_box(__ldg(nodes + 2 * right),
                                __ldg(nodes + 2 * right + 1), o, inv, mn,
                                tmax);
      if (rhit) stack[sp++] = right;
      if (lhit) stack[sp++] = left;
    }
  } while (sp > 0 && !(any_hit && isfinite(best_t)));

  if (any_hit) {
    occluded[r] = isfinite(best_t) ? 1 : 0;
  } else {
    out_t[r] = best_t;
    out_id[r] = best_id;
    out_u[r] = best_u;
    out_v[r] = best_v;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes by ops/cuda_build.py): nodes [N,
// 8] f32 (16-byte aligned), prim ids [T] i32, tri_p [2, T, 3, 3] f32 (both
// keyframes; the second read only when motion), rays org / dir [R, 3],
// time / min_t / max_t [R]; closest hit writes t (inf on a miss), id, u,
// v, any hit writes occluded. Returns cudaGetLastError() of the launch.
extern "C" int bvh_traverse(
    const float* nodes, const int* prims, const float* tri_p,
    const float* org, const float* dir, const float* time,
    const float* min_t, const float* max_t, int num_rays, int num_tris,
    int motion, int any_hit, float* t, int* id, float* u, float* v,
    unsigned char* occluded, void* stream) {
  if (num_rays > 0) {
    const int grid = (num_rays + kThreads - 1) / kThreads;
    bvh_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(nodes), prims, tri_p,
        tri_p + 9 * static_cast<long long>(num_tris), org, dir, time, min_t,
        max_t, num_rays, num_tris, motion, any_hit, t, id, u, v, occluded);
  }
  return static_cast<int>(cudaGetLastError());
}
