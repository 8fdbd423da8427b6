// The ray/triangle test shared by the BVH traversal (bvh.cu) and the
// brute force (brute.cu): ops/intersect.py moller_trumbore with every
// product and sum rounded on its own in the order of the plain versions
// (ops/intersect.py tri_test_ordered, which traverse_reference and
// _bruteforce_block call). The library is built with --fmad=false, so no
// product is fused into a sum and the kernels round as the plain
// versions do, bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace {

// a triangle's three vertices at the ray's time, lane 3 of v[0] the
// triangle's id bits (the leaf-ordered tables of pack_bvh, [2, T, 3]
// float4); a moving vertex is vm.lerp's (1 - t) * a + t * b
template <bool kMotion>
__device__ __forceinline__ void load_tri(const float4* __restrict__ tris0,
                                         const float4* __restrict__ tris1,
                                         int j, float time, float4 v[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = __ldg(tris0 + 3 * j + c);
  if (kMotion) {
    float4 b[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) b[c] = __ldg(tris1 + 3 * j + c);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c].x = (1.0f - time) * v[c].x + time * b[c].x;
      v[c].y = (1.0f - time) * v[c].y + time * b[c].y;
      v[c].z = (1.0f - time) * v[c].z + time * b[c].z;
    }
  }
}

// moller_trumbore against the triangle (p0, e1 = p1 - p0, e2 = p2 - p0):
// the hit's t, u, v when it is valid and strictly closer than best_t
__device__ __forceinline__ bool tri_test_edges(
    const float p0[3], const float e1[3], const float e2[3], const float o[3],
    const float d[3], float mn, float mx, float best_t, float* t_out,
    float* u_out, float* v_out) {
  const float s[3] = {o[0] - p0[0], o[1] - p0[1], o[2] - p0[2]};
  const float s1x = d[1] * e2[2] - d[2] * e2[1];
  const float s1y = d[2] * e2[0] - d[0] * e2[2];
  const float s1z = d[0] * e2[1] - d[1] * e2[0];
  const float div = s1x * e1[0] + s1y * e1[1] + s1z * e1[2];
  const float clamped = fabsf(div) < 1e-12f ? (div < 0.0f ? -1e-12f : 1e-12f)
                                            : div;
  const float inv_div = 1.0f / clamped;
  const float u = (s[0] * s1x + s[1] * s1y + s[2] * s1z) * inv_div;
  const float s2x = s[1] * e1[2] - s[2] * e1[1];
  const float s2y = s[2] * e1[0] - s[0] * e1[2];
  const float s2z = s[0] * e1[1] - s[1] * e1[0];
  const float w = (d[0] * s2x + d[1] * s2y + d[2] * s2z) * inv_div;
  const float t = (e2[0] * s2x + e2[1] * s2y + e2[2] * s2z) * inv_div;
  *t_out = t;
  *u_out = u;
  *v_out = w;
  return div != 0.0f && u >= 0.0f && w >= 0.0f && u + w <= 1.0f && t >= mn &&
         t <= mx && t < best_t;
}

// tri_test_edges against the vertices v (load_tri's)
__device__ __forceinline__ bool tri_test(const float4 v[3], const float o[3],
                                         const float d[3], float mn, float mx,
                                         float best_t, float* t_out,
                                         float* u_out, float* v_out) {
  const float p0[3] = {v[0].x, v[0].y, v[0].z};
  const float e1[3] = {v[1].x - v[0].x, v[1].y - v[0].y, v[1].z - v[0].z};
  const float e2[3] = {v[2].x - v[0].x, v[2].y - v[0].y, v[2].z - v[0].z};
  return tri_test_edges(p0, e1, e2, o, d, mn, mx, best_t, t_out, u_out,
                        v_out);
}

}  // namespace
