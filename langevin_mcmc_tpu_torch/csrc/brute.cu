// Brute-force ray/triangle intersection for Hopper (sm_90a): closest hit
// (any_hit=0, intersect_bruteforce) and any hit (any_hit=1,
// occluded_bruteforce) over every triangle, on a static or a moving scene
// (kMotion: each vertex lerped between the two keyframes at the ray's
// time).
//
// It replaces no Pallas kernel: the JAX package's brute force
// (langevin_mcmc_tpu/ops/intersect.py:59, intersect_bruteforce) is a
// lax.scan over 1024-triangle chunks that XLA runs as one device loop, and
// it is the query of every moving scene without a BVH. Its contract is the
// plain version _bruteforce_block (langevin_mcmc_tpu_torch/ops/intersect.py)
// over every live ray, which it equals bit for bit: every pair it tests
// runs tri.cuh's test, built with --fmad=false; a ray's hit is the least
// (t, original id) over the pairs whose test passes, which is the plain
// version's rule (the first minimum within a chunk, strict < across
// chunks); t stays inf and id, u, v 0 where nothing is hit.
//
// What bounds it: the f32 operations of the pairs it tests. Testing every
// pair (its first design) cost 1.6e9 tests at the flagship's 65,536
// moving rays, 61 operations each plus 28 to lerp. This design skips the
// pairs whose test cannot pass and tests the rest, under 8% of them there,
// and spends the rest of its time on deciding which (ops/brute_tiles.py
// says why a skipped pair cannot pass, and builds the tables):
//  * the triangles come in 128-triangle tiles, runs of the Morton order
//    of their box centres, each tile with a box over both keyframes padded
//    for the lerp's rounding, its triangles in four groups of 32 like
//    normals, and per shutter bin a normal cone a group (bands) and a
//    normal and a threshold a triangle (screen);
//  * the rays are taken as they come, 128 a block (sorting them first,
//    as the chunk walk does, made the whole query slower at every size
//    measured, brute_designs.py: the pairs are compacted per block, so a
//    block of unrelated rays costs little more). Per tile each ray needs
//    all of it (its slab test against the box, padded by what the rounding
//    of an accepted hit can reach, passes; or it is a ray the bounds do
//    not cover), the triangles of the groups it may graze that its screen
//    keeps, or nothing;
//  * as in walk.cuh, the tiles are split into S ranges across CTAs
//    (intersect.brute_splits), each CTA builds its range's part of the
//    block's list (the tiles some ray of the block needs) by warp ballot
//    into a shared mask compacted in ascending order (blocklist.cuh), and
//    the listed tiles come through a two-buffer cp.async ring;
//  * per listed tile all 128 threads work on the pairs the block's rays
//    need, so that no lane idles beside a lane that tests: thread k (warp
//    g, normal group g) screens triangle k against every grazing ray (a
//    ray that does not graze group g marks nothing) into a bit mask a 32
//    rays, with no atomics and no branch in the loop; a block-wide scan of
//    the masks' counts queues the screened pairs behind the whole-tile
//    ones; then the threads test the pairs in turn. A ray's best (t, id)
//    is one 64-bit key in shared memory taken with atomicMin; its u, v
//    are those of a rerun of the winner's test at the end;
//  * any hit: a ray is done at its first valid test (its t is finite:
//    t >= min_t > -inf and t < inf) and drops out of later tiles; the
//    ranges OR their finds into per-ray flags and read the others', so a
//    ray one range found occluded drops out of the others; a block whose
//    rays are all done or dead leaves. A ray with min_t = -inf needs its
//    least t (a t = -inf makes the plain version's best t infinite, no
//    hit), so it is done only at a t = -inf: flag bit 0 is a finite hit,
//    bit 1 a hit at -inf, and occluded is bit 0 without bit 1.
// walk.cuh's Form does not fit: its loop tests every ray of a block
// against every triangle of a listed tile, one thread a ray, and keeps a
// chunk's running best for ties in chunk order; here a thread takes
// pairs, since most listed tiles are needed by a few rays of the block,
// and ties are decided by the original id across tiles in any order.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "blocklist.cuh"
#include "tri.cuh"

namespace {

constexpr int kRays = 128;       // rays a block, triangles a tile
constexpr int kGroups = 4;       // normal groups a tile, 32 triangles each
constexpr int kMaxTiles = 512;   // tiles in one range at most
constexpr int kQueue = 1024;     // screened pairs a round of the queue
constexpr int kStages = 2;       // tile buffers of the ring
constexpr unsigned long long kMiss = 0xFF800000ull << 32;  // key(inf, 0)

// (t, id) as one key whose unsigned order is the lexicographic order of
// (t, id) (t not NaN; -0 and +0 one key, as t == t' takes them)
__device__ __forceinline__ unsigned long long hit_key(float t, int id) {
  unsigned b = __float_as_uint(t == 0.0f ? 0.0f : t);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(b) << 32) |
         static_cast<unsigned>(id);
}

// the test's edges of a triangle from its rows (static: p0, e1, e2; moving:
// v0, v1, v2 of keyframe 0, then of keyframe 1, lerped at time)
template <bool kMotion>
__device__ __forceinline__ void tri_edges(const float4* row, int stride,
                                          float time, float p0[3],
                                          float e1[3], float e2[3]) {
  if (kMotion) {
    const float a = 1.0f - time;
    float w[3][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4 x = row[c * stride];
      const float4 y = row[(3 + c) * stride];
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
    const float4 x = row[0], y = row[stride], z = row[2 * stride];
    p0[0] = x.x; p0[1] = x.y; p0[2] = x.z;
    e1[0] = y.x; e1[1] = y.y; e1[2] = y.z;
    e2[0] = z.x; e2[1] = z.y; e2[2] = z.z;
  }
}

template <bool kMotion>
__global__ void __launch_bounds__(kRays)
brute_kernel(const float4* __restrict__ tris,
             const float4* __restrict__ screen,
             const float4* __restrict__ tiles,
             const float4* __restrict__ bands,
             const float* __restrict__ tri_p, int num_tris, int num_tiles,
             int num_bins, float kappa, float mu,
             const float* __restrict__ org, const float* __restrict__ dir,
             const float* __restrict__ ray_time,
             const float* __restrict__ min_t,
             const float* __restrict__ max_t, int num_rays, int splits,
             bool any_hit, float* __restrict__ part_t,
             int* __restrict__ part_id, float* __restrict__ part_u,
             float* __restrict__ part_v, int* flags) {
  constexpr int kRows = kMotion ? 6 : 3;
  // row c of triangle k of a tile at [c * kRays + k]
  __shared__ float4 s_tile[kStages][kRows * kRays];
  __shared__ float4 s_o[kRays];   // origin, min_t
  __shared__ float4 s_d[kRays];   // direction, max_t
  __shared__ float s_time[kRays];
  __shared__ unsigned long long s_key[kRays];
  __shared__ int s_bits[kRays];
  __shared__ int s_rays[kRays];   // a tile's rays: whole-tile, then grazing
  // the grazing rays' unit direction, and bin | grazed groups << 8 (bits)
  __shared__ float4 s_graze[kRays];
  __shared__ int s_queue[kQueue];  // screened pairs: ray << 8 | triangle
  __shared__ int s_warp[kRays / 32][3];
  __shared__ int s_list[kMaxTiles];
  __shared__ unsigned s_mask[kMaxTiles / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int b = blockIdx.x / splits;
  const int s = blockIdx.x % splits;
  const int c0 = static_cast<int>(static_cast<int64_t>(s) * num_tiles / splits);
  const int c1 =
      static_cast<int>(static_cast<int64_t>(s + 1) * num_tiles / splits);
  const int64_t tp = static_cast<int64_t>(num_tiles) * kRays;

  const int r = b * kRays + tid;
  const bool in = r < num_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tm = 0.f, mn = 0.f, mx = -1.f;
  if (in) {
    ox = __ldg(org + 3 * r); oy = __ldg(org + 3 * r + 1);
    oz = __ldg(org + 3 * r + 2);
    dx = __ldg(dir + 3 * r); dy = __ldg(dir + 3 * r + 1);
    dz = __ldg(dir + 3 * r + 2);
    if (kMotion) tm = __ldg(ray_time + r);
    mn = __ldg(min_t + r);
    mx = __ldg(max_t + r);
  }
  // brute_tiles.ray_terms: the rays the bounds cover, the rest full
  const bool alive = mx >= mn;
  const float dmax = fmaxf(fmaxf(fabsf(dx), fabsf(dy)), fabsf(dz));
  bool ok = isfinite(ox) && isfinite(oy) && isfinite(oz) && isfinite(dx) &&
            isfinite(dy) && isfinite(dz) && mn > -CUDART_INF_F &&
            dmax >= 0.5f && dmax <= 2.0f;
  if (kMotion) ok = ok && tm >= 0.0f && tm <= 1.0f;
  const bool full = alive && !ok;
  const int bin =
      kMotion && ok ? min(static_cast<int>(tm * num_bins), num_bins - 1) : 0;
  const float norm = sqrtf(dx * dx + dy * dy + dz * dz);
  const float hx = dx / norm, hy = dy / norm, hz = dz / norm;
  const float ix = 1.0f / safe_dir(dx);
  const float iy = 1.0f / safe_dir(dy);
  const float iz = 1.0f / safe_dir(dz);
  const float onorm = fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz));
  // any hit: the flag bits that end a ray (a -inf min_t needs bit 1)
  const int stop = mn > -CUDART_INF_F ? 3 : 2;
  s_o[tid] = make_float4(ox, oy, oz, mn);
  s_d[tid] = make_float4(dx, dy, dz, mx);
  s_time[tid] = tm;
  s_key[tid] = kMiss;
  s_bits[tid] = 0;

  // brute_tiles.tile_need: the whole tile, or the normal groups (bits) my
  // ray may graze
  auto need = [&](int c, bool live, bool* whole, int* graze) {
    const float4 lo = __ldg(tiles + 3 * c);
    const float4 hi = __ldg(tiles + 3 * c + 1);
    const float4 ce = __ldg(tiles + 3 * c + 2);
    const float dist = fabsf(ox - ce.x) + fabsf(oy - ce.y) +
                       fabsf(oz - ce.z) + lo.w;
    const float pad = kappa * dist + mu * (onorm + hi.w);
    float tn, tf;
    slab(lo.x - pad, lo.y - pad, lo.z - pad, hi.x + pad, hi.y + pad,
         hi.z + pad, ox, oy, oz, ix, iy, iz, &tn, &tf);
    *whole = live && (full || (tn <= tf && tf >= mn && tn <= mx));
    const float4* ax =
        bands + (static_cast<int64_t>(bin) * num_tiles + c) * kGroups;
    int g = 0;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const float4 a = __ldg(ax + q);
      g |= (fabsf(hx * a.x + hy * a.y + hz * a.z) < a.w) << q;
    }
    *graze = live && !*whole ? g : 0;
  };

  // 1. this range's part of the block's tile list
  list_clear<kRays>(s_mask, c1 - c0, tid);
  __syncthreads();
  for (int c = c0; c < c1; ++c) {
    bool whole;
    int graze;
    need(c, alive, &whole, &graze);
    list_mark(s_mask, c - c0, whole || graze != 0);
  }
  __syncthreads();
  const int n_list = list_compact<kRays>(s_mask, c1 - c0, c0, s_list, tid);
  __syncthreads();

  // 2. the listed tiles through the ring
  auto stage = [&](int q, int c) {
    const float4* from = tris + static_cast<int64_t>(c) * kRays * kRows;
    for (int e = tid; e < kRows * kRays; e += kRays) {
      cp_async16(&s_tile[q][(e % kRows) * kRays + e / kRows], from + e);
    }
  };
  if (n_list > 0) stage(0, s_list[0]);
  cp_async_commit();
  int written = 0;
  for (int j = 0; j < n_list; ++j) {
    cp_async_wait<0>();  // my copies of tile j
    bool done = !alive;
    if (any_hit) {
      const int seen = alive ? __ldcg(flags + r) : 0;
      const int mine = s_bits[tid];  // at worst a tile late
      if (mine & ~written) {
        atomicOr(flags + r, mine);
        written |= mine;
      }
      done = done || ((mine | seen) & stop) != 0;
      if (__syncthreads_and(done)) break;
    } else {
      __syncthreads();
    }
    // into the buffer tile j - 1 came from, which every thread has left
    if (j + 1 < n_list) stage((j + 1) % kStages, s_list[j + 1]);
    cp_async_commit();
    const int c = s_list[j];
    const int base = c * kRays;
    const int n = min(kRays, num_tris - base);
    bool whole;
    int graze;
    need(c, !done, &whole, &graze);
    // the tile's rays: whole ones first, then grazing ones
    const unsigned mw = __ballot_sync(0xffffffffu, whole);
    const unsigned mg = __ballot_sync(0xffffffffu, graze != 0);
    if (lane == 0) {
      s_warp[warp][0] = __popc(mw);
      s_warp[warp][1] = __popc(mg);
    }
    __syncthreads();
    int hw = 0, hg = 0, before_w = 0, before_g = 0;
#pragma unroll
    for (int w = 0; w < kRays / 32; ++w) {
      if (w < warp) {
        before_w += s_warp[w][0];
        before_g += s_warp[w][1];
      }
      hw += s_warp[w][0];
      hg += s_warp[w][1];
    }
    if (whole) s_rays[before_w + __popc(mw & lt)] = tid;
    if (graze != 0) {
      const int i = before_g + __popc(mg & lt);
      s_rays[hw + i] = tid;
      s_graze[i] = make_float4(hx, hy, hz, __int_as_float(bin | graze << 8));
    }
    __syncthreads();
    // the screen: thread k takes triangle k (warp w, normal group w) and
    // marks the grazing rays that may graze it, 32 rays a mask word
    unsigned m[kRays / 32];
    const float4* scr = screen + base + tid;
#pragma unroll
    for (int q = 0; q < kRays / 32; ++q) {
      m[q] = 0u;
      const int cnt = min(32, hg - 32 * q);
#pragma unroll 8
      for (int i = 0; i < cnt; ++i) {
        const float4 h = s_graze[32 * q + i];
        const int bits = __float_as_int(h.w);
        // read whether the ray grazes the group or not: the loads of
        // several rays are then in flight at once
        const float4 sc =
            __ldg(scr + static_cast<int64_t>(bits & 0xff) * tp);
        const bool hit = ((bits >> (8 + warp)) & 1) && tid < n &&
                         fabsf(h.x * sc.x + h.y * sc.y + h.z * sc.z) < sc.w;
        m[q] |= static_cast<unsigned>(hit) << i;
      }
    }
    // queue the marked pairs: a block-wide exclusive scan of the counts
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < kRays / 32; ++q) cnt += __popc(m[q]);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s_warp[warp][2] = incl;
    __syncthreads();
    int queued = 0, first = incl - cnt;
#pragma unroll
    for (int w = 0; w < kRays / 32; ++w) {
      if (w < warp) first += s_warp[w][2];
      queued += s_warp[w][2];
    }
    // the whole-tile pairs, then the queue in rounds of kQueue pairs
    const float4* tile = s_tile[j % kStages];
    for (int r0 = 0; r0 == 0 || r0 < queued; r0 += kQueue) {
      int at = first;
#pragma unroll
      for (int q = 0; q < kRays / 32; ++q) {
        for (unsigned mm = m[q]; mm != 0u; mm &= mm - 1u, ++at) {
          if (at >= r0 && at < r0 + kQueue) {
            s_queue[at - r0] =
                (s_rays[hw + 32 * q + __ffs(mm) - 1] << 8) | tid;
          }
        }
      }
      __syncthreads();
      const int pairs_whole = r0 == 0 ? hw * n : 0;
      const int pairs = pairs_whole + min(kQueue, queued - r0);
      for (int p = tid; p < pairs; p += kRays) {
        int rr, k;
        if (p < pairs_whole) {
          const int i = p / n;
          rr = s_rays[i];
          k = p - i * n;
        } else {
          const int e = s_queue[p - pairs_whole];
          rr = e >> 8;
          k = e & 0xff;
        }
        const float4 o4 = s_o[rr], d4 = s_d[rr];
        const float o[3] = {o4.x, o4.y, o4.z}, d[3] = {d4.x, d4.y, d4.z};
        float p0[3], e1[3], e2[3];
        tri_edges<kMotion>(tile + k, kRays, s_time[rr], p0, e1, e2);
        float t, u, v;
        if (tri_test_edges(p0, e1, e2, o, d, o4.w, d4.w, CUDART_INF_F, &t,
                           &u, &v)) {
          if (any_hit) {
            atomicOr(&s_bits[rr], t == -CUDART_INF_F ? 2 : 1);
          } else {
            atomicMin(&s_key[rr], hit_key(t, __float_as_int(tile[k].w)));
          }
        }
      }
      __syncthreads();  // the queue is read before its next round
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA, early exit included
  __syncthreads();
  if (!in) return;
  if (any_hit) {
    const int mine = s_bits[tid];
    if (mine & ~written) atomicOr(flags + r, mine);
    return;
  }
  // the winner's t, u, v: its test again, on the scene's own rows
  const unsigned long long key = s_key[tid];
  float t = CUDART_INF_F, u = 0.f, v = 0.f;
  int id = 0;
  if (key != kMiss) {
    id = static_cast<int>(key & 0xffffffffu);
    const float* p = tri_p + 9 * static_cast<int64_t>(id);
    const float* q = p + 9 * static_cast<int64_t>(num_tris);
    float4 row[6];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      row[c] = make_float4(p[3 * c], p[3 * c + 1], p[3 * c + 2], 0.f);
      row[3 + c] = make_float4(q[3 * c], q[3 * c + 1], q[3 * c + 2], 0.f);
    }
    if (!kMotion) {
      row[1] = make_float4(row[1].x - row[0].x, row[1].y - row[0].y,
                           row[1].z - row[0].z, 0.f);
      row[2] = make_float4(row[2].x - row[0].x, row[2].y - row[0].y,
                           row[2].z - row[0].z, 0.f);
    }
    const float o[3] = {ox, oy, oz}, d[3] = {dx, dy, dz};
    float p0[3], e1[3], e2[3];
    tri_edges<kMotion>(row, 1, tm, p0, e1, e2);
    tri_test_edges(p0, e1, e2, o, d, mn, mx, CUDART_INF_F, &t, &u, &v);
  }
  // one range writes the query's outputs, several their partials
  const int64_t i = splits > 1 ? static_cast<int64_t>(s) * num_rays + r : r;
  part_t[i] = t;
  part_id[i] = id;
  part_u[i] = u;
  part_v[i] = v;
}

// Per ray, the least (t, id) over the S ranges' partial bests [S, R].
__global__ void merge_least(const float* __restrict__ part_t,
                            const int* __restrict__ part_id,
                            const float* __restrict__ part_u,
                            const float* __restrict__ part_v, int splits,
                            int num_rays, float* __restrict__ t,
                            int* __restrict__ id, float* __restrict__ u,
                            float* __restrict__ v) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= num_rays) return;
  float bt = part_t[r];
  int bi = part_id[r], best = 0;
  for (int s = 1; s < splits; ++s) {
    const int64_t k = static_cast<int64_t>(s) * num_rays + r;
    const float x = part_t[k];
    const int i = part_id[k];
    if (x < bt || (x == bt && i < bi)) {
      bt = x;
      bi = i;
      best = s;
    }
  }
  const int64_t k = static_cast<int64_t>(best) * num_rays + r;
  t[r] = bt;
  id[r] = bi;
  u[r] = part_u[k];
  v[r] = part_v[k];
}

}  // namespace

// Plain C entry point (bound with ctypes by ops/cuda_build.py). The tables
// of ops/brute_tiles.py: tris [K * 128, 3 or 6, 4], screen [bins, K * 128,
// 4], tiles [K, 3, 4], bands [bins, K, 4, 4] (f32), with their kappa and
// mu; the scene's triangles tri_p [2, T, 3, 3] (the winners' rows); rays
// org / dir [R, 3], time / min_t / max_t [R] (time read when motion);
// S tile ranges (1 <= S <= K, K <= 512 S). The closest hit (any_hit =
// 0) writes t (inf on a miss), id, u, v [R], through the partial bests
// part_* [S, R] when S > 1; the any hit ORs into flags [R] int32, zeroed
// by the caller (bit 0 a finite hit, bit 1 one at -inf). Returns
// cudaGetLastError() of the launches (cudaErrorInvalidValue for arguments
// it does not take).
extern "C" int brute_force(const float* tris, const float* screen,
                           const float* tiles, const float* bands,
                           const float* tri_p, int num_tris, int num_tiles,
                           int num_bins, float kappa, float mu,
                           const float* org, const float* dir,
                           const float* time, const float* min_t,
                           const float* max_t, int num_rays, int splits,
                           int motion, int any_hit,
                           float* part_t, int* part_id, float* part_u,
                           float* part_v, float* t, int* id, float* u,
                           float* v, int* flags, void* stream) {
  if (splits < 1 || splits > num_tiles ||
      static_cast<int64_t>(splits) * kMaxTiles < num_tiles ||
      num_tris > num_tiles * kRays || num_tris < 1 || num_bins < 1 ||
      num_bins > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rays <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool merge = !any_hit && splits > 1;
  const unsigned grid =
      static_cast<unsigned>((num_rays + kRays - 1) / kRays) * splits;
#define LMCMC_BRUTE_ARGS                                                      \
  reinterpret_cast<const float4*>(tris),                                      \
      reinterpret_cast<const float4*>(screen),                                \
      reinterpret_cast<const float4*>(tiles),                                 \
      reinterpret_cast<const float4*>(bands), tri_p, num_tris, num_tiles,     \
      num_bins, kappa, mu, org, dir, time, min_t, max_t, num_rays,            \
      splits, any_hit != 0, merge ? part_t : t, merge ? part_id : id,         \
      merge ? part_u : u, merge ? part_v : v, flags
  if (motion) {
    brute_kernel<true><<<grid, kRays, 0, st>>>(LMCMC_BRUTE_ARGS);
  } else {
    brute_kernel<false><<<grid, kRays, 0, st>>>(LMCMC_BRUTE_ARGS);
  }
#undef LMCMC_BRUTE_ARGS
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return static_cast<int>(err);
  merge_least<<<(num_rays + 255) / 256, 256, 0, st>>>(
      part_t, part_id, part_u, part_v, splits, num_rays, t, id, u, v);
  return static_cast<int>(cudaGetLastError());
}
