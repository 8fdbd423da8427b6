// The ray walk over chunked triangle packs for Hopper (sm_90a), shared by
// csrc/chunkwalk.cu (the chunk walk: K1/K2 staged, K3 resident) and
// csrc/sweep.cu (the culled sweep, K4). Each source includes it and
// instantiates walk_kernel with its Form; everything here is in an
// anonymous namespace, so each source gets its own copy.
//
// The function. Rays come in 256-ray blocks (sorted and padded by the
// caller). A block tests its rays against the chunks (Form::kChunk
// triangles each, packed as [16, kChunk] f32 rows: Woop inverse frame 0-8,
// translation 9-11, valid 12, with int32 ids beside them) whose AABB one of
// its rays crosses, in ascending chunk order. Every ray is projected into
// each triangle frame:
//   t = -Ow / Qw,  u = Ou + t Qu,  v = Ov + t Qv,
// a hit needing |Qw| >= 1e-12, u, v >= 0, u + v <= 1, t in [min_t, max_t]
// and a valid triangle. Within a chunk the smallest t wins and ties go to
// the smallest id; across chunks a later chunk must be strictly closer.
// Closest hit returns (t, id, u, v), t = 3e38 and id = -1 where nothing is
// hit; any hit returns occluded.
//
// What bounds it on this card, and what the design does:
//  * Instruction rate. A test is 40 f32 operations that no FMA may fuse
//    (the result must round as torch does) plus an IEEE division and the
//    compares: about 60 instructions a test, on operands every ray of a
//    block shares. Bytes do not bound it: a 128-triangle tile is 7 KB (13
//    rows and the ids), read once per CTA from L2. Each thread owns one
//    ray and reads 4 triangles' rows at once as float4 broadcasts (13 loads
//    feed 4 tests); the loop has no branch per triangle or per ray (a dead
//    ray or an invalid triangle fails the test anyway) and no clamped
//    divisor (a tiny Qw fails the test whatever t is).
//  * Filling 132 SMs. One CTA per ray block (256 CTAs at 65,536 rays, 17 at
//    a 4,261-ray large step) leaves most of the card idle and ends with the
//    block of the longest list. So each block's chunk ids are cut into
//    `splits` contiguous ranges and one CTA walks one (block, range); the
//    wrapper sizes splits from the number of blocks. Closest hit writes a
//    partial (t, id, u, v) per range and merge_kernel takes the ranges in
//    ascending order with a strict <, which is the across-chunk rule since
//    the ranges are in ascending chunk order. Any hit ORs straight into the
//    zeroed output, and a range also reads the flags other ranges set, so
//    it stops once all of its rays are occluded by any range; a warp whose
//    rays are all done leaves the tile. Per-ray early exit gives the same
//    occlusion as the TPU kernels' block-wide gates.
//  * The chunk lists. The CTA slab-tests its 256 rays against the AABBs of
//    its range with the f32 operations of the torch stage that fed the TPU
//    kernel (_block_chunk_lists, or the sweep's _chunk_mask), in its order,
//    NaN propagating as torch.minimum / amax do; ORs per chunk by warp
//    ballot into a shared bit mask; and compacts the set bits into an
//    ascending list (blocklist.cuh, shared with the brute force): no
//    [R, K, 3] temporaries, argsort or list tensors.
//  * The rows, by Form::kResident:
//    - staged: tiles of 128 triangles arrive through a ring of two
//      shared-memory buffers filled by cp.async, tile j + 1 in flight while
//      tile j is tested, one barrier per tile. A chunk of 512 triangles is
//      four tiles, so the ring stays in static shared memory. Every copy is
//      waited for before its buffer is reused and before the CTA exits, the
//      any-hit early exit included (leaving a prefetch in flight was a
//      fault of the TPU kernel).
//    - resident: rows are read straight from global memory as float4
//      through the read-only path (__ldg): a pack of a few MB stays in the
//      50 MB L2 and a warp's threads read one address, a broadcast. There
//      is no barrier in the walk, so warps leave on their own.
//    The tile is 128 triangles in both; the running best carries the chunk
//    index, so ties follow the chunk, not the tile: within a chunk the
//    least (t, id), across chunks a strict <.
//
// Rounding. Built with --fmad=false, every product and sum is rounded on
// its own, in the same order as the torch version, so the two agree
// exactly.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "blocklist.cuh"

namespace {

constexpr int kRayBlock = 256;
constexpr int kTile = 128;       // triangles staged (or read) at a time
constexpr int kPackRows = 16;    // rows of a chunk in the pack
constexpr int kRows = 13;        // rows a test reads: frame, translation, valid
constexpr int kMaxRange = 1024;  // chunks in one range at most
constexpr int kStages = 2;       // shared-memory tile buffers of the ring
// CTAs an SM must hold: at most 80 registers a thread. Left to itself
// ptxas gives the sweep form 102 and two CTAs an SM, 9% slower
// (walk_designs.py); the other forms take 80 either way.
constexpr int kCtasPerSm = 3;
constexpr float kBig = 3.0e38f;

struct Stage {
  float4 rows[kRows * kTile / 4];  // row m of triangles 4g..4g+3: [m*32+g]
  int4 ids[kTile / 4];
};

// Start the copies of tile `sub` (triangles 128 sub .. 128 sub + 127) of
// chunk cid of a pack of Chunk-triangle chunks: rows 0-12 and ids, 448 x 16
// bytes.
template <int Chunk>
__device__ __forceinline__ void stage_tile(Stage& st, const float* pack,
                                           const int* ids, int cid, int sub,
                                           int tid) {
  constexpr int kRowVecs = kRows * kTile / 4;
  constexpr int kVecs = kRowVecs + kTile / 4;
  const float* rows =
      pack + static_cast<int64_t>(cid) * kPackRows * Chunk + sub * kTile;
  const int* tri_ids = ids + static_cast<int64_t>(cid) * Chunk + sub * kTile;
  for (int e = tid; e < kVecs; e += kRayBlock) {
    if (e < kRowVecs) {
      // float4 e % 32 of row e / 32
      cp_async16(&st.rows[e],
                 rows + (e / (kTile / 4)) * Chunk + 4 * (e % (kTile / 4)));
    } else {
      cp_async16(&st.ids[e - kRowVecs], tri_ids + 4 * (e - kRowVecs));
    }
  }
}

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// id k of a tile: from global memory (resident) or the ring
template <bool Resident>
__device__ __forceinline__ int tile_id(const int* tri_ids, int k) {
  if constexpr (Resident) {
    return __ldg(tri_ids + k);
  } else {
    return tri_ids[k];
  }
}

// Form: kChunk, triangles per chunk (a multiple of kTile); kResident, rows
// read from global memory instead of the ring; kListAlive, whether a dead
// ray (not max_t >= min_t) is left out of the chunk lists (the chunk walk)
// or slab-tested like any other (the sweep's mask).
//
// Closest hit writes (t, id, u, v) of its range to out_* [splits, rays];
// any hit ORs into out_occ. chunk_mask is a test hook: null on every
// render path, else [blocks, num_chunks] bytes that receive the block's
// chunk hit set, so the card tests can hold it against the torch stage.
template <class Form, bool AnyHit>
__global__ void __launch_bounds__(kRayBlock, kCtasPerSm)
walk_kernel(const float* __restrict__ pack, const int* __restrict__ ids,
            const float* __restrict__ chunk_lo,
            const float* __restrict__ chunk_hi, const float* __restrict__ org,
            const float* __restrict__ dir, const float* __restrict__ rng,
            int num_chunks, int splits, int64_t num_rays,
            float* __restrict__ out_t, int* __restrict__ out_id,
            float* __restrict__ out_u, float* __restrict__ out_v,
            unsigned char* out_occ, unsigned char* __restrict__ chunk_mask) {
  constexpr int kSub = Form::kChunk / kTile;  // tiles per chunk
  // the resident form reads no ring (one unused buffer keeps C++ happy)
  __shared__ Stage s_stage[Form::kResident ? 1 : kStages];
  __shared__ int s_list[kMaxRange];
  __shared__ unsigned s_mask[kMaxRange / 32];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / splits;
  const int s = blockIdx.x % splits;
  const int c0 = static_cast<int>(static_cast<int64_t>(s) * num_chunks / splits);
  const int c1 =
      static_cast<int>(static_cast<int64_t>(s + 1) * num_chunks / splits);
  const int len = c1 - c0;

  const int64_t r = static_cast<int64_t>(b) * kRayBlock + tid;
  const float ox = org[3 * r + 0], oy = org[3 * r + 1], oz = org[3 * r + 2];
  const float dx = dir[3 * r + 0], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
  const float mn = rng[2 * r + 0], mx = rng[2 * r + 1];
  // dead rays (not max_t >= min_t) fail every test; any hit counts them
  // as done
  const bool alive = mx >= mn;

  // 1. this range's part of the block's chunk list
  list_clear<kRayBlock>(s_mask, len, tid);
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
      float tn, tf;
      slab(lx, ly, lz, hx, hy, hz, ox, oy, oz, ix, iy, iz, &tn, &tf);
      const bool hit = tn <= tf && tf >= mn && tn <= mx &&
                       (alive || !Form::kListAlive);
      list_mark(s_mask, c - c0, hit);
    }
  }
  __syncthreads();
  const int n = list_compact<kRayBlock>(s_mask, len, c0, s_list, tid);
  if (chunk_mask != nullptr) {
    for (int k = tid; k < len; k += kRayBlock) {
      chunk_mask[static_cast<int64_t>(b) * num_chunks + c0 + k] =
          list_bit(s_mask, k);
    }
  }
  __syncthreads();

  // 2. the walk over the list's tiles (kSub a chunk)
  const int tiles = n * kSub;
  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1, best_cid = -1;
  bool occ = false, stored = false, seen = false;

  if constexpr (!Form::kResident) {
#pragma unroll
    for (int q = 0; q < kStages - 1; ++q) {
      if (q < tiles) {
        stage_tile<Form::kChunk>(s_stage[q], pack, ids, s_list[q / kSub],
                                 q % kSub, tid);
      }
      cp_async_commit();
    }
  }
  for (int j = 0; j < tiles; ++j) {
    if constexpr (Form::kResident) {
      if (AnyHit) {
        occ |= seen;
        stored |= seen;
        // no barrier in this walk: a warp whose rays are all done leaves
        if (__all_sync(0xffffffffu, occ || !alive)) break;
      }
    } else {
      cp_async_wait<kStages - 2>();  // my copies of tile j
      if (AnyHit) {
        occ |= seen;
        stored |= seen;
        // every thread reaches this barrier: n is uniform in the CTA
        if (__syncthreads_and(occ || !alive)) break;
      } else {
        __syncthreads();
      }
      // into the buffer tile j - 1 was read from, which every thread has
      // left (the barrier above)
      const int nxt = j + kStages - 1;
      if (nxt < tiles) {
        stage_tile<Form::kChunk>(s_stage[nxt % kStages], pack, ids,
                                 s_list[nxt / kSub], nxt % kSub, tid);
      }
      cp_async_commit();
    }
    if (AnyHit) {
      // the flag another range set, read now and used at the next tile
      seen = !occ && alive && __ldcg(out_occ + r) != 0;
    }
    const int cid = s_list[j / kSub];
    // float4 g of row m of the tile is rows[m * kStride + g]
    const float4* rows;
    const int* tri_ids;
    constexpr int kStride = (Form::kResident ? Form::kChunk : kTile) / 4;
    if constexpr (Form::kResident) {
      rows = reinterpret_cast<const float4*>(
          pack + static_cast<int64_t>(cid) * kPackRows * Form::kChunk +
          (j % kSub) * kTile);
      tri_ids = ids + static_cast<int64_t>(cid) * Form::kChunk +
                (j % kSub) * kTile;
    } else {
      rows = s_stage[j % kStages].rows;
      tri_ids = reinterpret_cast<const int*>(s_stage[j % kStages].ids);
    }
#pragma unroll 1
    for (int g = 0; g < kTile / 4; ++g) {
      // a warp whose rays are all done leaves the tile
      if (AnyHit && __all_sync(0xffffffffu, occ || !alive)) break;
      float4 p[kRows];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        if constexpr (Form::kResident) {
          p[m] = __ldg(rows + m * kStride + g);
        } else {
          p[m] = rows[m * kStride + g];
        }
      }
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
            id = tile_id<Form::kResident>(tri_ids, k);
          } else if (t == best_t && cid == best_cid) {
            id = tile_id<Form::kResident>(tri_ids, k);
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
  if constexpr (!Form::kResident) {
    cp_async_wait<0>();  // no copy outlives the CTA, early exit included
  }

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

// The launches of one form: walk_kernel on num_blocks * splits CTAs, then
// (closest hit, splits > 1) merge_kernel. Rays are padded to whole 256-ray
// blocks by the caller; every pointer is device memory; the launches go on
// `stream`. splits: chunk ranges per ray block, at least
// ceil(num_chunks / 1024). Closest hit (any_hit = 0) writes t, id, u, v
// [rays], through part_* [splits, rays] scratch when splits > 1; any hit
// ORs into occluded [rays], zeroed by the caller. chunk_mask: null on the
// render paths; a test hook, else [num_blocks, num_chunks] bytes that
// receive the blocks' chunk hit sets. Returns cudaGetLastError() of the
// launches (cudaErrorInvalidValue for arguments the kernel does not take).
template <class Form>
int launch_walk(const float* pack, const int* ids, const float* chunk_lo,
                const float* chunk_hi, const float* org, const float* dir,
                const float* rng, int num_blocks, int num_chunks, int splits,
                int any_hit, float* part_t, int* part_id, float* part_u,
                float* part_v, float* t, int* id, float* u, float* v,
                unsigned char* occluded, unsigned char* chunk_mask,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || static_cast<int64_t>(splits) * kMaxRange < num_chunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_blocks == 0) return static_cast<int>(cudaGetLastError());
  const int64_t num_rays = static_cast<int64_t>(num_blocks) * kRayBlock;
  const unsigned grid = static_cast<unsigned>(num_blocks) * splits;
  if (any_hit) {
    walk_kernel<Form, true><<<grid, kRayBlock, 0, s>>>(
        pack, ids, chunk_lo, chunk_hi, org, dir, rng, num_chunks, splits,
        num_rays, nullptr, nullptr, nullptr, nullptr, occluded, chunk_mask);
    return static_cast<int>(cudaGetLastError());
  }
  const bool merge = splits > 1;
  walk_kernel<Form, false><<<grid, kRayBlock, 0, s>>>(
      pack, ids, chunk_lo, chunk_hi, org, dir, rng, num_chunks, splits,
      num_rays, merge ? part_t : t, merge ? part_id : id, merge ? part_u : u,
      merge ? part_v : v, nullptr, chunk_mask);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return static_cast<int>(err);
  merge_kernel<<<static_cast<unsigned>((num_rays + 255) / 256), 256, 0, s>>>(
      part_t, part_id, part_u, part_v, splits, num_rays, t, id, u, v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
