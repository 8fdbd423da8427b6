// Chunk-walk ray/triangle intersection for Hopper (sm_90a): two forms of
// walk_kernel (csrc/walk.cuh) over 128-triangle chunks, each with a
// closest-hit (any_hit=0, intersect_chunkwalk) and an any-hit (any_hit=1,
// occluded_chunkwalk) variant.
//  * Staged (K1/K2) replaces the Pallas TPU kernel _walk_kernel
//    (langevin_mcmc_tpu/ops/chunkwalk.py:157, chunks fetched from HBM one
//    by one): rows pass through a cp.async ring in shared memory.
//  * Resident (K3) replaces _walk_kernel_resident (chunkwalk.py:280, the
//    whole pack held in fast memory): rows are read straight from global
//    memory (__ldg), the pack staying in L2.
// Both also replace the torch stage that fed the TPU kernel its per-block
// chunk lists (_block_chunk_lists): the kernel builds them, leaving dead
// rays out as that stage does. Their contract is _block_chunk_lists
// followed by walk_reference (langevin_mcmc_tpu_torch/ops/chunkwalk.py).
// walk.cuh says what bounds them on this card and what the design does.

#include "walk.cuh"

namespace {

struct Staged {
  static constexpr int kChunk = 128;
  static constexpr bool kResident = false;
  static constexpr bool kListAlive = true;
};

struct Resident {
  static constexpr int kChunk = 128;
  static constexpr bool kResident = true;
  static constexpr bool kListAlive = true;
};

}  // namespace

// Plain C entry points (bound with ctypes); launch_walk (walk.cuh) gives
// the arguments.
extern "C" int chunkwalk_staged(
    const float* pack, const int* ids, const float* chunk_lo,
    const float* chunk_hi, const float* org, const float* dir,
    const float* rng, int num_blocks, int num_chunks, int splits,
    int any_hit, float* part_t, int* part_id, float* part_u, float* part_v,
    float* t, int* id, float* u, float* v, unsigned char* occluded,
    unsigned char* chunk_mask, void* stream) {
  return launch_walk<Staged>(pack, ids, chunk_lo, chunk_hi, org, dir, rng,
                             num_blocks, num_chunks, splits, any_hit, part_t,
                             part_id, part_u, part_v, t, id, u, v, occluded,
                             chunk_mask, stream);
}

extern "C" int chunkwalk_resident(
    const float* pack, const int* ids, const float* chunk_lo,
    const float* chunk_hi, const float* org, const float* dir,
    const float* rng, int num_blocks, int num_chunks, int splits,
    int any_hit, float* part_t, int* part_id, float* part_u, float* part_v,
    float* t, int* id, float* u, float* v, unsigned char* occluded,
    unsigned char* chunk_mask, void* stream) {
  return launch_walk<Resident>(pack, ids, chunk_lo, chunk_hi, org, dir, rng,
                               num_blocks, num_chunks, splits, any_hit,
                               part_t, part_id, part_u, part_v, t, id, u, v,
                               occluded, chunk_mask, stream);
}
