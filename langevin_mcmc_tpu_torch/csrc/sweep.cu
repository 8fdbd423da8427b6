// Culled-sweep ray/triangle intersection for Hopper (sm_90a): walk_kernel
// (csrc/walk.cuh) over 512-triangle chunks.
//
// Replaces the Pallas TPU kernel langevin_mcmc_tpu/ops/pallas_isect.py::
// _isect_kernel in both of its variants, closest hit (any_hit=0, used by
// intersect_sweep) and any hit (any_hit=1, used by occluded_sweep),
// together with the torch stage that fed it its per-(block, chunk) visit
// mask (_chunk_mask). The contract is _chunk_mask followed by
// sweep_reference (langevin_mcmc_tpu_torch/ops/sweep_isect.py), which the
// CPU tests and chip_smoke.py hold this kernel against.
//
// The TPU kernel runs a grid of (256-ray block x 512-triangle chunk) with
// the chunk axis innermost and in order, accumulating the closest hit in
// its output block and skipping the chunks the mask clears; its any hit
// computes only while some ray of the block is unhit. Here the chunk axis
// is a loop inside the CTA, split into ranges across CTAs and merged in
// order (walk.cuh). Three things differ from the chunk walk's forms:
//  * a chunk is four 128-triangle tiles of the ring, and the running best
//    carries the 512-triangle chunk index, so a tie on t between two tiles
//    of one chunk goes to the smaller id, one between chunks to the
//    earlier chunk, as in the TPU kernel;
//  * the mask slab-tests dead rays like any other (_chunk_mask has no
//    alive term, unlike _block_chunk_lists), so it equals the JAX
//    package's mask;
//  * the rays come sorted without a dead-last key (sweep_isect.py).
// Per-ray early exit of any hit gives the same occlusion as the TPU
// kernel's block-wide gate.

#include "walk.cuh"

namespace {

struct Sweep {
  static constexpr int kChunk = 512;
  static constexpr bool kResident = false;
  static constexpr bool kListAlive = false;
};

}  // namespace

// Plain C entry point (bound with ctypes); launch_walk (walk.cuh) gives the
// arguments.
extern "C" int sweep_walk(
    const float* pack, const int* ids, const float* chunk_lo,
    const float* chunk_hi, const float* org, const float* dir,
    const float* rng, int num_blocks, int num_chunks, int splits,
    int any_hit, float* part_t, int* part_id, float* part_u, float* part_v,
    float* t, int* id, float* u, float* v, unsigned char* occluded,
    unsigned char* chunk_mask, void* stream) {
  return launch_walk<Sweep>(pack, ids, chunk_lo, chunk_hi, org, dir, rng,
                            num_blocks, num_chunks, splits, any_hit, part_t,
                            part_id, part_u, part_v, t, id, u, v, occluded,
                            chunk_mask, stream);
}
