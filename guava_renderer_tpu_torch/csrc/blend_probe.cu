// K1p: the forward tile blend with a count of the rounds each tile ran (the
// early-exit probe).
//
// Replaces guava_renderer_tpu/ops/gsplat.py:blend_probe, which is the TPU's
// forward blend (_fwd_kernel) called with emit_counts=True: each tile runs
// its while loop over chunks of `chunk` instances, stops once every pixel
// is done (tested every `exit_every` chunks; 0 never stops early) and
// writes how many chunks it ran. The count is the ground truth for whether,
// and how early, the tile exit fires.
//
// Bound on the H100: operations, as K1's (blend.cu): the count costs one
// store a tile. A smaller round costs a barrier and a staging pass more
// often, which is what the probe measures.
//
// Design: the whole-tile walk (blend_fwd.cuh:blend_tile, K1's before K1
// moved to sub-tile CTAs) and its staging, with a `Walk` that stages
// `chunk` rows a round (chunk <= kBatch), tests whether every pixel is done
// only before rounds r with r % exit_every == 0, and writes the rounds run
// from thread 0. So the image, the inverse depth and the final T are K1's
// bit for bit at every (chunk, exit_every), and the count is the JAX
// package's: a tile whose last pixel finishes in round c stops after
// exit_every * ceil((c + 1) / exit_every) rounds, capped at ceil(n / chunk).
// At (256, 1) it is the whole-tile walk itself, which chip_smoke.py times
// against K1 in turns.

#include <cuda_runtime.h>

#include "blend_fwd.cuh"

namespace {

using namespace guava_blend;

// A round's rows: order[base : base + n] gathered from the (P, 44) table (K1's staging).
struct GatherRows {
  const float4* rows;
  const int* order;
  __device__ void operator()(float4* stage, int base, int n) const {
    stage_rows(stage, nullptr, rows, order, base, n);
  }
};

// chunk rows a round; the exit test before rounds 0, e, 2e, ... (never for e = 0);
// the rounds run are written to counts[tile].
struct ProbeRounds {
  int chunk;
  int exit_every;
  int* counts;
  __device__ int rows_a_round() const { return chunk; }
  __device__ bool exit_test_before(int round) const {
    return exit_every > 0 && round % exit_every == 0;
  }
  __device__ void ran(int rounds) const {
    if (threadIdx.x == 0) counts[blockIdx.x] = rounds;
  }
};

__global__ void __launch_bounds__(1024) blend_probe_kernel(
    const float4* __restrict__ rows, const int* __restrict__ order,
    const int* __restrict__ ranges, const float* __restrict__ bg,
    float* __restrict__ color, float* __restrict__ invdepth,
    float* __restrict__ final_t, int* __restrict__ counts, int width, int tile, int grid_x,
    int chunk, int exit_every) {
  blend_tile(GatherRows{rows, order}, ranges, bg, color, invdepth, final_t, width, tile, grid_x,
             ProbeRounds{chunk, exit_every, counts});
}

}  // namespace

// K1's arguments (blend.cu) plus counts (gy*gx,) i32, the rounds each tile
// ran, 1 <= chunk <= 256 rows a round and exit_every >= 0.
extern "C" int guava_blend_probe(const float* rows, const int* order, const int* ranges,
                                 const float* bg, float* color, float* invdepth,
                                 float* final_t, int* counts, int height, int width, int tile,
                                 int chunk, int exit_every, void* stream) {
  if (chunk < 1 || chunk > kBatch || exit_every < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = blend_tiles_of(height, width, tile);
  if (n_tiles > 0) {
    blend_probe_kernel<<<n_tiles, tile * tile, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(rows), order, ranges, bg, color, invdepth, final_t,
        counts, width, tile, width / tile, chunk, exit_every);
  }
  return static_cast<int>(cudaGetLastError());
}
