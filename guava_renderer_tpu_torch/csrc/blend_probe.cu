// K1p: the forward tile blend with a count of the rounds each tile ran (the
// early-exit probe).
//
// Replaces guava_renderer_tpu/ops/gsplat.py:1714 blend_probe, which is the
// TPU's forward blend (_fwd_kernel) called with emit_counts=True: each tile
// runs its while loop over chunks of `chunk` instances, stops once every
// pixel is done (tested every `exit_every` chunks; 0 never stops early) and
// writes how many chunks it ran. The count is the ground truth for
// whether, and how early, the tile exit fires.
//
// Bound on the H100: operations, as K1's (blend.cu): the count costs one
// atomic a CTA. A smaller round costs a barrier and a staging pass more
// often, which is what the probe measures.
//
// Design: K1's kernel (blend_subtile_fwd.cuh) on the (P, 44) table, with
// ProbeRounds: `chunk` rows a round (all of them, whatever the CTA's
// threads: RowPipe's wide rounds), the test whether every pixel is done
// only before rounds r with r % exit_every == 0 (a plain barrier before the
// others), and the rounds run written to the tile's count. Up to 128 rows a
// round the stage is K1's (46 KB, three CTAs an SM), so at (128, 1) the
// kernel is K1's plus one atomic; up to 256 it is a stage of 256 rows (90
// KB, two CTAs an SM). The host picks the stage from the chunk
// (kernels/blend.py). The image, the inverse depth and the final T are
// K1's bit for bit at every (chunk, exit_every).
//
// Why the count survives sub-tiles. A bin tile is several sub-tile CTAs,
// each with its own exit test, that walk the same instance range, so they
// share total = ceil(n / chunk). Sub-tile s whose last pixel finishes in
// round c_s runs min(total, e ceil((c_s + 1) / e)) rounds (e = exit_every),
// or total if some pixel of it never finishes or e = 0. That is monotone in
// c_s, so the maximum over the sub-tiles is the same expression at
// c = max c_s, the round in which the tile's last pixel finishes: the
// tile's count, as the whole tile walked in one loop would run it. Each
// CTA's thread 0 writes its rounds by atomicMax into the tile's count,
// which the host zeroes (a tile with no instances keeps 0). The cull moves
// no finish: a row it drops is one that no pixel of the warp would take
// (blend_subtile.cuh), so every pixel finishes at the instance it would
// without the cull.

#include <cuda_runtime.h>

#include "blend_subtile_fwd.cuh"

namespace guava_blend {

// K1p's stage past 128 rows a round.
struct PlainRows256 : PlainRows {
  using FwdStage = RowStage<256, kFwdDepth>;
};

// chunk rows a round (at most the stage's); the exit test before rounds 0,
// e, 2e, ... (never for e = 0); the rounds run to counts[tile] by atomicMax.
struct ProbeRounds {
  static constexpr bool wide = true;
  int chunk;
  int exit_every;
  int* __restrict__ counts;
  __device__ int rows(int max_rows) const { return min(max_rows, chunk); }
  __device__ bool exit_test_before(int round) const {
    return exit_every > 0 && round % exit_every == 0;
  }
  __device__ void ran(int tile_id, int rounds) const {
    if (threadIdx.x == 0) atomicMax(&counts[tile_id], rounds);
  }
};

}  // namespace guava_blend

using guava_blend::PlainRows;
using guava_blend::PlainRows256;
using guava_blend::ProbeRounds;

// K1's arguments (blend.cu) plus counts (gy*gx,) i32, zeroed, that receive
// the rounds each tile ran; 1 <= chunk <= stage_size rows a round, stage_size
// 128 or 256, and exit_every >= 0.
extern "C" int guava_blend_probe(const float* rows, const int* order, const int* ranges,
                                 const float* bg, float* color, float* invdepth,
                                 float* final_t, int* counts, int height, int width, int tile,
                                 int chunk, int exit_every, int stage_size, void* stream) {
  if (chunk < 1 || chunk > stage_size || exit_every < 0 ||
      (stage_size != 128 && stage_size != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  const ProbeRounds rounds{chunk, exit_every, counts};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      stage_size == 128
          ? guava_blend::launch_blend_fwd(PlainRows{rows4}, order, ranges, bg, color, invdepth,
                                          final_t, height, width, tile, s, rounds)
          : guava_blend::launch_blend_fwd(PlainRows256{{rows4}}, order, ranges, bg, color,
                                          invdepth, final_t, height, width, tile, s, rounds));
}

// CTAs of K1p's instantiation for stage_size (128 or 256) resident on one SM
// at once for a tile -> *ctas; its dynamic shared memory a CTA -> *smem_bytes.
extern "C" int guava_blend_probe_occupancy(int tile, int stage_size, int* ctas,
                                           int* smem_bytes) {
  if (stage_size == 128) {
    return guava_blend::blend_fwd_occupancy<PlainRows, ProbeRounds>(tile, ctas, smem_bytes);
  }
  if (stage_size == 256) {
    return guava_blend::blend_fwd_occupancy<PlainRows256, ProbeRounds>(tile, ctas, smem_bytes);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
