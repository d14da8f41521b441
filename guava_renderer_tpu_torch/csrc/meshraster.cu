// Mesh z-buffer: per image tile, the nearest triangle hit of every pixel.
//
// Replaces guava_renderer_tpu/ops/meshraster.py:_mesh_kernel (reached
// through rasterize_mesh <- avatar/inferer.py:build_avatar). Triangles are
// binned to tiles on the host side (tile t owns inst_fid[ranges[t]:
// ranges[t+1]], face ids ascending); for each pixel centre the kernel walks
// its tile's run and keeps the nearest covering triangle: edge-function
// coverage with eps -1e-6, screen-space barycentric depth, only z > 0
// counts. The walk is ascending and the test a strict `<`, so a depth tie
// goes to the lowest instance. Empty pixels read -1 and +inf.
//
// Bound on the H100: operations. Every (instance, pixel) pair costs ~35
// FP32 operations and two IEEE divisions, while the bytes are small: the
// triangle table (48 B a face) and the instance list are read once and the
// two (H, W) images written once (~3.5 MB at 512^2 with 20k faces).
//
// Design (not the TPU kernel block by block): one CTA per tile, one thread
// per pixel, the shape of the tile blend. The CTA stages the next kBatch
// triangles of the run in shared memory, reading the (F, 12) table THROUGH
// inst_fid with 16-byte loads (three float4 a triangle: x, y, z, pad per
// vertex), and every thread then reads them as broadcasts with its running
// minimum in registers. The TPU form's 128-lane rows, its per-instance copy
// of the triangle table and its tiled output that the host un-tiles all
// existed for DMA alignment; none is kept: the images are written straight
// in (H, W) layout.
//
// This file is compiled with -fmad=false. The plain PyTorch version rounds
// every product and difference on its own; a fused multiply-add in the edge
// functions would move a shared edge by an ulp and hand a pixel to the
// neighbouring face.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBatch = 256;              // triangles a round: 12,288 B of shared memory
constexpr float kEdgeEps = -1e-6f;
constexpr float kDetEps = 1e-12f;

__global__ void __launch_bounds__(1024) mesh_zbuffer_kernel(
    const float4* __restrict__ tris, const int* __restrict__ inst_fid,
    const int* __restrict__ ranges, int* __restrict__ best, float* __restrict__ depth,
    int width, int tile, int grid_x) {
  __shared__ float4 stage[kBatch * 3];

  const int tid = threadIdx.x;
  const int tile_id = blockIdx.x;
  const int ix = (tile_id % grid_x) * tile + tid % tile;
  const int iy = (tile_id / grid_x) * tile + tid / tile;
  const float px = static_cast<float>(ix);
  const float py = static_cast<float>(iy);
  const int start = ranges[tile_id];
  const int end = ranges[tile_id + 1];

  int best_i = -1;
  float best_z = INFINITY;

  for (int base = start; base < end; base += kBatch) {
    const int n = min(kBatch, end - base);
    __syncthreads();                     // the previous round's reads are done
    for (int i = tid; i < n * 3; i += blockDim.x) {
      const int r = i / 3;
      stage[i] = tris[static_cast<int64_t>(inst_fid[base + r]) * 3 + (i - r * 3)];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 a = stage[3 * j];
      const float4 b = stage[3 * j + 1];
      const float4 c = stage[3 * j + 2];
      const float det = (b.x - a.x) * (c.y - a.y) - (b.y - a.y) * (c.x - a.x);
      const float det_safe = fabsf(det) < kDetEps ? kDetEps : det;
      const float w0 = ((b.x - px) * (c.y - py) - (b.y - py) * (c.x - px)) / det_safe;
      const float w1 = ((c.x - px) * (a.y - py) - (c.y - py) * (a.x - px)) / det_safe;
      const float w2 = 1.0f - w0 - w1;
      const float z = w0 * a.z + w1 * b.z + w2 * c.z;
      if (w0 >= kEdgeEps && w1 >= kEdgeEps && w2 >= kEdgeEps && z > 0.0f && z < best_z) {
        best_z = z;
        best_i = base + j;
      }
    }
  }

  const int64_t pix = static_cast<int64_t>(iy) * width + ix;
  best[pix] = best_i;
  depth[pix] = best_z;
}

}  // namespace

// tris (F, 12) f32 [ax ay az 0 | bx by bz 0 | cx cy cz 0] in pixels and
// camera depth, inst_fid (N,) i32 face ids grouped by tile (tiles
// row-major), ranges (gy*gx + 1,) i32 -> best (H, W) i32 instance index
// (-1 empty), depth (H, W) f32 (+inf empty). H and W are multiples of
// tile, and tile * tile <= 1024.
extern "C" int guava_mesh_zbuffer(const float* tris, const int* inst_fid, const int* ranges,
                                  int* best, float* depth, int height, int width, int tile,
                                  void* stream) {
  const int grid_x = width / tile;
  const int n_tiles = grid_x * (height / tile);
  if (n_tiles > 0) {
    mesh_zbuffer_kernel<<<n_tiles, tile * tile, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(tris), inst_fid, ranges, best, depth, width, tile,
        grid_x);
  }
  return static_cast<int>(cudaGetLastError());
}
