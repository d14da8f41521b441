// Mesh z-buffer: per image tile, the nearest triangle hit of every pixel.
//
// Replaces guava_renderer_tpu/ops/meshraster.py:_mesh_kernel (reached
// through rasterize_mesh <- avatar/inferer.py:build_avatar). Triangles are
// binned to tiles on the host side (tile t owns inst_fid[ranges[t]:
// ranges[t+1]], face ids ascending; instances before ranges[0] or from
// ranges[n_tiles] on are read by no tile); for each pixel centre the z-buffer keeps
// the nearest covering triangle of its tile's run: edge-function coverage
// with eps -1e-6, screen-space barycentric depth, only z > 0 counts. A depth
// tie goes to the lowest instance (the plain walk is ascending with a strict
// `<`). Empty pixels read -1 and +inf.
//
// Bound on the H100: operations. Every (instance, pixel) pair of a tile's run
// costs ~28 FP32 operations in the TPU kernel, two of them IEEE divisions,
// while the bytes are small: the triangle table (48 B a face) and the
// instance list are read once and the two (H, W) images written once.
//
// Design (not the TPU kernel block by block):
//  1. Balanced work. A tile's run is cut into segments at the multiples of
//     kSegment in the instance list, so no CTA walks more than kSegment
//     instances. CTA t < n_tiles takes tile t's first segment (from
//     ranges[t] to the next multiple of kSegment); CTA n_tiles + k - 1 takes
//     the segment that starts at instance k * kSegment, if that falls
//     strictly inside a run (warp 0 searches `ranges` for the tile while the
//     other warps stage the faces from there on; a start outside
//     [ranges[0], ranges[n_tiles]) ends the CTA at once). No segment list is stored and the host does
//     not wait for one. A tile with one segment is
//     written by its CTA directly (an empty tile as -1 and +inf).
//  2. An exact merge. A CTA of a tile with several segments writes each
//     pixel's nearest hit as the 64-bit key (bits(z) << 32) | instance,
//     all ones where it found none. Every hit has 0 < z < inf, so the
//     float's bits order as the float does, and the least key is the lowest
//     instance of the least depth: the plain walk's rule. A second launch
//     (programmatic dependent: it starts while the segments run and waits
//     before it reads) takes each pixel's least key over the tile's
//     segments and decodes it. No atomics: the same bits every run. Two
//     launches a call.
//  3. An exact cull. A warp holds an 8 x 4 block of pixels (the whole tile
//     is its box when the tile is no multiple of 8). The plain predicate
//     rejects a pixel without dividing when, with d = det_safe, s its sign,
//     g0 = s e0 and g1 = s e1 (e0, e1 the edge functions as the plain
//     version rounds them):
//       R1  g0 <= -2^-19 |d|: e0 / d <= -2^-19, so the rounded w0 < -1e-6;
//       R2  the same for g1;
//       R3  fl(g0 + g1) >= fl((1 + 2^-16) |d|): the exact quotients sum to
//           at least 1 + 2^-18, so w2 = (1 - w0) - w1 rounds below -1e-6
//           (the rounding of w0, w1, 1 - w0 and w2 moves it by less than
//           5 * 2^-24 of the sum).
//     Each rests on rounding being monotone, whatever det's size or sign,
//     so it holds for the faces with |det| < 1e-12 (d = +1e-12 whatever
//     det's sign), whose three edge functions may all be 0 on their line far
//     outside their bounding box: a box cull would be wrong there, this one
//     is not. Each warp takes a staged round 32 triangles at a time: lane j
//     first tests triangle j against the warp's whole box, and the warp
//     walks only the triangles no rule rejects on all of it; it evaluates
//     e0 and e1 of those at every lane, keeps in each lane a bit mask of the
//     triangles no rule rejects there, and then each lane divides for its own
//     bits alone, in ascending order. The box test bounds every pixel's
//     rounded e0 and e1 by their exact affine range over the box, computed
//     in float at the centre and widened by 2^-19 of the largest |product|
//     term there (the four roundings of e0 at a pixel move it by at most
//     4 * 2^-24 of that term, the box's own float operations by less than
//     12 * 2^-24 of it) and by 2^-100 (subnormal products). Faces with
//     |d| >= 1e30 or a term of 2^100 or more (float overflow) are never
//     culled. Pixel centres are integers below 2^24, exact in float.
//     kernels/meshraster.py:mesh_zbuffer_split_plain models all of it.
//  4. Staging. The CTA stages kRound triangles at a time through inst_fid
//     (three 16-byte loads a face), each thread computing one triangle's
//     determinant, det_safe and cull constants once.
//
// This file is compiled with -fmad=false. The plain PyTorch version rounds
// every product and difference on its own; a fused multiply-add in the edge
// functions would move a shared edge by an ulp and hand a pixel to the
// neighbouring face, and the box bounds above assume the same roundings.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kSegment = 64;               // instances a CTA walks at most
                                           // (kernels/meshraster.py:SEGMENT sizes the scratch)
constexpr int kRound = 64;                 // triangles staged a round
constexpr int kMaxThreads = 1024;          // tile 32
constexpr float kEdgeEps = -1e-6f;
constexpr float kDetEps = 1e-12f;
constexpr float kTauScale = 0x1p-19f;      // R1, R2: |w| threshold below -1e-6
constexpr float kSumScale = 1.0f + 0x1p-16f;   // R3
constexpr float kCullMaxDet = 1e30f;       // larger |d|: never culled
constexpr float kErrRel = 0x1p-19f;        // the box bounds' widening (see 3. above)
constexpr float kErrAbs = 0x1p-100f;
constexpr float kTermMax = 0x1p100f;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;

struct Stage {
  float4 q0[kRound];    // ax ay bx by
  float4 q1[kRound];    // cx cy s tau
  float4 q2[kRound];    // sum_min d az bz
  float4 r[kRound];     // the box test's half-ranges of e0, e1, e0 + e1; cz
};

// Where a thread's pixel lies in its tile and its warp's box. With 8 x 4
// blocks (tile % 8 == 0) warp w takes block (w % (tile / 8), w / (tile / 8));
// otherwise pixels are row-major and every warp's box is the whole tile.
struct Layout {
  int lx, ly;           // the pixel in the tile
  bool has_pixel;
  float cx, cy;         // the warp's box centre in the tile
  float hx, hy;         // its half sizes (the same for every warp)
};

__device__ __forceinline__ Layout layout(int tid, int tile) {
  Layout l;
  const int warp = tid >> 5, lane = tid & 31;
  if (tile % 8 == 0) {
    const int per_row = tile / 8;
    const int bx = warp % per_row, by = warp / per_row;
    l.lx = 8 * bx + (lane & 7);
    l.ly = 4 * by + (lane >> 3);
    l.has_pixel = true;
    l.cx = 8 * bx + 3.5f;
    l.cy = 4 * by + 1.5f;
    l.hx = 3.5f;
    l.hy = 1.5f;
  } else {
    l.lx = tid % tile;
    l.ly = tid / tile;
    l.has_pixel = tid < tile * tile;
    l.cx = l.cy = l.hx = l.hy = 0.5f * (tile - 1);
  }
  return l;
}

// #{i < n : a[i] <= x} of a nondecreasing array, by one warp: each round
// samples 32 evenly spaced entries of the candidates and keeps the stretch
// between the last sample <= x and the next.
__device__ int count_le(const int* __restrict__ a, int n, int x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, len = n;
  while (len > 0) {
    const int step = (len + 31) / 32;
    const int i = lo + (lane + 1) * step - 1;
    const int c = __popc(__ballot_sync(kFull, i < lo + len && a[i] <= x));
    const int end = lo + len;
    lo += c * step;
    len = min(step - 1, end - lo);
  }
  return lo;
}

__device__ __forceinline__ void stage_triangle(Stage& st, int j, const float4* __restrict__ tris,
                                               int face, float hx, float hy) {
  const float4* t = tris + static_cast<int64_t>(face) * 3;
  const float4 a = __ldg(t), b = __ldg(t + 1), c = __ldg(t + 2);
  const float det = (b.x - a.x) * (c.y - a.y) - (b.y - a.y) * (c.x - a.x);
  const float d = fabsf(det) < kDetEps ? kDetEps : det;
  const float ad = fabsf(d);
  const bool cullable = ad < kCullMaxDet;   // false for NaN and inf too
  const float s = d > 0.0f ? 1.0f : -1.0f;
  const float tau = cullable ? ad * kTauScale : NAN;
  const float sum_min = cullable ? ad * kSumScale : NAN;
  st.q0[j] = make_float4(a.x, a.y, b.x, b.y);
  st.q1[j] = make_float4(c.x, c.y, s, tau);
  st.q2[j] = make_float4(sum_min, d, a.z, b.z);
  // half-ranges over a box of e0, e1 and e0 + e1 (their slopes in x, y)
  st.r[j] = make_float4(fabsf(b.y - c.y) * hx + fabsf(c.x - b.x) * hy,
                        fabsf(c.y - a.y) * hx + fabsf(a.x - c.x) * hy,
                        fabsf(b.y - a.y) * hx + fabsf(a.x - b.x) * hy, c.z);
}

// True where R1, R2 or R3 holds at every pixel of the box centred (xc, yc)
// with half sizes (hx, hy), so the warp can skip triangle j.
__device__ __forceinline__ bool box_rejects(const Stage& st, int j, float xc, float yc,
                                            float hx, float hy) {
  const float4 q0 = st.q0[j], q1 = st.q1[j], r = st.r[j];
  const float dxa = q0.x - xc, dya = q0.y - yc;
  const float dxb = q0.z - xc, dyb = q0.w - yc;
  const float dxc = q1.x - xc, dyc = q1.y - yc;
  const float e0 = dxb * dyc - dyb * dxc;      // e0, e1 at the centre
  const float e1 = dxc * dya - dyc * dxa;
  const float xa = fabsf(dxa) + hx, ya = fabsf(dya) + hy;
  const float xb = fabsf(dxb) + hx, yb = fabsf(dyb) + hy;
  const float xcc = fabsf(dxc) + hx, ycc = fabsf(dyc) + hy;
  const float m0 = xb * ycc + yb * xcc;        // |first product| + |second| over the box
  const float m1 = xcc * ya + ycc * xa;
  const float err0 = kErrRel * m0 + kErrAbs;
  const float err1 = kErrRel * m1 + kErrAbs;
  const float s = q1.z, tau = q1.w;
  const float hi0 = s * e0 + r.x + err0;
  const float hi1 = s * e1 + r.y + err1;
  const float lo01 = s * (e0 + e1) - r.z - err0 - err1;
  return m0 < kTermMax && m1 < kTermMax
         && (hi0 <= -tau || hi1 <= -tau || lo01 >= st.q2[j].x);
}

// e0, e1 at (px, py) as mesh_zbuffer_plain rounds them (q0 = ax ay bx by, q1 = cx cy ..)
__device__ __forceinline__ void edge_functions(float4 q0, float4 q1, float px, float py,
                                               float& e0, float& e1) {
  e0 = (q0.z - px) * (q1.y - py) - (q0.w - py) * (q1.x - px);
  e1 = (q1.x - px) * (q0.y - py) - (q1.y - py) * (q0.x - px);
}

__device__ __forceinline__ unsigned long long hit_key(float z, int i) {
  return i < 0 ? kEmpty
               : (static_cast<unsigned long long>(__float_as_uint(z)) << 32)
                     | static_cast<unsigned>(i);
}

// kThreads: the CTA size it is built for, 256 (tiles up to 16; given that
// bound ptxas keeps the division's slow path off the stack) or kMaxThreads
template <int kThreads>
__global__ void __launch_bounds__(kThreads) mesh_zbuffer_kernel(
    const float4* __restrict__ tris, const int* __restrict__ inst_fid,
    const int* __restrict__ ranges, int* __restrict__ best, float* __restrict__ depth,
    unsigned long long* __restrict__ first, unsigned long long* __restrict__ cont, int width,
    int n_inst, int tile, int grid_x, int n_tiles) {
  __shared__ Stage st;
  __shared__ int found_tile;
  // the merge launch may start once every CTA here has started; it waits
  // for this grid before it reads the keys
  asm volatile("griddepcontrol.launch_dependents;");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tile2 = tile * tile;
  const Layout l = layout(tid, tile);

  int t, lo, hi;
  bool staged = false;                    // the first round is in `st` already
  unsigned long long* keys = nullptr;     // null: the segment is its tile's whole run
  if (static_cast<int>(blockIdx.x) < n_tiles) {
    t = blockIdx.x;
    lo = ranges[t];
    const int end = ranges[t + 1];
    hi = static_cast<int>(min(static_cast<long long>(end),
                              (static_cast<long long>(lo) / kSegment + 1) * kSegment));
    if (hi < end) keys = first + static_cast<int64_t>(t) * tile2;
  } else {
    // warp 0 finds the tile whose run holds instance lo while the other
    // warps stage the first round from lo on (the staged faces past the
    // tile's run go unused); no tile's run holds an instance outside
    // [ranges[0], ranges[n_tiles])
    const int k = blockIdx.x - n_tiles + 1;
    lo = k * kSegment;
    if (lo < ranges[0] || lo >= ranges[n_tiles]) return;
    const int threads = blockDim.x;
    if (tid < 32) {
      const int found = count_le(ranges + 1, n_tiles, lo);
      if (lane == 0) found_tile = found;
    }
    if (threads == 32 || tid >= 32) {
      const int j0 = threads == 32 ? tid : tid - 32, stride = threads == 32 ? 32 : threads - 32;
      for (int j = j0; j < min(kRound, n_inst - lo); j += stride) {
        stage_triangle(st, j, tris, inst_fid[lo + j], l.hx, l.hy);
      }
    }
    __syncthreads();
    t = found_tile;
    if (ranges[t] == lo) return;               // a run starts here: CTA t has it
    hi = min(ranges[t + 1], lo + kSegment);
    keys = cont + static_cast<int64_t>(k - 1) * tile2;
    staged = true;
  }

  const int tx0 = (t % grid_x) * tile, ty0 = (t / grid_x) * tile;
  const float px = static_cast<float>(tx0 + l.lx);
  const float py = static_cast<float>(ty0 + l.ly);
  const float xc = tx0 + l.cx, yc = ty0 + l.cy;

  int best_i = -1;
  float best_z = INFINITY;
  for (int base = lo; base < hi; base += kRound) {
    const int n = min(kRound, hi - base);
    if (!staged) {
      __syncthreads();                   // the previous round's reads are done
      for (int j = tid; j < n; j += blockDim.x) {
        stage_triangle(st, j, tris, inst_fid[base + j], l.hx, l.hy);
      }
      __syncthreads();
    }
    staged = false;
    for (int c = 0; c < n; c += 32) {
      // the warp's triangles of these 32, then the ones this lane must divide for
      const int j = c + lane;
      const bool walk = j < n && !box_rejects(st, j, xc, yc, l.hx, l.hy);
      unsigned warp_mask = __ballot_sync(kFull, walk);
      unsigned mine = 0;
      while (warp_mask) {
        const int b = __ffs(warp_mask) - 1;
        warp_mask &= warp_mask - 1;
        const float4 q1 = st.q1[c + b];
        float e0, e1;
        edge_functions(st.q0[c + b], q1, px, py, e0, e1);
        const float g0 = e0 * q1.z, g1 = e1 * q1.z;
        if (!(g0 <= -q1.w || g1 <= -q1.w || g0 + g1 >= st.q2[c + b].x)) mine |= 1u << b;
      }
      while (mine) {                    // ascending, so a depth tie keeps the lower instance
        const int jj = c + __ffs(mine) - 1;
        mine &= mine - 1;
        const float4 q2 = st.q2[jj];
        float e0, e1;
        edge_functions(st.q0[jj], st.q1[jj], px, py, e0, e1);
        const float w0 = e0 / q2.y;
        const float w1 = e1 / q2.y;
        const float w2 = 1.0f - w0 - w1;
        const float z = w0 * q2.z + w1 * q2.w + w2 * st.r[jj].w;
        if (w0 >= kEdgeEps && w1 >= kEdgeEps && w2 >= kEdgeEps && z > 0.0f && z < best_z) {
          best_z = z;
          best_i = base + jj;
        }
      }
    }
  }

  if (!l.has_pixel) return;
  if (keys != nullptr) {
    keys[l.ly * tile + l.lx] = hit_key(best_z, best_i);
  } else {
    const int64_t pix = static_cast<int64_t>(ty0 + l.ly) * width + tx0 + l.lx;
    best[pix] = best_i;
    depth[pix] = best_z;
  }
}

// A tile with several segments: each pixel's least key over them, decoded.
__global__ void __launch_bounds__(kMaxThreads) mesh_zbuffer_merge_kernel(
    const int* __restrict__ ranges, const unsigned long long* __restrict__ first,
    const unsigned long long* __restrict__ cont, int* __restrict__ best,
    float* __restrict__ depth, int width, int tile, int grid_x) {
  const int t = blockIdx.x;
  const int lo = ranges[t], end = ranges[t + 1];
  const int k0 = lo / kSegment, k1 = lo < end ? (end - 1) / kSegment : k0;
  const Layout l = layout(threadIdx.x, tile);
  // the segments' keys are complete and visible past this point
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (k1 == k0 || !l.has_pixel) return;
  const int tile2 = tile * tile;
  const int p = l.ly * tile + l.lx;
  unsigned long long key = first[static_cast<int64_t>(t) * tile2 + p];
  for (int k = k0 + 1; k <= k1; ++k) {
    key = min(key, cont[static_cast<int64_t>(k - 1) * tile2 + p]);
  }
  const int64_t pix = static_cast<int64_t>((t / grid_x) * tile + l.ly) * width
                      + (t % grid_x) * tile + l.lx;
  best[pix] = key == kEmpty ? -1 : static_cast<int>(key & 0xffffffffu);
  depth[pix] = key == kEmpty ? INFINITY : __uint_as_float(static_cast<unsigned>(key >> 32));
}

int threads_for(int tile) { return (tile * tile + 31) / 32 * 32; }

}  // namespace

// tris (F, 12) f32 [ax ay az 0 | bx by bz 0 | cx cy cz 0] in pixels and
// camera depth, inst_fid (n_inst,) i32 face ids grouped by tile (tiles
// row-major), ranges (gy*gx + 1,) i32 nondecreasing within [0, n_inst] ->
// best (H, W) i32 instance index (-1 empty), depth (H, W) f32 (+inf empty).
// Tile t reads inst_fid[ranges[t]:ranges[t+1]] alone, so inst_fid may hold
// instances before ranges[0] and after ranges[gy*gx]. H and W are multiples
// of tile, and tile * tile <= 1024. first (gy*gx, tile^2) and cont
// (max(ceil(n_inst / kSegment) - 1, 1), tile^2) u64 scratch, written
// before read. Two launches when the image has a tile.
extern "C" int guava_mesh_zbuffer(const float* tris, const int* inst_fid, const int* ranges,
                                  int* best, float* depth, unsigned long long* first,
                                  unsigned long long* cont, int n_inst, int height, int width,
                                  int tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid_x = width / tile;
  const int n_tiles = grid_x * (height / tile);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const int n_slices = static_cast<int>((static_cast<int64_t>(n_inst) + kSegment - 1) / kSegment);
  const int threads = threads_for(tile);
  const int grid = n_tiles + max(n_slices - 1, 0);
  const auto* t4 = reinterpret_cast<const float4*>(tris);
  if (threads <= 256) {
    mesh_zbuffer_kernel<256><<<grid, threads, 0, s>>>(t4, inst_fid, ranges, best, depth, first,
                                                      cont, width, n_inst, tile, grid_x, n_tiles);
  } else {
    mesh_zbuffer_kernel<kMaxThreads><<<grid, threads, 0, s>>>(t4, inst_fid, ranges, best, depth,
                                                              first, cont, width, n_inst, tile,
                                                              grid_x, n_tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles);
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mesh_zbuffer_merge_kernel, ranges,
                           static_cast<const unsigned long long*>(first),
                           static_cast<const unsigned long long*>(cont), best, depth, width, tile,
                           grid_x);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs an SM of the segment kernel at this tile
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and its shared memory.
extern "C" int guava_mesh_zbuffer_occupancy(int tile, int* ctas, int* smem_bytes) {
  const int threads = threads_for(tile);
  *smem_bytes = static_cast<int>(sizeof(Stage));
  return static_cast<int>(
      threads <= 256
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, mesh_zbuffer_kernel<256>, threads, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, mesh_zbuffer_kernel<kMaxThreads>,
                                                          threads, 0));
}
