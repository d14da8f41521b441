// Backward of the planned deformer's face-table gather (K4):
// d_table[f, c] = sum over the texels t with ids[t] == f of drows[c, t].
//
// Replaces guava_renderer_tpu/ops/facegather.py:_bwd_kernel (the custom_vjp
// of face_window_gather). On the TPU that kernel multiplies each 256-texel
// chunk of drows with a transposed one-hot over a 384-face window and adds
// the product into a resident accumulator; it is race-free only because the
// TPU grid runs in sequence.
//
// Bound on the H100: bytes. At the bench avatar (N = 176,128 texels,
// Fc = 20,284 faces) it must read 16 x N f32 = 11.3 MB of drows and the
// N sorted face ids, and write the 64-byte-a-row table (1.3 MB): ~13 MB,
// ~4 us at 3.35 TB/s. One addition a value read.
//
// Design: the ids are static and sorted by face, so a face's texels are one
// contiguous run. The work is cut by texels, not by faces: a face's length
// varies from 1 texel to the dummy face's ~1.4k (every invalid texel and the
// padding), and a thread a face would leave that one face to one thread.
//  1. Windows. One warp sums one channel of a window of kWindow = 256
//     consecutive texels (688 windows x 16 channels at the bench avatar, 8
//     warps a CTA: the same window's channels, which share its ids in L1).
//     Lane l holds the window's texels 8 l .. 8 l + 7, read as two 16-byte
//     loads of values and two of ids. No shared memory and no barrier: the
//     warps are independent, so the SMs stay evenly loaded. (On the bench
//     avatar 8 texels a lane beat 4 and 16, staging through shared memory,
//     and two or more channels a warp.)
//  2. A segmented scan. Each lane sums its 8 texels face by face in order;
//     the warp then scans the lanes' last sums, each lane starting a new
//     sum where its last face begins inside it (five shuffles); a lane's
//     first face adds the sum its left neighbour ends with.
//  3. Writes. A face whose run ends inside the window and began inside it is
//     written to d_table by the lane that holds its last texel. A face that
//     crosses a window edge leaves a partial sum: `head` for the window's
//     first face (begun in an earlier window), `tail` for its last face
//     (going on into the next). A second, small launch adds each crossing
//     face's pieces in window order (tail of its first window, tails of the
//     windows it covers whole, head of its last) and writes it. It is
//     launched as a programmatic dependent launch: it starts while the
//     windows run, loads the ids and segment bounds it needs, and waits
//     (griddepcontrol.wait) only before it reads the partial sums. The faces
//     no texel binds are written as zeros by the lane holding the texel after
//     them.
// No float atomics: every sum is added in one fixed order (a lane's texels
// in order, the scan's tree, then the window order), so two runs give the
// same bits; kernels/facegather.py:face_gather_bwd_windowed_plain models the
// order in PyTorch. Two launches a call.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 16;
constexpr int kLaneTexels = 8;
constexpr int kWindow = 32 * kLaneTexels;     // texels a warp sums: 256
constexpr int kWarps = 8;                     // warps a CTA: channels of one window
constexpr int kThreads = 32 * kWarps;
constexpr int kCarryThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// d_table[f, c] = 0 for the faces strictly between lo and hi (no texel binds
// them: the ids are sorted), up to the last face.
__device__ __forceinline__ void zero_gap(float* d_table, int lo, int hi, int n_faces, int c) {
  for (int f = lo + 1; f < min(hi, n_faces); ++f) {
    d_table[static_cast<int64_t>(f) * kChannels + c] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads) face_gather_bwd_window_kernel(
    const float* __restrict__ drows, const int* __restrict__ ids, float* __restrict__ d_table,
    float* __restrict__ head, float* __restrict__ tail, int n, int n_faces) {
  // the carry launch may start now: it waits for this grid before it reads head and tail
  asm volatile("griddepcontrol.launch_dependents;");
  const int w = blockIdx.x;
  const int c = blockIdx.y * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int64_t t0 = static_cast<int64_t>(w) * kWindow + lane * kLaneTexels;
  const float* src = drows + static_cast<int64_t>(c) * n;

  float x[kLaneTexels];
  int a[kLaneTexels];
#pragma unroll
  for (int k = 0; k < kLaneTexels; k += 4) {   // n % 4 == 0: four texels are all in or all out
    const int64_t t = t0 + k;
    const bool in = t < n;
    const float4 v = in ? *reinterpret_cast<const float4*>(src + t)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int4 i = in ? *reinterpret_cast<const int4*>(ids + t)
                      : make_int4(n_faces, n_faces, n_faces, n_faces);
    x[k] = v.x, x[k + 1] = v.y, x[k + 2] = v.z, x[k + 3] = v.w;
    a[k] = i.x, a[k + 1] = i.y, a[k + 2] = i.z, a[k + 3] = i.w;
  }
  // the ids of the texels before and after this lane's
  int p = __shfl_up_sync(kFull, a[kLaneTexels - 1], 1);
  if (lane == 0) p = t0 > 0 ? ids[t0 - 1] : -1;
  int nx = __shfl_down_sync(kFull, a[0], 1);
  if (lane == 31) nx = t0 + kLaneTexels < n ? ids[t0 + kLaneTexels] : n_faces;
  // the window's first face, if it began in an earlier window (else -1)
  const int first_crossing = __shfl_sync(kFull, p == a[0] ? a[0] : -1, 0);

  // the lane's own sums, face by face in texel order
  float s[kLaneTexels];
  s[0] = x[0];
#pragma unroll
  for (int j = 1; j < kLaneTexels; ++j) s[j] = a[j] == a[j - 1] ? s[j - 1] + x[j] : x[j];

  // segmented inclusive scan of the lanes' last sums: a lane whose last face
  // begins inside it (or lane 0) starts a new sum
  float v = s[kLaneTexels - 1];
  int head_here = lane == 0 || a[kLaneTexels - 1] != p;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(kFull, v, d);
    const int g = __shfl_up_sync(kFull, head_here, d);
    if (lane >= d) {
      if (!head_here) v = y + v;
      head_here |= g;
    }
  }
  // the sum the left neighbour ends with, for this lane's first face
  const float e = __shfl_up_sync(kFull, v, 1);
  const bool cont = lane > 0 && a[0] == p;

  // faces no texel binds lie between two of the lane's texels' ids (rare: the plan
  // binds every face it keeps, bar the dummy face when every texel is valid)
  bool gaps = p + 1 < a[0];
#pragma unroll
  for (int j = 1; j < kLaneTexels; ++j) gaps |= a[j - 1] + 1 < a[j];
  if (gaps) {
#pragma unroll
    for (int j = 0; j < kLaneTexels; ++j) {
      zero_gap(d_table, j > 0 ? a[j - 1] : p, a[j], n_faces, c);
    }
  }
#pragma unroll
  for (int j = 0; j < kLaneTexels; ++j) {
    const int f = a[j];
    const int next = j + 1 < kLaneTexels ? a[j + 1] : nx;
    const float sum = cont && f == a[0] ? e + s[j] : s[j];
    float* dst = f == first_crossing ? head + w * kChannels + c
                                     : d_table + static_cast<int64_t>(f) * kChannels + c;
    if (f != next && f < n_faces) *dst = sum;   // f's last texel in this window
    if (j == kLaneTexels - 1 && lane == 31) {
      // the faces after the last texel; f going on into the next window
      if (w == gridDim.x - 1) zero_gap(d_table, f, nx, n_faces, c);
      if (f < n_faces && f == nx) tail[w * kChannels + c] = sum;
    }
  }
}

// One thread a (window edge b, channel): the face that crosses edge b first
// (it binds the texels on both sides, and began in window b - 1) sums its
// pieces in window order.
__global__ void __launch_bounds__(kCarryThreads) face_gather_bwd_carry_kernel(
    const int* __restrict__ ids, const int* __restrict__ seg, const float* __restrict__ head,
    const float* __restrict__ tail, float* __restrict__ d_table, int n_windows) {
  const int i = blockIdx.x * kCarryThreads + threadIdx.x;
  const int b = i / kChannels + 1;
  const int c = i % kChannels;
  bool mine = b < n_windows;
  int f = 0, last = 0;
  if (mine) {
    const int64_t t = static_cast<int64_t>(b) * kWindow;
    f = ids[t];
    mine = ids[t - 1] == f && seg[f] >= t - kWindow;   // else none crosses, or one crossed earlier
    last = (seg[f + 1] - 1) / kWindow;
  }
  // the window launch's partial sums are complete and visible past this point
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (!mine) return;
  float sum = tail[(b - 1) * kChannels + c];
  for (int v = b; v < last; ++v) sum += tail[v * kChannels + c];
  sum += head[last * kChannels + c];
  d_table[static_cast<int64_t>(f) * kChannels + c] = sum;
}

}  // namespace

// drows (16, n) f32 and ids (n,) i32, both 16-byte aligned with n % 4 == 0
// (the plan pads n to a multiple of 4096), ids sorted face ids in [0, n_faces), seg
// (n_faces + 1,) i32 their ascending segment starts (seg[0] = 0, seg[n_faces]
// = n), carry (2, n_windows, 16) f32 scratch with n_windows = ceil(n / 256)
// -> d_table (n_faces, 16) f32 (every entry is written; an empty segment gives
// zeros). Two launches when n > 0 and n_faces > 0; none otherwise (with
// n = 0 the table is zeroed).
extern "C" int guava_face_gather_bwd(const float* drows, const int* ids, const int* seg,
                                     float* carry, float* d_table, int n, int n_faces,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_faces <= 0) return static_cast<int>(cudaGetLastError());
  if (n <= 0) {
    return static_cast<int>(cudaMemsetAsync(d_table, 0, sizeof(float) * n_faces * kChannels, s));
  }
  const int n_windows = (n + kWindow - 1) / kWindow;
  float* head = carry;
  float* tail = carry + n_windows * kChannels;
  const dim3 grid(n_windows, kChannels / kWarps);
  face_gather_bwd_window_kernel<<<grid, kThreads, 0, s>>>(drows, ids, d_table, head, tail, n,
                                                          n_faces);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int edges = max(n_windows - 1, 1) * kChannels;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((edges + kCarryThreads - 1) / kCarryThreads);
  cfg.blockDim = dim3(kCarryThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, face_gather_bwd_carry_kernel, ids, seg,
                           static_cast<const float*>(head), static_cast<const float*>(tail),
                           d_table, n_windows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
