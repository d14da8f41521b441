// R1: separable banded bilinear resize out = Wy . x . Wx^T of (B, C, H, W)
// images, each axis's operator W given as tap tables (start[o], taps[o, K]:
// out[o] = sum_k taps[o, k] * in[start[o] + k]).
//
// Replaces no TPU kernel. The JAX package's resize_bilinear
// (guava_renderer_tpu/models/layers.py) is two dense interpolation-matrix
// einsums, which XLA gives the TPU's matrix unit. On the H100 that form
// multiplies by ~256x the nonzero weights (8 of 2,048 in a row of the
// frame's 2048 -> 512 downscale, 2 of 512 in the upscale back) and copies
// the strided feature image for the products.
//
// Bound on the H100: bytes. The frame's downscale of the (1, 32, 2048,
// 2048) f32 feature image reads 536.9 MB and writes 33.6 MB, the upscale
// of the (1, 3, 512, 512) RGB reads 3.1 MB and writes 50.3 MB: 0.19 ms at
// 3.35 TB/s. The taps are ~0.7 GFLOP, far under the card's rate.
//
// Design: one launch, both passes fused through shared memory. A CTA owns
// `rows` output rows x tw output columns x cc channels of one image:
//  1. the y-pass reads each input element of the tile's band once: a thread
//     takes one (column, channels) item and walks down the band's input
//     rows, loading a batch of rows before it adds each to the float32
//     tile rows (in shared memory) of the outputs whose taps read it. The
//     input is read through its strides: where the channels are contiguous
//     (the frame's NHWC features seen as NCHW: 128 bytes a pixel)
//     consecutive threads take consecutive channels, 4 at a time (one
//     16-byte load) where they are aligned, else consecutive columns, so a
//     warp's loads are coalesced either way and no permuted copy is made;
//  2. the x-pass: a thread keeps one output column and its taps in
//     registers and walks the tile's (channel, row) pairs, storing to the
//     contiguous NCHW output in the input's type, a warp's stores running
//     along a row.
// The tile's row pitch is odd, so the y-pass's channel-fast updates and the
// x-pass's reads of neighbouring channels fall in distinct banks. The
// wrapper (kernels/resize.py:launch_shape) owns the tile's geometry: it
// sizes rows, tw and cc so a CTA has ~8,192 outputs, and the shared memory
// that holds them; the launcher checks only the 48 KB limit and what the
// kernel's indexing needs. Each output's sum is
// float32 in tap order from 0, with separate rounded multiplies and adds
// (no fused multiply-add): the arithmetic of the plain version, which the
// kernel equals bit for bit. One launch through shared memory beat two
// through a (B, C, h, W) intermediate (PERF.md §6). The backward is this
// kernel on the adjoint tables: a gather, no atomics.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRegTaps = 8;       // x-pass taps held in registers (more: read from shared memory)
constexpr int kSmemLimit = 48 * 1024;

// v[0..V) = the V consecutive elements at p, as float
template <int V>
__device__ __forceinline__ void load_v(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}
__device__ __forceinline__ float to_float(unsigned short e, const __nv_bfloat16*) {
  return __bfloat162float(__ushort_as_bfloat16(e));
}
__device__ __forceinline__ float to_float(unsigned short e, const __half*) {
  return __half2float(__ushort_as_half(e));
}
template <int V, typename H>
__device__ __forceinline__ void load_v16(const H* p, float* v) {
  if constexpr (V == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const unsigned short e[4] = {static_cast<unsigned short>(q.x & 0xffffu),
                                 static_cast<unsigned short>(q.x >> 16),
                                 static_cast<unsigned short>(q.y & 0xffffu),
                                 static_cast<unsigned short>(q.y >> 16)};
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = to_float(e[u], p);
  } else {
    v[0] = to_float(__ldg(reinterpret_cast<const unsigned short*>(p)), p);
  }
}
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float* v) { load_v16<V>(p, v); }
template <int V>
__device__ __forceinline__ void load_v(const __half* p, float* v) { load_v16<V>(p, v); }

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_f(__half* p, float v) { *p = __float2half_rn(v); }

// V: elements a thread loads at once, along the channels (4: contiguous,
// aligned channels, chan_fast) or 1
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) resize_kernel(
    const T* __restrict__ x, int C, int64_t sb, int64_t sc, int64_t sh, int64_t sw,
    const int* __restrict__ ys, const float* __restrict__ ty, int ky,
    const int* __restrict__ xs, const float* __restrict__ tx, int kx,
    T* __restrict__ out, int h_out, int w_out, int rows, int tw_max, int cc_max, int wsp,
    int yspan, int n_cblk, int chan_fast) {
  constexpr int kBatch = V == 4 ? 4 : 8;                // input rows loaded before they are summed
  extern __shared__ float smem[];
  float* tile = smem;                                   // [rows][cc_max][wsp]
  float* ty_s = tile + rows * cc_max * wsp;             // [rows][ky]
  float* tx_s = ty_s + rows * ky;                       // [tw_max][kx]
  int* ys_s = reinterpret_cast<int*>(tx_s + tw_max * kx);
  int* xs_s = ys_s + rows;
  int* rj0 = xs_s + tw_max;                             // [yspan]
  int* rj1 = rj0 + yspan;

  const int tid = threadIdx.x;
  const int b = blockIdx.z / n_cblk;
  const int c0 = (blockIdx.z - b * n_cblk) * cc_max;
  const int cc = min(cc_max, C - c0);
  const int oh0 = blockIdx.y * rows;
  const int th = min(rows, h_out - oh0);
  const int ow0 = blockIdx.x * tw_max;
  const int tw = min(tw_max, w_out - ow0);

  for (int i = tid; i < th * ky; i += kThreads) ty_s[i] = ty[static_cast<int64_t>(oh0) * ky + i];
  for (int i = tid; i < tw * kx; i += kThreads) tx_s[i] = tx[static_cast<int64_t>(ow0) * kx + i];
  if (tid < th) ys_s[tid] = ys[oh0 + tid];
  for (int i = tid; i < tw; i += kThreads) xs_s[i] = xs[ow0 + i];
  __syncthreads();

  // the input rows [y_lo, y_lo + n_rows) that the tile's taps read, and for
  // each the output rows [rj0, rj1) whose taps read it
  const int y_lo = ys_s[0];
  const int n_rows = ys_s[th - 1] + ky - y_lo;
  for (int r = tid; r < n_rows; r += kThreads) {
    int j0 = th, j1 = 0;
    for (int j = th - 1; j >= 0; --j) {
      if (y_lo + r < ys_s[j] + ky) j0 = j;
      if (j1 == 0 && ys_s[j] <= y_lo + r) j1 = j + 1;
    }
    rj0[r] = j0;
    rj1[r] = j1;
  }
  __syncthreads();

  // 1. y-pass over the input columns [x_lo, x_lo + ws) that the tile's taps
  //    read: a thread takes V channels of one column (channels fastest where
  //    they are contiguous, else columns fastest), reads each input row once
  //    and adds it to the outputs whose taps read it, in row order (so each
  //    output's taps in order)
  const int x_lo = xs_s[0];
  const int ws = xs_s[tw - 1] + kx - x_lo;
  const T* xb = x + b * sb + c0 * sc + x_lo * sw + y_lo * sh;
  const int fast = chan_fast ? cc / V : ws;
  const int items = fast * (chan_fast ? ws : cc);
  const int df = kThreads % fast, ds = kThreads / fast;
  const int plane = cc_max * wsp;
  int f = tid % fast, sl = tid / fast;
  for (int p = tid; p < items; p += kThreads) {
    const int c = chan_fast ? f * V : sl;
    const int wl = chan_fast ? sl : f;
    const T* col = xb + c * sc + wl * sw;
    float* dst = tile + c * wsp + wl;
    for (int j = 0; j < th; ++j) {
#pragma unroll
      for (int e = 0; e < V; ++e) dst[j * plane + e * wsp] = 0.f;
    }
    for (int r0 = 0; r0 < n_rows; r0 += kBatch) {
      float v[kBatch][V];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (r0 + u < n_rows) load_v<V>(col + (r0 + u) * sh, v[u]);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = r0 + u;
        if (r < n_rows) {
          const int j1 = rj1[r];
          for (int j = rj0[r]; j < j1; ++j) {
            const float t = ty_s[j * ky + y_lo + r - ys_s[j]];
            float* d = dst + j * plane;
#pragma unroll
            for (int e = 0; e < V; ++e) d[e * wsp] = __fadd_rn(d[e * wsp], __fmul_rn(t, v[u][e]));
          }
        }
      }
    }
    f += df;
    sl += ds;
    if (f >= fast) {
      f -= fast;
      ++sl;
    }
  }
  __syncthreads();

  // 2. x-pass: a thread keeps one output column (tw_max is a power of two that
  //    divides kThreads) and its taps, and walks the (channel, row) pairs,
  //    channel fastest
  const int i = tid & (tw_max - 1);
  if (i >= tw) return;
  const int step = kThreads / tw_max;
  const int dc = step % cc, dj = step / cc;
  const int jc = tid / tw_max;
  int c = jc % cc, j = jc / cc;
  const float* t = tx_s + i * kx;
  float tr[kRegTaps];
#pragma unroll
  for (int k = 0; k < kRegTaps; ++k) tr[k] = k < kx ? t[k] : 0.f;
  const float* in = tile + (xs_s[i] - x_lo);
  T* ob = out + (static_cast<int64_t>(b) * C + c0) * h_out * w_out +
          static_cast<int64_t>(oh0) * w_out + ow0 + i;
  while (j < th) {
    const float* row = in + (j * cc_max + c) * wsp;
    float acc = 0.f;
    if (kx <= kRegTaps) {
#pragma unroll
      for (int k = 0; k < kRegTaps; ++k)
        if (k < kx) acc = __fadd_rn(acc, __fmul_rn(tr[k], row[k]));
    } else {
      for (int k = 0; k < kx; ++k) acc = __fadd_rn(acc, __fmul_rn(t[k], row[k]));
    }
    store_f(ob + (static_cast<int64_t>(c) * h_out + j) * w_out, acc);
    c += dc;
    j += dj;
    if (c >= cc) {
      c -= cc;
      ++j;
    }
  }
}

template <typename T>
int launch(const void* x, int B, int C, int64_t sb, int64_t sc, int64_t sh, int64_t sw,
           const int* ys, const float* ty, int h_out, int ky, const int* xs, const float* tx,
           int w_out, int kx, void* out, int rows, int tw, int cc, int wsp, int yspan, int smem,
           int chan_fast, int vec, void* stream) {
  if (B <= 0 || C <= 0 || h_out <= 0 || w_out <= 0) return static_cast<int>(cudaSuccess);
  if (rows < 1 || rows > kThreads || cc < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_cblk = (C + cc - 1) / cc;
  const int64_t n_th = (h_out + rows - 1) / rows;
  const int64_t n_z = static_cast<int64_t>(B) * n_cblk;
  if (tw < 1 || tw > kThreads || (tw & (tw - 1)) != 0 || wsp < 1 || yspan < 1 || smem < 1 ||
      smem > kSmemLimit || n_th > 65535 || n_z > 65535 ||
      (vec && (!chan_fast || sc != 1 || cc % 4 || C % 4 || sb % 4 || sh % 4 || sw % 4 ||
               reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)))))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w_out + tw - 1) / tw, static_cast<unsigned>(n_th), static_cast<unsigned>(n_z));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    resize_kernel<T, 4><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(x), C, sb, sc, sh, sw, ys, ty, ky, xs, tx, kx,
        static_cast<T*>(out), h_out, w_out, rows, tw, cc, wsp, yspan, n_cblk, chan_fast);
  else
    resize_kernel<T, 1><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(x), C, sb, sc, sh, sw, ys, ty, ky, xs, tx, kx,
        static_cast<T*>(out), h_out, w_out, rows, tw, cc, wsp, yspan, n_cblk, chan_fast);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, C, H, W) of dtype 0 f32, 1 bf16, 2 f16 with element strides
// (sb, sc, sh, sw); the y axis's tables ys (h_out,) i32, ty (h_out, ky) f32
// and the x axis's xs (w_out,) i32, tx (w_out, kx) f32, every start + k
// inside the input -> out (B, C, h_out, w_out) contiguous, of x's dtype.
// The tile, as kernels/resize.py:launch_shape sizes it: rows output rows,
// tw output columns and cc channels a CTA, wsp its row pitch (odd, at least
// the widest band of tw columns), yspan the widest band of input rows that
// `rows` output rows read, smem its shared memory in bytes; chan_fast:
// threads run along the channels (contiguous channels) rather than the
// columns; vec: 16-byte channel loads.
extern "C" int guava_resize(const void* x, int dtype, int B, int C, long long sb, long long sc,
                            long long sh, long long sw, const int* ys, const float* ty,
                            int h_out, int ky, const int* xs, const float* tx, int w_out,
                            int kx, void* out, int rows, int tw, int cc, int wsp, int yspan,
                            int smem, int chan_fast, int vec, void* stream) {
  switch (dtype) {
    case 0:
      return launch<float>(x, B, C, sb, sc, sh, sw, ys, ty, h_out, ky, xs, tx, w_out, kx, out,
                           rows, tw, cc, wsp, yspan, smem, chan_fast, vec, stream);
    case 1:
      return launch<__nv_bfloat16>(x, B, C, sb, sc, sh, sw, ys, ty, h_out, ky, xs, tx, w_out,
                                   kx, out, rows, tw, cc, wsp, yspan, smem, chan_fast, vec,
                                   stream);
    case 2:
      return launch<__half>(x, B, C, sb, sc, sh, sw, ys, ty, h_out, ky, xs, tx, w_out, kx,
                            out, rows, tw, cc, wsp, yspan, smem, chan_fast, vec, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Resident CTAs an SM of the float32 kernel at smem_bytes of shared memory.
extern "C" int guava_resize_occupancy(int smem_bytes, int* ctas) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, resize_kernel<float, 4>, kThreads, smem_bytes));
}
