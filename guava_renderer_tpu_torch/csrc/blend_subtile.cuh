// The sub-tile walk shared by every forward blend and the backward K3
// (blend_bwd.cu). The forward blends are one kernel (blend_subtile_fwd.cuh)
// with four row sources: the tile blend K1 (blend.cu) and the probe K1p
// (blend_probe.cu) read the (P, 44) table, the resident-table blend K7
// (blend_resident.cu) that table or its resident table, the bf16-row blend
// K6 (blend_bf16.cu) packed rows, and the stream blend K8 (blend_stream.cu)
// a per-instance stream. This file holds how a bin tile is cut into
// sub-tiles, one CTA each; how a round's rows are staged, two buffers deep,
// by the bulk copy engine, from the address a row source gives; and the
// exact row cull that drops the rows no pixel of a warp can take.
//
// Sub-tiles. A bin tile (its instances order[ranges[t] : ranges[t + 1]])
// is walked by (tile / sub)^2 CTAs of sub^2 pixels, one thread a pixel,
// where sub = 16 for tiles that are multiples of 16, 8 for other multiples
// of 8, else the tile itself. The CTAs of one bin tile have neighbouring
// blockIdx values, so they run at about the same time and L2 serves the
// rows they all read. Inside a sub-tile of side 8 or 16 each warp covers an
// 8 x 4 block of pixels (warps row-major over the sub-tile): neighbouring
// pixels tend to take the same rows, so fewer lanes idle in the 33-FMA
// accumulation than in a 32 x 1 strip. Other sides lay the pixels out
// row-major, and the threads past sub^2 (the CTA is a whole number of
// warps) hold no pixel.
//
// Staging. A round is up to a Stage's rows_a_round rows (K1 128, K3 64;
// K1p its `chunk`, up to 256). Each row is one bulk copy of the Stage's
// row_bytes (176; K6's packed rows 112), issued by one thread, that
// completes on its buffer's mbarrier; the barrier expects the round's
// bytes. Instance i of a run has the row id row_id(src, order, i): order[i]
// for the table sources, i for the stream. With a Stage of depth buffers,
// round r + depth - 1 is issued as round r starts, so the copies land while
// earlier rounds are culled and walked (RowPipe).
//
// The cull. Once a round has landed, each warp tests the round's rows (one
// lane a row) against the box of its own pixel centres (8 x 4 in a
// sub-tile of side 8 or 16) by the JAX package's box test
// (guava_renderer_tpu/ops/gsplat.py:234 _slot_qmin, :179 _cull_qcut, on a
// rectangle): the exact minimum of the conic quadratic
// q(d) = a dx^2 + 2 b dx dy + c dy^2 over the box, against the q above
// which alpha * exp(-q / 2) falls below 1/255, 2 ln(max(255 alpha, 1)) +
// 1e-3. A row whose minimum lies above that cut, by more than kCullSlack of
// the largest quadratic term over the box, is dropped. The survivors' bits
// are the warp's mask, in registers: the walk iterates over them, and no
// barrier stands between the copies landing and the walk. Why the image
// cannot change: a pixel takes a row only if power <= 0 and
// alpha * exp(power) >= 1/255 (blend_common.cuh), and otherwise leaves T,
// its sums and its `done` as they were. For a dropped row every pixel
// centre p of the box has q(p) >= min q over the box, and float32 rounding
// moves the kernel's power = -q(p) / 2 and the cull's minimum by at most
// ~12 units in the last place of that largest term (d0, d1, three products
// and two sums each; the box edges and the clamped point rounded once
// more), which the slack (64 units) covers; the 1e-3 covers expf's error
// and the rounding of the cut. So the kernel's own float32 test rejects the
// row at every pixel of the box: each pixel sees the rows it would have
// taken, in the same order, and takes the same decisions and sums bit for
// bit. Rows with a non-finite field and conics that are not positive
// definite are never dropped.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "async_copy.cuh"
#include "blend_bf16_rows.cuh"
#include "blend_common.cuh"

namespace guava_blend {

constexpr uint32_t kRowBytes = kRow * 4;      // 176: one bulk copy a row
constexpr int kMaxSubThreads = 256;
constexpr float kCullSlack = 1.0f / 262144.0f;   // 2^-18, 64 units in the last place

// The side of the sub-tiles a bin tile of side `tile` is cut into.
__host__ __device__ inline int subtile_side(int tile) {
  return tile % 16 == 0 ? 16 : (tile % 8 == 0 ? 8 : tile);
}

// Threads of a sub-tile CTA: sub^2 rounded up to whole warps.
__host__ __device__ inline int subtile_threads(int tile) {
  const int s = subtile_side(tile);
  return (s * s + 31) / 32 * 32;
}

__host__ __device__ inline int subtiles_per_tile(int tile) {
  const int n = tile / subtile_side(tile);
  return n * n;
}

// CTAs of a blend over an image tiled by `tile`: one a sub-tile.
inline int subtile_ctas(int height, int width, int tile) {
  return (width / tile) * (height / tile) * subtiles_per_tile(tile);
}

// This CTA's sub-tile and this thread's pixel.
struct SubTile {
  int tile_id;   // the bin tile, whose rows are order[ranges[tile_id] : ranges[tile_id + 1]]
  int x0, y0;    // the sub-tile's first pixel
  int side;
  int px, py;    // this thread's pixel
  bool active;   // false for the threads past side^2
};

__device__ __forceinline__ SubTile subtile_of(int tile, int grid_x) {
  SubTile st;
  st.side = subtile_side(tile);
  const int per_side = tile / st.side;
  const int spt = per_side * per_side;
  st.tile_id = blockIdx.x / spt;
  const int s = blockIdx.x - st.tile_id * spt;
  st.x0 = (st.tile_id % grid_x) * tile + (s % per_side) * st.side;
  st.y0 = (st.tile_id / grid_x) * tile + (s / per_side) * st.side;
  const int t = threadIdx.x;
  int lx, ly;
  if (st.side % 8 == 0) {   // warp w an 8 x 4 block, the warps row-major over the sub-tile
    const int w = t >> 5;
    const int lane = t & 31;
    const int blocks_x = st.side / 8;
    lx = (w % blocks_x) * 8 + (lane & 7);
    ly = (w / blocks_x) * 4 + (lane >> 3);
  } else {
    lx = t % st.side;
    ly = t / st.side;
  }
  st.active = t < st.side * st.side;
  st.px = st.x0 + lx;
  st.py = st.y0 + ly;
  return st;
}

// Whether the staged row s may contribute to a pixel whose centre lies in
// the box [x0, x0 + span_x] x [y0, y0 + span_y]; false only where no pixel
// centre of the box can pass the blend's tests (see the head of this file).
// The expressions are those of _slot_qmin and _cull_qcut.
__device__ __forceinline__ bool row_may_reach(const float* s, float x0, float y0, float span_x,
                                              float span_y) {
  const float mx = s[0], my = s[1], ca = s[2], cb = s[3], cc = s[4], a = s[5];
  if (!(isfinite(mx) && isfinite(my) && isfinite(ca) && isfinite(cb) && isfinite(cc) &&
        isfinite(a))) {
    return true;
  }
  if (!(ca > 0.0f && cc > 0.0f && ca * cc - cb * cb > 0.0f)) return true;   // not positive definite
  const float bx0 = x0 - mx, bx1 = bx0 + span_x;
  const float by0 = y0 - my, by1 = by0 + span_y;
  if (bx0 <= 0.0f && bx1 >= 0.0f && by0 <= 0.0f && by1 >= 0.0f) return true;   // min q = 0
  // each edge: one offset fixed, the quadratic's minimum over the other clamped to the edge
  auto edge_x = [&](float e) {
    const float dy = fminf(fmaxf(-cb * e / fmaxf(cc, 1e-20f), by0), by1);
    return (ca * e + 2.0f * cb * dy) * e + cc * dy * dy;
  };
  auto edge_y = [&](float e) {
    const float dx = fminf(fmaxf(-cb * e / fmaxf(ca, 1e-20f), bx0), bx1);
    return (cc * e + 2.0f * cb * dx) * e + ca * dx * dx;
  };
  const float qmin = fminf(fminf(edge_x(bx0), edge_x(bx1)), fminf(edge_y(by0), edge_y(by1)));
  const float qcut = 2.0f * logf(fmaxf(255.0f * a, 1.0f)) + 1e-3f;
  const float ex = fmaxf(fabsf(bx0), fabsf(bx1));
  const float ey = fmaxf(fabsf(by0), fabsf(by1));
  const float largest = ca * ex * ex + 2.0f * fabsf(cb) * ex * ey + cc * ey * ey;
  return !(qmin > qcut + kCullSlack * largest);   // an overflow to inf keeps the row
}

// kDepth buffers of up to kRows staged rows (176 B each), their barriers
// and Gaussian ids: kDepth - 1 rounds in flight.
template <int kRows, int kDepth>
struct RowStage {
  static constexpr int rows_a_round = kRows;
  static constexpr int depth = kDepth;
  static constexpr int words = kRows / 32;   // words of a round's keep mask
  static constexpr uint32_t row_bytes = kRowBytes;
  float4 rows[kDepth][kRows * kRow4];
  uint64_t bar[kDepth];
  int gids[kDepth][kRows];
  // where row t of buffer b lands
  __device__ __forceinline__ void* landing(int b, int t) { return &rows[b][t * kRow4]; }
  // The f32 rows of buffer b, which holds n landed rows. Called by every
  // thread, after it has waited for the round.
  __device__ __forceinline__ const float4* landed(int b, int) const { return rows[b]; }
};

// K6's stage: kDepth buffers of kRows packed rows (112 B each) that the bulk
// copies fill, and one buffer of kRows f32 rows that the round being walked
// is widened into (at 128 rows and depth 2, 51 KB: three CTAs an SM still
// fit, as K1's).
template <int kRows, int kDepth>
struct PackedStage {
  static constexpr int rows_a_round = kRows;
  static constexpr int depth = kDepth;
  static constexpr int words = kRows / 32;
  static constexpr uint32_t row_bytes = kPackedBytes;
  uint4 packed[kDepth][kRows * (kPackedBytes / 16)];
  float4 rows[kRows * kRow4];
  uint64_t bar[kDepth];
  int gids[kDepth][kRows];
  __device__ __forceinline__ void* landing(int b, int t) {
    return &packed[b][t * (kPackedBytes / 16)];
  }
  // Widen the n packed rows of buffer b into the f32 buffer, which every
  // thread has left at the round's opening barrier (the buffer of round
  // r - 1); the barrier after it publishes the rows. Packed buffer b is free
  // again once that barrier has passed. Called as RowStage::landed.
  __device__ __forceinline__ const float4* landed(int b, int n) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(packed[b]);
    for (int i = threadIdx.x; i < n * kRow4; i += blockDim.x) {
      const int r = i / kRow4;
      rows[i] = widen_packed4(p + r * kPackedWords, i - r * kRow4);
    }
    __syncthreads();
    return rows;
  }
};

// The forward walk's stage (blend_subtile_fwd.cuh): 128 rows a round, two
// buffers, one round in flight while one is walked.
constexpr int kFwdRows = 128;
constexpr int kFwdDepth = 2;

// The box of a warp's pixel centres: (x0, y0) and the spans.
struct WarpBox {
  float x0, y0, span_x, span_y;
};

// This warp's box, the bounds of its lanes' pixels (lanes without a pixel
// take no part). Called by every lane of the warp.
__device__ __forceinline__ WarpBox warp_box(const SubTile& sub) {
  int x_lo = sub.active ? sub.px : 1 << 30, y_lo = sub.active ? sub.py : 1 << 30;
  int x_hi = sub.active ? sub.px : -1, y_hi = sub.active ? sub.py : -1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x_lo = min(x_lo, __shfl_xor_sync(0xffffffffu, x_lo, off));
    y_lo = min(y_lo, __shfl_xor_sync(0xffffffffu, y_lo, off));
    x_hi = max(x_hi, __shfl_xor_sync(0xffffffffu, x_hi, off));
    y_hi = max(y_hi, __shfl_xor_sync(0xffffffffu, y_hi, off));
  }
  return WarpBox{static_cast<float>(x_lo), static_cast<float>(y_lo),
                 static_cast<float>(x_hi - x_lo), static_cast<float>(y_hi - y_lo)};
}

// Call from thread 0, then __syncthreads, before the first round is issued.
template <class Stage>
__device__ __forceinline__ void stage_init(Stage& st) {
  for (int b = 0; b < Stage::depth; ++b) guava_copy::barrier_init(&st.bar[b]);
  guava_copy::fence_barrier_init();
}

// Where the row of id `gid` comes from: RowPipe's row source, and
// FwdStage, the stage its rows land in on the forward walk. Instance i of
// a run has the row id row_id(src, order, i) (below): order[i] for the
// table sources, i for the stream.
// PlainRows: the (P, 44) table, for K1, K1p and K3.
struct PlainRows {
  using FwdStage = RowStage<kFwdRows, kFwdDepth>;
  const float4* __restrict__ rows;
  __device__ __forceinline__ const float4* row(int gid) const {
    return rows + static_cast<int64_t>(gid) * kRow4;
  }
};

// ResidentRows: K7's two tables. An id >= P (n_rows) reads the resident
// table ltable (L = n_resident rows) at id - P, clipped to L - 1 as the TPU
// kernel (guava_renderer_tpu/ops/gsplat.py:1227 _fwd_kernel_vmem) clips it;
// any other id reads rows. Both tables' rows must start on 16 bytes.
struct ResidentRows {
  using FwdStage = RowStage<kFwdRows, kFwdDepth>;
  const float4* __restrict__ rows;
  const float4* __restrict__ ltable;
  int n_rows;
  int n_resident;
  __device__ __forceinline__ const float4* row(int gid) const {
    return gid >= n_rows ? ltable + static_cast<int64_t>(min(gid - n_rows, n_resident - 1)) * kRow4
                         : rows + static_cast<int64_t>(gid) * kRow4;
  }
};

// PackedBf16Rows: K6's (P, 56) bf16 table (blend_bf16_rows.cuh), rows of
// 112 bytes, 16-byte aligned; they land packed and are widened to f32 rows
// before the cull (PackedStage::landed).
struct PackedBf16Rows {
  using FwdStage = PackedStage<kFwdRows, kFwdDepth>;
  const uint4* __restrict__ rows;
  __device__ __forceinline__ const uint4* row(int gid) const {
    return rows + static_cast<int64_t>(gid) * (kPackedBytes / 16);
  }
};

// StreamRows: K8's (N, 44) f32 stream, one row an instance in the sorted
// order, so instance i's row is stream row i: no `order` is read, and a
// round's rows are one contiguous run of n x 176 bytes, which one bulk
// copy from thread 0 brings (RowPipe::issue_next).
struct StreamRows {
  using FwdStage = RowStage<kFwdRows, kFwdDepth>;
  static constexpr bool contiguous = true;
  const float4* __restrict__ stream;
  __device__ __forceinline__ const float4* row(int i) const {
    return stream + static_cast<int64_t>(i) * kRow4;
  }
};

// Whether a source's rows for consecutive instances are consecutive in
// memory (Src::contiguous; false where a source does not say).
template <class Src, class = void>
struct contiguous_rows : std::false_type {};
template <class Src>
struct contiguous_rows<Src, std::void_t<decltype(Src::contiguous)>>
    : std::bool_constant<Src::contiguous> {};

// The row id of instance i of a run: i itself where the source's rows are
// contiguous (the stream), else order[i]. The index keeps the caller's type
// (unsigned for a thread's first row), so the load is the one order[i]
// would compile to.
template <class Src, class Index>
__device__ __forceinline__ int row_id(const Src&, const int* __restrict__ order, Index i) {
  if constexpr (contiguous_rows<Src>::value) {
    return static_cast<int>(i);
  } else {
    return order[i];
  }
}

// The rounds of a CTA's run, instances start .. end - 1, through a Stage.
// Round r is its instances r R .. r R + R - 1, R = min(rows, threads) as a
// rule, so a thread issues at most one row's copy a round, and it loads
// that row's id one issue ahead: the id's latency hides behind a round, and
// the copy's behind the depth - 1 rounds in flight (where the source's rows
// are contiguous, as the stream's, the round is one copy from thread 0).
// With kWide (K1p, whose round is its `chunk` whatever the threads) R = rows
// and a thread issues rows t, t + threads, ..., the ids past the first
// loaded as it issues.
// Round r lives in buffer r % depth, that buffer's (r / depth)-th use.
// `Src` gives each instance's row id and address, the Stage where the row
// lands and how many bytes it has.
template <class Stage, class Src, bool kWide = false>
struct RowPipe {
  static constexpr int kDepth = Stage::depth;
  Stage& st;
  const Src src;
  const int* __restrict__ order;
  int start, end, R, n_rounds;
  int next;     // the next round to issue
  int gid;      // the id of this thread's row in round `next`
  bool gids;    // record the ids (the backward's flush reads them; not with kWide)

  __device__ RowPipe(Stage& st_, const Src& src_, const int* order_, int start_, int end_,
                     int rows, bool gids_)
      : st(st_), src(src_), order(order_), start(start_), end(end_), next(0), gid(0),
        gids(gids_) {
    R = kWide ? rows : min(rows, static_cast<int>(blockDim.x));
    n_rounds = (end - start + R - 1) / R;
    if (static_cast<int>(threadIdx.x) < rows_in(0)) gid = row_id(src, order, start + threadIdx.x);
  }

  __device__ int rows_in(int r) const { return max(0, min(R, end - start - r * R)); }

  // Start round `next`'s copies; its buffer must be free (walked, and for K3
  // flushed, by every thread). Called by every thread.
  __device__ void issue_next() {
    const int b = next % kDepth;
    const int n = rows_in(next);
    const int t = threadIdx.x;
    if constexpr (contiguous_rows<Src>::value) {
      // the round's rows are contiguous: one copy of n rows
      if (t == 0) {
        guava_copy::expect_bytes(&st.bar[b], n * Stage::row_bytes);
        guava_copy::bulk_copy(st.landing(b, 0), src.row(start + next * R), n * Stage::row_bytes,
                              &st.bar[b]);
      }
      ++next;
      return;
    }
    if (t == 0) guava_copy::expect_bytes(&st.bar[b], n * Stage::row_bytes);
    if (t < n) {
      if (gids) st.gids[b][t] = gid;
      guava_copy::bulk_copy(st.landing(b, t), src.row(gid), Stage::row_bytes, &st.bar[b]);
    }
    if constexpr (kWide) {
      for (int u = t + blockDim.x; u < n; u += blockDim.x) {
        guava_copy::bulk_copy(st.landing(b, u), src.row(row_id(src, order, start + next * R + u)),
                              Stage::row_bytes, &st.bar[b]);
      }
    }
    ++next;
    if (t < rows_in(next)) gid = row_id(src, order, start + next * R + t);
  }

  // The first depth - 1 rounds, before the walk starts.
  __device__ void prologue() {
    while (next < min(kDepth - 1, n_rounds)) issue_next();
  }

  __device__ void wait(int r) {
    guava_copy::wait_parity(&st.bar[r % kDepth], static_cast<uint32_t>((r / kDepth) & 1));
  }

  // Before the CTA leaves at round r: every issued copy must have landed.
  __device__ void drain(int r) {
    for (int q = r; q < next; ++q) wait(q);
  }
};

// The cull of a round's n landed rows (`rows_b`, the round's buffer) for
// this warp's box: bit i of keep[k] is row 32 k + i. Called by every lane
// of the warp, after it has waited for the round.
template <int kWords>
__device__ __forceinline__ void cull_warp(const float4* rows_b, int n, const WarpBox& box,
                                          uint32_t (&keep)[kWords]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int j = k * 32 + lane;
    const bool may = j < n && row_may_reach(reinterpret_cast<const float*>(rows_b + j * kRow4),
                                            box.x0, box.y0, box.span_x, box.span_y);
    keep[k] = __ballot_sync(0xffffffffu, may);
  }
}

}  // namespace guava_blend
