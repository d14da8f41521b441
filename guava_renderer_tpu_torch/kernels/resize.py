"""R1: the separable banded bilinear resize of NCHW images
(`csrc/resize.cu`), with its tap tables and its backward.

A resize is one (n_out, n_in) operator a spatial axis: out = Wy . x . Wx^T
for each image and channel. Each row of a bilinear operator is a short band
of nonzero weights (8 of 2,048 at the frame's 2048 -> 512 downscale), so an
operator is kept as tap tables: `start` (n_out,) int32 and `taps`
(n_out, K) float32, K the widest band, with out[o] = sum_k taps[o, k] *
in[start[o] + k]. The taps are the operator's own float32 entries, zeros
between and beyond a row's nonzeros included, so the tables rebuild it
exactly; a start is moved back where its band would pass the input's end.
The adjoint, W^T's tables, lists the outputs that touch each input and
makes the backward the same gather.

`banded_resize` launches the kernel for CUDA tensors and runs the plain
version, `resize_plain`, for CPU tensors; its gradient is the same call on
the adjoint tables. There is no other path.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils.logging_utils import count
from . import build

launches = 0       # R1 kernel launches so far in this process

ROWS = 8                       # output rows a CTA
SMEM_LIMIT = 48 * 1024         # shared memory a CTA, without the opt-in attribute
TILE_OUTPUTS = 8192            # outputs a CTA, about, where the shared memory allows
MAX_COLUMNS = 128              # output columns a CTA
MAX_CHANNELS = 32              # channels a CTA
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class Band(NamedTuple):
    """One axis's operator (n_out, n_in) as tap tables on a device."""

    n_in: int
    n_out: int
    k: int
    start: torch.Tensor        # (n_out,) int32, non-decreasing, start + k <= n_in
    taps: torch.Tensor         # (n_out, k) float32
    spans: dict                # {columns a CTA (powers of two): the widest band they read}


class Axis(NamedTuple):
    """A resize along one axis: its operator's tables and its adjoint's."""

    fwd: Band
    adj: Band


def band_tables(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(n_out, n_in) float32 operator -> (start (n_out,) int32, taps
    (n_out, K) float32) with w[o, start[o] + k] = taps[o, k] and w zero
    elsewhere in row o. A row with no nonzero takes the start before it."""
    n_out, n_in = w.shape
    nz = w != 0
    any_nz = nz.any(axis=1)
    first = np.where(any_nz, nz.argmax(axis=1), 0)
    last = np.where(any_nz, n_in - 1 - nz[:, ::-1].argmax(axis=1), 0)
    k = int(max(1, (last - first + 1)[any_nz].max(initial=1)))
    start = np.minimum(first, n_in - k)
    start = np.maximum.accumulate(np.where(any_nz, start, 0))
    if np.any(start[any_nz] > first[any_nz]) or np.any(start + k < last + 1):
        raise ValueError("the operator's bands are not ordered along its rows")
    cols = start[:, None] + np.arange(k)
    return start.astype(np.int32), np.take_along_axis(w, cols, axis=1).astype(np.float32)


def band_spans(start: np.ndarray, k: int) -> dict:
    """{tw: the widest run of input columns that tw consecutive outputs
    (one CTA's, from a multiple of tw) read} for tw = 1, 2, 4, ...
    MAX_COLUMNS."""
    n = start.shape[0]
    out = {}
    tw = 1
    while tw <= MAX_COLUMNS:
        first = start[0::tw]
        last = start[np.minimum(np.arange(0, n, tw) + tw, n) - 1]
        out[tw] = int((last + k - first).max())
        tw *= 2
    return out


def make_band(w: np.ndarray, device) -> Band:
    """A (n_out, n_in) float32 operator's tap tables, on `device`."""
    start, taps = band_tables(w)
    return Band(w.shape[1], w.shape[0], taps.shape[1],
                torch.as_tensor(start, device=device), torch.as_tensor(taps, device=device),
                band_spans(start, taps.shape[1]))


def make_axis(w: np.ndarray, device) -> Axis:
    """A (n_out, n_in) float32 operator's forward and adjoint tables on
    `device`."""
    return Axis(make_band(w, device), make_band(np.ascontiguousarray(w.T), device))


def _sum_taps(x: torch.Tensor, band: Band, dim: int, dtype: torch.dtype) -> torch.Tensor:
    """sum_k taps[:, k] * x[start + k] along `dim`, in `dtype`, in tap order."""
    shape = [1] * x.dim()
    shape[dim] = band.n_out
    start = band.start.long()
    acc = None
    for k in range(band.k):
        term = band.taps[:, k].to(dtype).reshape(shape) * x.index_select(dim, start + k)
        acc = term + 0.0 if acc is None else acc + term     # from 0, as the kernel: -0 -> +0
    return acc


def resize_plain(x: torch.Tensor, by: Band, bx: Band) -> torch.Tensor:
    """x (B, C, H, W) -> (B, C, by.n_out, bx.n_out) of x's dtype: the
    y-pass then the x-pass, each a sum over the taps in order, in float32
    (float64 for float64 input), the intermediate unrounded."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    tmp = _sum_taps(x.to(dtype), by, 2, dtype)
    return _sum_taps(tmp, bx, 3, dtype).to(x.dtype)


def launch_shape(C: int, by: Band, bx: Band, chan_fast: bool) -> tuple[int, int, int, int]:
    """-> (tw output columns and cc channels a CTA, the tile's odd row pitch
    wsp, its shared memory in bytes) for about TILE_OUTPUTS outputs a CTA of
    ROWS output rows. This is the one place the tile's geometry and its
    shared memory (the float32 tile, both axes' taps and starts, and each
    input row's first and last output row) are worked out; the kernel is
    handed them.
    Where the channels are contiguous (`chan_fast`) a warp reads them, so a
    CTA takes up to MAX_CHANNELS of them and few columns; else a warp reads
    along a row, so a CTA takes up to MAX_COLUMNS columns and few channels.
    Then fewer columns, then fewer channels, until the tile fits in
    SMEM_LIMIT."""
    if chan_fast:
        cc = min(C, MAX_CHANNELS)
        want = -(-TILE_OUTPUTS // (ROWS * cc))
    else:
        want = MAX_COLUMNS
    tw = 1
    while tw < min(want, bx.n_out, MAX_COLUMNS):
        tw *= 2
    if not chan_fast:
        cc = min(C, MAX_CHANNELS, max(1, TILE_OUTPUTS // (ROWS * tw)))
    while True:
        wsp = bx.spans[tw] | 1
        smem = 4 * (ROWS * cc * wsp + ROWS * by.k + tw * bx.k + ROWS + tw + 2 * by.spans[ROWS])
        if smem <= SMEM_LIMIT:
            return tw, cc, wsp, smem
        if tw > 1:
            tw //= 2
        elif cc > 1:
            cc = (cc + 1) // 2
        else:
            raise ValueError(f"a resize band of {bx.spans[1]} columns and {by.k} taps does "
                             f"not fit one CTA's shared memory")


def vector_loads(x: torch.Tensor, cc: int, chan_fast: bool) -> bool:
    """Whether a thread reads 4 channels at once: contiguous channels, in
    blocks of 4 from an aligned start, and every other stride a multiple of 4."""
    sb, sc, sh, sw = x.stride()
    return (chan_fast and sc == 1 and x.shape[1] % 4 == 0 and cc % 4 == 0
            and sb % 4 == 0 and sh % 4 == 0 and sw % 4 == 0
            and x.data_ptr() % (4 * x.element_size()) == 0)


def _check(x: torch.Tensor, by: Band, bx: Band) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    if tuple(x.shape[2:]) != (by.n_in, bx.n_in):
        raise ValueError(f"x is {tuple(x.shape[2:])} spatially, the tables take "
                         f"({by.n_in}, {bx.n_in})")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x on {x.device}: the resize runs on the CPU or a CUDA device")
    if x.device.type == "cuda":
        if x.dtype not in DTYPES:
            raise ValueError(f"the resize kernel takes float32, bfloat16 or float16, "
                             f"got {x.dtype}")
        if by.start.device != x.device or bx.start.device != x.device:
            raise ValueError(f"x on {x.device}, tables on {by.start.device}, {bx.start.device}")


def resize(x: torch.Tensor, by: Band, bx: Band) -> torch.Tensor:
    """x (B, C, H, W) CUDA, any strides -> (B, C, by.n_out, bx.n_out)
    contiguous, of x's dtype, in one launch on the current stream."""
    global launches
    _check(x, by, bx)
    B, C = x.shape[:2]
    out = torch.empty((B, C, by.n_out, bx.n_out), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    sb, sc, sh, sw = x.stride()
    chan_fast = sc < sw
    tw, cc, wsp, smem = launch_shape(C, by, bx, chan_fast)
    vec = vector_loads(x, cc, chan_fast)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().guava_resize(
            x.data_ptr(), DTYPES[x.dtype], B, C, sb, sc, sh, sw,
            by.start.data_ptr(), by.taps.data_ptr(), by.n_out, by.k,
            bx.start.data_ptr(), bx.taps.data_ptr(), bx.n_out, bx.k,
            out.data_ptr(), ROWS, tw, cc, wsp, by.spans[ROWS], smem, int(chan_fast), int(vec),
            stream)
    build.check(err, "guava_resize")
    launches += 1
    count("resize.launches", 1)
    return out


def _apply(x: torch.Tensor, by: Band, bx: Band) -> torch.Tensor:
    if x.device.type == "cuda":
        return resize(x, by, bx)
    _check(x, by, bx)
    return resize_plain(x, by, bx)


class _BandedResize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ay, ax):
        ctx.axes = (ay, ax)
        return _apply(x, ay.fwd, ax.fwd)

    @staticmethod
    def backward(ctx, g):
        ay, ax = ctx.axes
        return _apply(g, ay.adj, ax.adj), None, None


def banded_resize(x: torch.Tensor, ay: Axis, ax: Axis) -> torch.Tensor:
    """x (B, C, H, W) -> Wy . x . Wx^T (B, C, h, w) through the axes' tap
    tables; differentiable in x (the backward: the adjoint tables)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _BandedResize.apply(x, ay, ax)
    return _apply(x, ay.fwd, ax.fwd)


def occupancy(smem_bytes: int) -> int:
    """Resident CTAs an SM of the float32 kernel at `smem_bytes` a CTA
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    ctas = ctypes.c_int()
    build.check(build.library().guava_resize_occupancy(smem_bytes, ctypes.addressof(ctas)),
                "guava_resize_occupancy")
    return ctas.value
