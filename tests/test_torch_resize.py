"""The resize's tap tables and its plain banded version (`kernels/resize.py`)
at every ratio the port's callers use, on the CPU.

Each case: the tables rebuild the dense interpolation matrix exactly and
the adjoint's are its transpose; the banded forward equals the dense einsum
in float64; the autograd Function's gradient equals the einsum's; a strided
NHWC view resizes as its contiguous copy; a second call uploads nothing.
A numpy walk of the kernel's CTAs (`launch_shape`'s tiles, each tile's
band of input columns, its shared row pitch) equals the plain version bit
for bit, which is what the kernel is held to on the card.
"""

import numpy as np
import pytest
import torch

from guava_renderer_tpu_torch.kernels import resize as kresize
from guava_renderer_tpu_torch.models import layers as tlayers
from guava_renderer_tpu_torch.utils import logging_utils as lu

torch.set_num_threads(2)

# (n_in, n_out, align_corners, antialias)
RATIOS = {
    "frame down": (2048, 512, False, True),        # the renderer, before the refiner
    "frame up": (512, 2048, False, True),          # the renderer, after it
    "refine 720": (720, 512, False, True),
    "source 518": (518, 512, False, True),         # creation's image resize (3 taps)
    "rgb pyramid 148": (518, 148, False, True),    # DPT's RGB pyramid
    "rgb pyramid 19": (518, 19, False, True),
    "dpt path": (296, 512, False, False),          # DPT's half-pixel resizes (antialias off)
    "dpt image": (518, 512, False, False),
    "dpt micro": (19, 37, False, False),
    "low x2": (37, 74, True, True),                # DPT's align-corners resizes
    "low x4": (74, 296, True, True),
    "vit grid down": (37, 16, False, True),        # the position grid
    "vit grid up": (16, 37, False, True),
    "styleunet up": (28, 32, False, True),
    "multiscale /4": (512, 128, False, True),      # multiscale_l2
    "lpips floor": (16, 32, False, True),          # LPIPS's 32-pixel floor
    "ac 1 to 2": (1, 2, True, True),
    "ac 2 to 4": (2, 4, True, True),
    "to one": (5, 1, False, True),
}


def _dense(n_in, n_out, align, antialias):
    if align:
        return tlayers._ac_weights(n_in, n_out)
    return tlayers._halfpix_weights(n_in, n_out, antialias)


def _rebuild(band):
    w = np.zeros((band.n_out, band.n_in), np.float32)
    for o, (s, t) in enumerate(zip(band.start.numpy(), band.taps.numpy())):
        w[o, s:s + band.k] = t
    return w


def _companion(n):
    """The other axis of a case's image: an eighth of its size, at least 3."""
    return max(3, n // 8)


@pytest.mark.parametrize("name", list(RATIOS))
def test_banded_resize(name):
    n_in, n_out, align, antialias = RATIOS[name]
    w = _dense(n_in, n_out, align, antialias)
    ay = kresize.make_axis(w, "cpu")
    assert np.array_equal(_rebuild(ay.fwd), w)
    assert np.array_equal(_rebuild(ay.adj), w.T)
    starts = ay.fwd.start.numpy()
    assert np.all(np.diff(starts) >= 0) and starts[-1] + ay.fwd.k <= n_in

    # the other axis at its own ratio, so rows and columns take different tables
    m_in, m_out = _companion(n_in), _companion(n_out)
    wx = _dense(m_in, m_out, align, antialias)
    ax = kresize.make_axis(wx, "cpu")
    rng = np.random.default_rng(n_in * 7 + n_out)
    x = torch.tensor(rng.normal(size=(1, 2, n_in, m_in)), requires_grad=True)
    got = kresize.banded_resize(x, ay, ax)
    want = torch.einsum("bchw,ow->bcho",
                        torch.einsum("bchw,oh->bcow", x, torch.from_numpy(w).double()),
                        torch.from_numpy(wx).double())
    assert got.shape == (1, 2, n_out, m_out)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-12, rtol=0)

    g = torch.tensor(rng.normal(size=got.shape))
    (gx,) = torch.autograd.grad(got, x, g)
    (want_gx,) = torch.autograd.grad(want, x, g)
    np.testing.assert_allclose(gx.numpy(), want_gx.numpy(), atol=1e-12, rtol=0)

    # a strided NHWC view (the renderer's features) against its contiguous copy, float32
    nhwc = torch.tensor(rng.normal(size=(1, n_in, m_in, 5)), dtype=torch.float32)
    view = nhwc.permute(0, 3, 1, 2)
    assert not view.is_contiguous()
    assert torch.equal(kresize.banded_resize(view, ay, ax),
                       kresize.banded_resize(view.contiguous(), ay, ax))

    # resize_bilinear makes each axis's tables once
    tlayers._resize_axis.cache_clear()
    lu.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tlayers.resize_bilinear(view, (n_out, m_out), align_corners=align, antialias=antialias)
        first = lu.counters().get("resize.table_uploads", 0)
        tlayers.resize_bilinear(view, (n_out, m_out), align_corners=align, antialias=antialias)
    assert first == len({(n_in, n_out), (m_in, m_out)})
    assert lu.counters()["resize.table_uploads"] == first
    lu.reset_counters()


def _tiled_model(x, by, bx, chan_fast):
    """The kernel's walk in numpy, float32: CTAs of ROWS output rows, tw
    columns and cc channels (`launch_shape`), each summing its y-pass into a
    tile of pitch wsp over its band of input columns, then its x-pass from
    the tile, every sum in tap order with rounded products and adds."""
    B, C = x.shape[:2]
    tw, cc, wsp, smem = kresize.launch_shape(C, by, bx, chan_fast)
    assert smem <= kresize.SMEM_LIMIT and wsp % 2 == 1
    ys, ty = by.start.numpy(), by.taps.numpy()
    xs, tx = bx.start.numpy(), bx.taps.numpy()
    out = np.full((B, C, by.n_out, bx.n_out), np.nan, np.float32)
    for b in range(B):
        for c0 in range(0, C, cc):
            chans = slice(c0, min(c0 + cc, C))
            for oh0 in range(0, by.n_out, kresize.ROWS):
                rows = range(oh0, min(oh0 + kresize.ROWS, by.n_out))
                for ow0 in range(0, bx.n_out, tw):
                    cols = range(ow0, min(ow0 + tw, bx.n_out))
                    x_lo = xs[cols[0]]
                    ws = xs[cols[-1]] + bx.k - x_lo
                    assert ws <= wsp
                    tile = np.full((C, len(rows), wsp), np.nan, np.float32)
                    acc = np.zeros((len(range(C)[chans]), len(rows), ws), np.float32)
                    for k in range(by.k):        # each row's taps, in order
                        acc = acc + (ty[rows, k][None, :, None]
                                     * x[b, chans][:, ys[rows] + k, x_lo:x_lo + ws])
                    tile[chans, :, :ws] = acc
                    acc = np.zeros((len(range(C)[chans]), len(rows), len(cols)), np.float32)
                    for k in range(bx.k):        # each column's taps, in order
                        acc = acc + tx[cols, k] * tile[chans][:, :, xs[cols] - x_lo + k]
                    out[b, chans, oh0:oh0 + len(rows), ow0:ow0 + len(cols)] = acc
    return out


@pytest.mark.parametrize("name,channels,chan_fast", [
    ("frame down", 4, True), ("frame up", 3, False), ("rgb pyramid 19", 40, True),
    ("rgb pyramid 19", 3, False), ("low x4", 2, False), ("vit grid up", 33, True),
    ("ac 1 to 2", 1, False), ("to one", 3, True), ("dpt path", 5, False)])
def test_kernel_walk_equals_plain(name, channels, chan_fast):
    """The numpy walk of the kernel's CTAs (launch_shape's tiles, partial
    ones at the edges, channel blocks) is bit-equal to the plain version."""
    n_in, n_out, align, antialias = RATIOS[name]
    by = kresize.make_band(_dense(n_in, n_out, align, antialias), "cpu")
    m_in, m_out = _companion(n_in) + 1, _companion(n_out) + 1
    bx = kresize.make_band(_dense(m_in, m_out, align, antialias), "cpu")
    x = np.random.default_rng(channels).normal(size=(2, channels, n_in, m_in)).astype(np.float32)
    want = kresize.resize_plain(torch.from_numpy(x), by, bx).numpy()
    np.testing.assert_array_equal(_tiled_model(x, by, bx, chan_fast), want)


def test_launch_shape_fits_the_frame():
    """The frame's two resizes within 48 KB of shared memory a CTA; the
    downscale's NHWC features a warp's 32 channels, the upscale's NCHW RGB
    a warp's run along a row."""
    down = kresize.make_band(_dense(2048, 512, False, True), "cpu")
    up = kresize.make_band(_dense(512, 2048, False, True), "cpu")
    assert kresize.launch_shape(32, down, down, True) == (8, 32, 37, 38752)
    assert kresize.launch_shape(3, up, up, False) == (128, 3, 35, 5024)


def test_band_tables_refuse_unordered_rows():
    w = np.eye(4, dtype=np.float32)[::-1].copy()      # row o reads input 3 - o
    with pytest.raises(ValueError, match="not ordered"):
        kresize.band_tables(w)


def test_half_precision_sums_in_float32():
    """bf16 in, bf16 out, the sums float32 and the intermediate unrounded."""
    by = kresize.make_band(_dense(37, 16, False, True), "cpu")
    x = torch.randn(1, 2, 37, 37).to(torch.bfloat16)
    got = kresize.resize_plain(x, by, by)
    assert got.dtype == torch.bfloat16
    want = kresize.resize_plain(x.float(), by, by).to(torch.bfloat16)
    assert torch.equal(got, want)
