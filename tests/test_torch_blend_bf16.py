"""Port vs JAX: the bf16-row blend (K6's plain version) and its gradient.

The JAX side is `rasterize` with `bf16_rows=True` (Pallas forward and
backward in interpret mode, chunk 8, duplication cap = the whole tile grid,
so nothing is truncated). Packing is compared bit for bit; images to atol
1e-4; gradients, after division by the JAX gradient's largest entry, to
atol 2e-4, as tests/test_torch_gsplat_grad.py holds the f32 path: both
packages blend exactly the unpacked rows they packed, and the rows differ
only by the projection's float error, which can move a lo half by one bf16
step (~2^-16 of the value).

K6 walks K1's sub-tile cut and cull (`csrc/blend_subtile_fwd.cuh`) on the
f32 rows it widens its packed rows to (`csrc/blend_bf16_rows.cuh`). So:
the culled walk on the unpacked rows equals `blend_bf16_plain` bit for bit
on the cull tests' frames at tiles 8, 16 and 32; the cull stays
conservative on rows that went through the packing (lo halves non-zero,
opacities at the 1/255 edge); and the widening, compiled by the host's g++
against a shim of the three CUDA functions it calls, gives the bits of
`unpack_rows_bf16` (NaN where it gives NaN), signed zeros, subnormals,
infinities and a non-zero pad included.
"""

import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings

from guava_renderer_tpu.ops import gsplat as jgs
from guava_renderer_tpu_torch.kernels import blend as tk
from guava_renderer_tpu_torch.ops import gsplat as tgs
from guava_renderer_tpu_torch.ops.gsplat import bin_gaussians

from test_torch_blend_cull import FRAMES, _contributing, _rows
from test_torch_gsplat import C, _j, _t, jax_settings, make_cams, make_scene

torch.set_num_threads(2)
NAMES = ("means", "colors", "opac", "scales", "quats")
ATOL = 1e-4
GRAD_ATOL = 2e-4


def spaced_scene(seed, P=32):
    """make_scene's draws with the depths replaced by a shuffled ladder 1/P
    apart: the JAX size-class and streaming paths sort on the top bits of
    the depth and break ties by duplication order, the port by id."""
    means, colors, opac, scales, quats = make_scene(seed, P=P)
    means[:, 2] = 2.5 + np.random.default_rng(seed + 1).permutation(P).astype(np.float32) / P
    return means, colors, opac, scales, quats


def jax_vjp(arrs, size, settings):
    """JAX image (H, W, 33) and the gradients of mean((color - 0.3)^2) with
    respect to (means, colors, opacities, scales, quats)."""
    jc, _ = make_cams(size)

    def image(m, c, o, s, q):
        color, _, invd = jgs.rasterize(m, c, o, s, q, jc, jnp.zeros(C), settings,
                                       channels_first=False)
        return color, invd

    @jax.jit
    def run(*args):
        (color, invd), vjp = jax.vjp(image, *args)
        return (color, invd), vjp((2.0 * (color - 0.3) / color.size, jnp.zeros_like(invd)))

    (color, invd), grads = run(*_j(arrs))
    return (np.asarray(color), np.asarray(invd)), [np.asarray(g) for g in grads]


def torch_vjp(arrs, size, settings):
    _, tc = make_cams(size)
    args = [torch.tensor(a, requires_grad=True) for a in arrs]
    color, _, invd = tgs.rasterize(*args, tc, torch.zeros(C), settings, channels_first=False)
    ((color - 0.3) ** 2).mean().backward()
    return (color.detach().numpy(), invd.detach().numpy()), [a.grad.numpy() for a in args]


def _bits(x):
    """A bf16 array or tensor as its 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_pack_unpack_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    P = 97
    rows = np.zeros((P, tk.ROW), np.float32)
    rows[:, 0:2] = rng.uniform(-10, 600, (P, 2))         # pixel coordinates
    rows[:, 2:5] = rng.lognormal(-2, 2, (P, 3)) * rng.choice([-1, 1], (P, 3))
    rows[:, 5] = rng.uniform(0, 1, P)
    rows[:, 8:40] = rng.uniform(0, 1, (P, 32))
    rows[:, 40] = rng.uniform(0.02, 5, P)                 # inverse depth
    table = np.zeros((P, 128), np.float32)
    table[:, :41] = rows[:, :41]

    want = jgs._pack_rows_bf16(jnp.asarray(table))
    got = tk.pack_rows_bf16(torch.tensor(rows))
    assert got.shape == (P, tk.ROW_BF16) and got.dtype == torch.bfloat16
    n = 2 * tk.GEOM + tk.CHANNELS + 1
    np.testing.assert_array_equal(_bits(got)[:, :n], _bits(want)[:, :n])
    assert not _bits(got)[:, n:].any() and not _bits(want)[:, n:].any()

    want_rows = np.asarray(jgs._unpack_rows_bf16(want))
    got_rows = tk.unpack_rows_bf16(got).numpy()
    np.testing.assert_array_equal(got_rows[:, :41].view(np.uint32), want_rows[:, :41].view(np.uint32))
    assert not got_rows[:, 41:].any()
    # the packing is finer than bf16: hi + lo is within ~2^-16 of the value
    np.testing.assert_allclose(got_rows[:, :6], rows[:, :6], rtol=2.0 ** -15, atol=0)


@pytest.fixture(scope="module")
def case():
    arrs = spaced_scene(5)
    size, tile = 32, 16
    st = jax_settings(size, tile)._replace(chunk=8, bf16_rows=True)
    want, jgrads = jax_vjp(arrs, size, st)
    got, grads = torch_vjp(arrs, size, tgs.RasterizeSettings(tile=tile, bf16_rows=True))
    base, _ = torch_vjp(arrs, size, tgs.RasterizeSettings(tile=tile))
    return dict(want=want, got=got, base=base, jgrads=jgrads, grads=grads)


def test_rasterize_bf16_vs_jax(case):
    for g, w in zip(case["got"], case["want"]):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    # and it is not the f32 image: the colors went through bf16
    assert np.abs(case["got"][0] - case["base"][0]).max() > 1e-5


@pytest.mark.parametrize("i", range(5), ids=NAMES)
def test_gradient_bf16_vs_jax(case, i):
    got, want = case["grads"][i], case["jgrads"][i]
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 1e-7, "the reference gradient is zero: the case tests nothing"
    np.testing.assert_allclose(got / scale, want / scale, atol=GRAD_ATOL)


def test_blend_bf16_is_k1_on_unpacked_rows():
    """The CPU path of K6 and of its autograd wrapper is K1's plain version
    on the unpacked rows, forward and backward."""
    arrs = make_scene(7, P=24)
    _, tc = make_cams(32)
    prep = tgs.rasterize_prep(*_t(arrs), tc, tgs.RasterizeSettings(tile=16))
    rows = prep.rows.detach().requires_grad_(True)
    bg = torch.linspace(0, 1, C)
    color, invd, final_t = tk.blend_bf16(rows, prep.order, prep.ranges, bg, 32, 32, 16)
    (color.square().sum() + invd.sum()).backward()
    unpacked = tk.unpack_rows_bf16(tk.pack_rows_bf16(rows.detach())).requires_grad_(True)
    color2, invd2, final_t2 = tk.blend(unpacked, prep.order, prep.ranges, bg, 32, 32, 16)
    (color2.square().sum() + invd2.sum()).backward()
    for a, b in ((color, color2), (invd, invd2), (final_t, final_t2), (rows.grad, unpacked.grad)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module", params=sorted(FRAMES))
def frame(request):
    return FRAMES[request.param]()


@pytest.mark.parametrize("tile", [8, 16, 32])
def test_culled_walk_on_unpacked_rows_equals_blend_bf16_plain(frame, tile):
    """K6's image: K1's culled walk on the rows K6 widens its packed rows to."""
    proj, rows, size = frame
    if size % tile:
        pytest.skip("image smaller than the tile")
    ranges, order = bin_gaussians(proj, size, size, tile)
    bg = torch.linspace(0.0, 0.5, 32)
    packed = tk.pack_rows_bf16(rows)
    got = tk.blend_culled_plain(tk.unpack_rows_bf16(packed), order, ranges, bg, size, size, tile)
    want = tk.blend_bf16_plain(packed, order, ranges, bg, size, size, tile)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (tk.unpack_rows_bf16(packed)[:, :2] != packed[:, :2].float()).any()   # lo halves in use


@settings(max_examples=400, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_rows())
def test_cull_is_conservative_on_packed_rows(case):
    """The cull tests's rows (opacities at the 1/255 edge, means where rounding
    decides) after the packing: geometry hi + lo, whose lo half is non-zero
    wherever a value is not a bf16."""
    geom, x0, y0, w, h = case
    row = torch.zeros((1, tk.ROW))
    row[0, :6] = geom
    wide = tk.unpack_rows_bf16(tk.pack_rows_bf16(row))[0, :6]
    keep = bool(tk.row_may_reach_plain(wide, torch.tensor(float(x0)), torch.tensor(float(y0)),
                                       float(w - 1), float(h - 1)))
    if not keep:
        assert not _contributing(wide, x0, y0, w, h), (wide.tolist(), x0, y0, w, h)


WIDEN_MAIN = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#define __device__
#define __forceinline__ inline
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float __uint_as_float(uint32_t v) { float f; std::memcpy(&f, &v, 4); return f; }
inline float __fadd_rn(float a, float b) { return a + b; }
#include "blend_bf16_rows.cuh"
// argv: n, packed words in (n * 28 u32), rows out (n * 44 f32)
int main(int argc, char** argv) {
  const long n = std::atol(argv[1]);
  uint32_t* in = new uint32_t[n * guava_blend::kPackedWords];
  float4* out = new float4[n * 11];
  FILE* f = std::fopen(argv[2], "rb");
  if (std::fread(in, 4, n * guava_blend::kPackedWords, f) != size_t(n * guava_blend::kPackedWords)) return 1;
  std::fclose(f);
  for (long r = 0; r < n; ++r)
    for (int k = 0; k < 11; ++k) out[r * 11 + k] = guava_blend::widen_packed4(in + r * guava_blend::kPackedWords, k);
  f = std::fopen(argv[3], "wb");
  std::fwrite(out, sizeof(float4), n * 11, f);
  std::fclose(f);
  return 0;
}
"""


def test_widening_is_unpack_rows_bf16(tmp_path):
    """csrc/blend_bf16_rows.cuh:widen_packed4, built by g++ without
    contraction, against unpack_rows_bf16: seeded rows through
    pack_rows_bf16, and raw 16-bit patterns (every class of bf16, a
    non-zero pad) as packed rows."""
    gpp = shutil.which("g++")
    if gpp is None:
        pytest.skip("no g++ on this machine")
    rng = np.random.default_rng(11)
    rows = (rng.standard_normal((300, tk.ROW)) * 10.0 ** rng.integers(-40, 39, (300, tk.ROW)))
    rows = rows.astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -3e-39, 1.5e-45],
                       np.float32)
    rows.flat[rng.integers(0, rows.size, 400)] = rng.choice(special, 400)
    packed = [tk.pack_rows_bf16(torch.tensor(rows))]
    bits = rng.integers(0, 1 << 16, (300, tk.ROW_BF16), dtype=np.uint16)
    bits[:, :16].flat[rng.integers(0, 300 * 16, 300)] = rng.choice(
        np.array([0x0000, 0x8000, 0x7f80, 0xff80, 0x7fc0, 0x0001, 0x807f, 0x0080], np.uint16),
        300)
    packed.append(torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16))
    packed = torch.cat(packed)
    classes = packed.view(torch.int16).numpy().view(np.uint16)
    exp = classes & 0x7f80
    assert ((exp == 0) & (classes & 0x7f != 0)).any() and (exp == 0x7f80).any()   # subnormals, inf/NaN

    src = Path(tk.__file__).resolve().parents[1] / "csrc"
    (tmp_path / "widen.cpp").write_text(WIDEN_MAIN)
    exe = tmp_path / "widen"
    subprocess.run([gpp, "-std=c++17", "-O2", "-ffp-contract=off", "-I", str(src), "-o",
                    str(exe), str(tmp_path / "widen.cpp")], check=True, capture_output=True)
    n = packed.shape[0]
    packed.view(torch.int16).numpy().tofile(tmp_path / "packed.bin")
    subprocess.run([str(exe), str(n), str(tmp_path / "packed.bin"), str(tmp_path / "rows.bin")],
                   check=True)
    got = np.fromfile(tmp_path / "rows.bin", np.float32).reshape(n, tk.ROW)
    want = tk.unpack_rows_bf16(packed).numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.uint32)[~nan], want.view(np.uint32)[~nan])
