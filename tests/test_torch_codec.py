"""The port's image codec (`data/codec.py`, `native/imagecodec.cpp`)
against OpenCV, which the JAX package reads and writes images with.

JPEG decode is held equal to `cv2.imdecode` on every pixel, PNG decode
likewise, and `resize_area` to `cv2.resize(INTER_AREA)` at atol 1e-6 (it
comes out bit-equal on these cases). The port's encoder is held to files
that OpenCV reads back as the port does, and to OpenCV's own files of the
same pixels.
"""

import cv2
import numpy as np
import pytest

from guava_renderer_tpu.data.tracked import _decode_image as jax_decode_image
from guava_renderer_tpu_torch.data import codec

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
SIZES = (8, 17, 48, 97, 518)
RESIZE_ATOL = 1e-6


def _pixels(kind, h, w, c, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        a = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    else:    # gradients and waves with a little noise: smooth, so the codecs keep detail
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        a = np.stack([128 + 120 * np.sin(6 * xx + k) * np.cos(5 * yy - k) for k in range(c)], -1)
        a = np.clip(a + rng.normal(0, 6, a.shape), 0, 255).astype(np.uint8)
    return a[..., 0] if c == 1 else a


def _cv2_jpeg(img, quality, sampling=None, restart=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _cv2_read(buf):
    img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3 and img.shape[2] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    elif img.ndim == 3 and img.shape[2] == 4:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA)
    return img


# -- JPEG decode -------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sampling", ["420", "422", "444", "440", "gray"])
@pytest.mark.parametrize("quality", [95, 98])
def test_jpeg_decode_equals_cv2(size, sampling, quality):
    c = 1 if sampling == "gray" else 3
    kind = "noise" if size in (17, 97) else "smooth"
    img = _pixels(kind, size, size + size % 3, c, seed=size)
    buf = _cv2_jpeg(img, quality, None if sampling == "gray" else sampling)
    got = codec.decode_jpeg(buf)
    ref = _cv2_read(buf)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert np.array_equal(got, ref), int(np.abs(got.astype(int) - ref).max())


@pytest.mark.parametrize("sampling,restart", [("420", 1), ("444", 3), ("gray", 2), ("422", 5)])
def test_jpeg_decode_with_restart_markers_equals_cv2(sampling, restart):
    c = 1 if sampling == "gray" else 3
    img = _pixels("smooth", 97, 131, c, seed=restart)
    buf = _cv2_jpeg(img, 95, None if sampling == "gray" else sampling, restart)
    assert b"\xff\xdd" in buf and b"\xff\xd0" in buf        # DRI and RST0 present
    assert np.array_equal(codec.decode_jpeg(buf), _cv2_read(buf))


@pytest.mark.parametrize("marker,byte,name", [(0xC2, None, "SOF2"), (0xC9, None, "SOF9"),
                                              (0xC3, None, "SOF3"), (0xC0, 12, "12-bit")])
def test_jpeg_refuses_what_it_cannot_read(marker, byte, name):
    buf = bytearray(_cv2_jpeg(_pixels("smooth", 16, 16, 3, 0), 95))
    at = buf.index(b"\xff\xc0")
    buf[at + 1] = marker
    if byte is not None:
        buf[at + 4] = byte                               # the SOF's sample precision
    with pytest.raises(ValueError, match=name):
        codec.decode_jpeg(bytes(buf))


def test_jpeg_refuses_a_progressive_cv2_file():
    ok, buf = cv2.imencode(".jpg", _pixels("smooth", 32, 32, 3, 0),
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="SOF2"):
        codec.decode_jpeg(buf.tobytes())


# -- JPEG encode -------------------------------------------------------------

@pytest.mark.parametrize("size", [8, 17, 97, 518])
@pytest.mark.parametrize("c", [3, 1])
@pytest.mark.parametrize("quality", [95, 98])
def test_port_jpeg_reads_back_in_cv2_as_in_the_port(size, c, quality):
    kind = "smooth" if size % 2 == 0 else "noise"
    img = _pixels(kind, size, size + 5, c, seed=c)
    buf = codec.encode_jpeg(img, quality)
    got = codec.decode_jpeg(buf)
    assert np.array_equal(_cv2_read(buf), got)
    if kind == "smooth":        # a lossy copy (4:2:0 drops the chroma noise), near the pixels
        assert np.abs(got.astype(int) - img).mean() < 10


@pytest.mark.parametrize("size", [8, 17, 48, 97, 518])
@pytest.mark.parametrize("c", [3, 1])
def test_port_q95_against_cv2_q95(size, c):
    """The port's q95 file of the same pixels as OpenCV's default q95 file:
    decoded, within one level (the stated bound); the files themselves are
    byte-equal here (libjpeg-turbo's defaults: 4:2:0, standard tables)."""
    img = _pixels("noise" if size % 2 else "smooth", size, size, c, seed=size)
    mine = codec.encode_jpeg(img, 95)
    ref = _cv2_jpeg(cv2.cvtColor(img, cv2.COLOR_RGB2BGR) if c == 3 else img, 95)
    diff = np.abs(codec.decode_jpeg(mine).astype(int) - codec.decode_jpeg(ref)).max()
    assert diff <= 1
    assert mine == ref


# -- PNG ---------------------------------------------------------------------

@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("level", [1, 9])
def test_png_decode_equals_cv2(c, kind, level):
    img = _pixels(kind, 45, 67, c, seed=c)
    bgr = {1: img, 3: cv2.cvtColor(img, cv2.COLOR_RGB2BGR) if c == 3 else None,
           4: cv2.cvtColor(img, cv2.COLOR_RGBA2BGRA) if c == 4 else None}[c]
    ok, buf = cv2.imencode(".png", bgr, [cv2.IMWRITE_PNG_COMPRESSION, level])
    got = codec.decode_png(buf.tobytes())
    assert got.shape == img.shape and np.array_equal(got, img)
    assert np.array_equal(got, _cv2_read(buf.tobytes()))


@pytest.mark.parametrize("shape", [(1, 1), (45, 67), (45, 67, 1), (31, 17, 3), (20, 33, 4)])
def test_port_png_reads_back_in_cv2(shape):
    img = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    buf = codec.encode_png(img)
    got = codec.decode_png(buf)
    assert np.array_equal(got, img.reshape(got.shape))
    assert np.array_equal(_cv2_read(buf), got)


def test_png_refuses_palette_and_16_bit():
    img = np.random.default_rng(0).integers(0, 65535, (8, 8), dtype=np.uint16)
    ok, buf = cv2.imencode(".png", img)
    with pytest.raises(ValueError, match="bit depth 16"):
        codec.decode_png(buf.tobytes())
    bad = bytearray(codec.encode_png(np.zeros((4, 4), np.uint8)))
    bad[-20] ^= 0xFF                                     # inside IDAT: its CRC fails
    with pytest.raises(ValueError, match="CRC"):
        codec.decode_png(bytes(bad))


# -- what the data layer reads -----------------------------------------------

@pytest.mark.parametrize("fmt,c", [("jpg", 3), ("jpg", 1), ("png", 1), ("png", 3), ("png", 4)])
def test_decode_image_equals_the_jax_decode(fmt, c):
    img = _pixels("smooth", 33, 40, c, seed=7)
    ok, buf = cv2.imencode("." + fmt, img)
    got = codec.decode_image(buf.tobytes())
    ref = jax_decode_image(buf.tobytes())
    assert got.shape == ref.shape and np.array_equal(got, ref)


def test_write_image_and_read_rgb(tmp_path):
    img = _pixels("smooth", 20, 30, 3, seed=1)
    codec.write_image(str(tmp_path / "a.png"), img)
    codec.write_image(str(tmp_path / "a.jpg"), img)
    codec.write_image(str(tmp_path / "g.png"), img[..., 0])
    assert np.array_equal(codec.read_rgb(str(tmp_path / "a.png")), img)
    for name in ("a.jpg", "g.png"):
        ref = cv2.cvtColor(cv2.imread(str(tmp_path / name), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        assert np.array_equal(codec.read_rgb(str(tmp_path / name)), ref)


# -- INTER_AREA --------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [
    (512, 512),                                   # identity (teacher512)
    (1024, 512), (96, 48),                        # integer box mean (ubody_512)
    (48, 28), (48, 32), (96, 64), (96, 70), (1024, 518), (97, 31),   # fractional area
    (512, 518), (48, 64), (30, 97),               # upscale: OpenCV's bilinear emulation
])
@pytest.mark.parametrize("c", [3, 1])
def test_resize_area_equals_cv2(src, dst, c):
    img = np.random.default_rng(src + dst).uniform(0, 1, (src, src, c)).astype(np.float32)
    ref = cv2.resize(img, (dst, dst), interpolation=cv2.INTER_AREA)
    got = codec.resize_area(img, dst)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= RESIZE_ATOL


def test_resize_area_of_a_2d_image():
    img = np.random.default_rng(0).uniform(0, 1, (48, 48)).astype(np.float32)
    for dst in (48, 24, 28, 70):
        ref = cv2.resize(img, (dst, dst), interpolation=cv2.INTER_AREA)
        assert np.abs(codec.resize_area(img, dst) - ref).max() <= RESIZE_ATOL
