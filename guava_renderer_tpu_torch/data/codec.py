"""Image codec of the data layer: JPEG and PNG without an image library,
and OpenCV's `INTER_AREA` resize.

The JAX package reads and writes images with OpenCV. The port's machines
need not have it, so the port carries this codec: `native/imagecodec.cpp`
(built with g++ on first use) decodes baseline JPEG as libjpeg-turbo's
default path does, so the pixels equal `cv2.imdecode`'s; encodes baseline
JPEG as libjpeg-turbo does at OpenCV's defaults (4:2:0, standard tables);
and undoes PNG's scanline filters, with zlib inflating and deflating.
`resize_area` is `cv2.resize(img, (size, size), interpolation=INTER_AREA)`
on float32 in numpy, in all four of its regimes (identity, integer box
mean, fractional area weights, and the bilinear emulation of an upscale).

Every call into the C++ goes through a ctypes `CDLL`, which releases the
GIL, so a loader thread decodes while the main thread drives the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
import zlib

import numpy as np

from ..native import lib_path

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_ERRLEN = 256


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(lib_path("imagecodec"))
    P, U64, I = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
    lib.ic_jpeg_info.argtypes = [P, U64, P, P, P, ctypes.c_char_p, I]
    lib.ic_jpeg_info.restype = I
    lib.ic_jpeg_decode.argtypes = [P, U64, P, U64, ctypes.c_char_p, I]
    lib.ic_jpeg_decode.restype = I
    lib.ic_jpeg_encode.argtypes = [P, I, I, I, I, P, U64, ctypes.c_char_p, I]
    lib.ic_jpeg_encode.restype = ctypes.c_int64
    lib.ic_png_unfilter.argtypes = [P, U64, I, I, I, P, ctypes.c_char_p, I]
    lib.ic_png_unfilter.restype = I
    return lib


def _ptr(a) -> int:
    return a.ctypes.data


def _as_u8(buf) -> np.ndarray:
    return np.ascontiguousarray(np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray)
                                else buf.reshape(-1).view(np.uint8))


# -- JPEG ------------------------------------------------------------------

def decode_jpeg(buf) -> np.ndarray:
    """Baseline JPEG bytes -> uint8 (H, W, 3) RGB, or (H, W) for one
    component. Raises ValueError on what it cannot read, naming the marker."""
    data = _as_u8(buf)
    lib, err = _lib(), ctypes.create_string_buffer(_ERRLEN)
    w, h, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.ic_jpeg_info(_ptr(data), data.size, ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(nc), err, _ERRLEN):
        raise ValueError(err.value.decode())
    shape = (h.value, w.value) if nc.value == 1 else (h.value, w.value, nc.value)
    out = np.empty(shape, np.uint8)
    if lib.ic_jpeg_decode(_ptr(data), data.size, _ptr(out), out.size, err, _ERRLEN):
        raise ValueError(err.value.decode())
    return out


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """uint8 (H, W, 3) RGB or (H, W) gray -> baseline JPEG bytes (4:2:0 for
    color; quality 95 is OpenCV's default)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = np.ascontiguousarray(img[..., 0])
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3), got {img.shape}")
    nc = 1 if img.ndim == 2 else 3
    lib, err = _lib(), ctypes.create_string_buffer(_ERRLEN)
    cap = img.size * 4 + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.ic_jpeg_encode(_ptr(img), img.shape[1], img.shape[0], nc, int(quality),
                               _ptr(out), cap, err, _ERRLEN)
        if n < 0:
            raise ValueError(err.value.decode())
        if n <= cap:
            return out[:n].tobytes()
        cap = n


# -- PNG -------------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}   # gray, RGB, RGBA


def decode_png(buf) -> np.ndarray:
    """8-bit gray / RGB / RGBA PNG bytes -> uint8 (H, W), (H, W, 3) RGB or
    (H, W, 4) RGBA. Raises ValueError on other PNGs."""
    buf = bytes(buf)
    if buf[:8] != _PNG_SIG:
        raise ValueError("not a PNG file (bad signature)")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + n]
        crc = buf[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"corrupt PNG: CRC mismatch in chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind in (b"tRNS", b"PLTE"):
            raise ValueError(f"unsupported PNG: chunk {kind.decode()} (palette or transparency)")
    if header is None:
        raise ValueError("corrupt PNG: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type {ctype}, "
                         f"interlace {interlace} (only 8-bit gray, RGB, RGBA, not interlaced)")
    c = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    out = np.empty((h, w, c), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if _lib().ic_png_unfilter(_ptr(raw), raw.size, w, h, c, _ptr(out), err, _ERRLEN):
        raise ValueError(err.value.decode())
    return out[..., 0] if c == 1 else out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 (H, W), (H, W, 1), (H, W, 3) RGB or (H, W, 4) RGBA -> PNG bytes
    (filter 0 on every row, zlib at `level`)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    c = img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(c)
    if img.ndim != 3 or ctype is None:
        raise ValueError(f"encode_png takes (H, W[, 1|3|4]), got {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    return (_PNG_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


# -- what the data layer calls ----------------------------------------------

def decode_image(buf) -> np.ndarray:
    """What `cv2.imdecode(buf, IMREAD_UNCHANGED)` followed by BGR -> RGB for
    three channels returns (the JAX `data/tracked.py:_decode_image`): RGB
    (H, W, 3), gray (H, W), and for a four-channel PNG, BGRA as OpenCV
    leaves it."""
    head = bytes(buf[:8])
    if head[:2] == b"\xff\xd8":
        return decode_jpeg(buf)
    if head == _PNG_SIG:
        img = decode_png(buf)
        return img[..., [2, 1, 0, 3]] if img.ndim == 3 and img.shape[2] == 4 else img
    raise ValueError("unknown image format (neither JPEG nor PNG)")


def read_rgb(path: str) -> np.ndarray:
    """An image file as uint8 (H, W, 3) RGB, as `cv2.imread(IMREAD_COLOR)`
    then BGR -> RGB gives it: gray replicated, alpha dropped."""
    with open(path, "rb") as f:
        img = decode_image(f.read())
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    if img.shape[2] == 4:               # BGRA from decode_image
        return img[..., [2, 1, 0]]
    return img


def write_image(path: str, img: np.ndarray, quality: int = 95) -> None:
    """uint8 RGB or gray -> a .jpg/.jpeg or .png file by the extension."""
    ext = path.rsplit(".", 1)[-1].lower()
    if ext in ("jpg", "jpeg"):
        data = encode_jpeg(img, quality)
    elif ext == "png":
        data = encode_png(img)
    else:
        raise ValueError(f"write_image writes .jpg or .png, not {path!r}")
    with open(path, "wb") as f:
        f.write(data)


# -- INTER_AREA --------------------------------------------------------------

def _area_taps(ssize: int, dsize: int):
    """OpenCV's `computeResizeAreaTab` -> (dst index, src index, float32
    weight) lists in its order."""
    scale = 1.0 / (dsize / ssize)
    di, si, al = [], [], []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            di.append(dx), si.append(sx1 - 1), al.append((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            di.append(dx), si.append(sx), al.append(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            di.append(dx), si.append(sx2), al.append(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return np.asarray(di), np.asarray(si), np.asarray(al, np.float32)


def _padded_taps(ssize: int, dsize: int):
    """The area taps as (dsize, T) index and weight arrays in OpenCV's order;
    missing taps point at 0 with weight 0."""
    di, si, al = _area_taps(ssize, dsize)
    counts = np.bincount(di, minlength=dsize)
    T = int(counts.max())
    idx = np.zeros((dsize, T), np.int64)
    w = np.zeros((dsize, T), np.float32)
    slot = np.arange(len(di)) - np.repeat(np.cumsum(counts) - counts, counts)
    idx[di, slot] = si
    w[di, slot] = al
    return idx, w


def _linear_taps(ssize: int, dsize: int):
    """OpenCV's INTER_AREA upscale (its bilinear emulation, `area_mode`) ->
    (dsize, 2) indices and float32 weights."""
    inv = dsize / ssize
    scale = 1.0 / inv
    idx = np.zeros((dsize, 2), np.int64)
    w = np.zeros((dsize, 2), np.float32)
    for d in range(dsize):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else np.float32(f - math.floor(f))
        if s >= ssize - 1:
            s, f = ssize - 1, np.float32(0.0)
        idx[d] = (s, min(s + 1, ssize - 1))
        w[d] = (np.float32(1.0) - f, f)
    return idx, w


def _apply(img: np.ndarray, idx: np.ndarray, w: np.ndarray, axis: int) -> np.ndarray:
    """Sum of the taps along `axis`, accumulated in float32 in tap order."""
    out = None
    for t in range(idx.shape[1]):
        shape = [1] * img.ndim
        shape[axis] = -1
        term = np.take(img, idx[:, t], axis=axis) * w[:, t].reshape(shape)
        out = term if out is None else out + term
    return out


def resize_area(img: np.ndarray, size: int) -> np.ndarray:
    """`cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)` on
    float32 (H, W) or (H, W, C); like OpenCV, a single channel comes back
    as (size, size)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    H, W = img.shape[:2]
    if (H, W) == (size, size):
        return img.copy()
    sx, sy = W / size, H / size
    if sx >= 1 and sy >= 1:
        if sx == int(sx) and sy == int(sy):
            # resizeAreaFast: the mean of each integer box. A 2x2 box of one
            # or four channels takes the SIMD sum (row sums, then their
            # sum); any other, the scalar loop's four-term groups in
            # row-major order
            kx, ky = int(sx), int(sy)
            blocks = img[:size * ky, :size * kx].reshape(size, ky, size, kx, *img.shape[2:])
            cn = 1 if img.ndim == 2 else img.shape[2]
            terms = [blocks[:, i, :, j] for i in range(ky) for j in range(kx)]
            if kx == ky == 2 and cn in (1, 4):
                acc = (terms[0] + terms[1]) + (terms[2] + terms[3])
            else:
                acc = None
                for g in range(0, len(terms) - 3, 4):
                    group = ((terms[g] + terms[g + 1]) + terms[g + 2]) + terms[g + 3]
                    acc = group if acc is None else acc + group
                for t in terms[len(terms) // 4 * 4:]:
                    acc = t if acc is None else acc + t
            return acc * np.float32(1.0 / (kx * ky))
        xi, xw = _padded_taps(W, size)
        yi, yw = _padded_taps(H, size)
    else:
        xi, xw = _linear_taps(W, size)
        yi, yw = _linear_taps(H, size)
    return _apply(_apply(img, xi, xw, axis=1), yi, yw, axis=0).astype(np.float32)
