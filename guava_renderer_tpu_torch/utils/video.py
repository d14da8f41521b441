"""MP4 files of JPEG frames, written and read without OpenCV or FFmpeg
(counterpart of `_write_video` in `guava_renderer_tpu/cli/inference.py`).

The JAX package writes its videos with `cv2.VideoWriter` as MPEG-4 Part 2
(`mp4v`). The card's machine has neither OpenCV nor FFmpeg, so the port
writes the container itself: each frame is one JPEG sample
(`data/codec.py:encode_jpeg`, quality 95) in an ISO-BMFF file
(`ftyp`, `mdat`, then `moov` with one video track whose `stsd` entry is
`mp4v` with an `esds` of objectTypeIndication 0x6C, ISO/IEC 10918-1).
FFmpeg's mov demuxer maps that to MJPEG, so `cv2.VideoCapture` and
`ffprobe` read it. Neither this file nor the JAX package's plays in a
browser's `<video>`, which wants H.264.

Frames in [0, 1] are quantized as the JAX package quantizes them,
`np.clip(x * 255, 0, 255).astype(np.uint8)`, which truncates. The file is
written under a temporary name in its directory and renamed when complete,
so a reader of the final path sees the whole video or nothing. No frames
means no file.
"""

from __future__ import annotations

import os
import struct
import tempfile
from typing import NamedTuple

import numpy as np

from ..data.codec import decode_jpeg, encode_jpeg

JPEG_QUALITY = 95
_OTI_JPEG = 0x6C                      # ISO/IEC 10918-1 in MPEG-4 systems' objectTypeIndication
_UNITY = (0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)   # the identity display matrix


class Video(NamedTuple):
    frames: np.ndarray        # (T, H, W, 3) uint8 RGB
    fps: float


def to_uint8(img) -> np.ndarray:
    """[0, 1] floats -> uint8 by truncation, as the JAX package's `_save_png`
    and `_write_video` quantize; uint8 passes through."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def _descriptor(tag: int, body: bytes) -> bytes:
    n = len(body)      # the size in four 7-bit groups, as FFmpeg writes it
    size = bytes([0x80 | ((n >> 21) & 0x7F), 0x80 | ((n >> 14) & 0x7F),
                  0x80 | ((n >> 7) & 0x7F), n & 0x7F])
    return bytes([tag]) + size + body


def _esds(max_bytes: int, avg_bitrate: int) -> bytes:
    dec = struct.pack(">BB", _OTI_JPEG, (0x04 << 2) | 1)       # visual stream
    dec += max_bytes.to_bytes(3, "big") + struct.pack(">II", avg_bitrate, avg_bitrate)
    es = struct.pack(">HB", 1, 0) + _descriptor(0x04, dec) + _descriptor(0x06, b"\x02")
    return _full(b"esds", 0, 0, _descriptor(0x03, es))


def _moov(sizes: list[int], offset: int, width: int, height: int, fps: int) -> bytes:
    n = len(sizes)
    matrix = struct.pack(">9I", *_UNITY)
    mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, fps, n),
                 struct.pack(">IH10x", 0x10000, 0x100), matrix, bytes(24),
                 struct.pack(">I", 2))
    tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, n), bytes(8),
                 struct.pack(">hhhH", 0, 0, 0, 0), matrix,
                 struct.pack(">II", width << 16, height << 16))
    mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, fps, n, 0x55C4, 0))  # "und"
    hdlr = _full(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"), b"VideoHandler\x00")
    vmhd = _full(b"vmhd", 0, 1, bytes(8))
    dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1), _full(b"url ", 0, 1)))
    seconds = n / fps
    entry = _box(b"mp4v", bytes(6), struct.pack(">HHH12xHHIIIH", 1, 0, 0, width, height,
                                                0x480000, 0x480000, 0, 1),
                 bytes(32), struct.pack(">Hh", 0x18, -1),
                 _esds(max(sizes), int(sum(sizes) * 8 / seconds)))
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), entry)
    stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, 1))
    stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))   # one chunk of n samples
    stsz = _full(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *sizes))
    stco = _full(b"stco", 0, 0, struct.pack(">II", 1, offset))   # mdat comes first: small
    stbl = _box(b"stbl", stsd, stts, stsc, stsz, stco)
    mdia = _box(b"mdia", mdhd, hdlr, _box(b"minf", vmhd, dinf, stbl))
    return _box(b"moov", mvhd, _box(b"trak", tkhd, mdia))


def write_video(path: str, frames, fps: int = 30) -> None:
    """Frames ((H, W, 3) RGB in [0, 1], or uint8) -> an MP4 of JPEG samples at
    `fps` (an integer: the media timescale, one tick a frame). No frames, no
    file."""
    if not frames:
        return
    fps = int(fps)
    if fps <= 0:
        raise ValueError(f"fps must be a positive integer, got {fps}")
    samples = [encode_jpeg(to_uint8(f), JPEG_QUALITY) for f in frames]
    h, w = np.asarray(frames[0]).shape[:2]
    if any(np.asarray(f).shape[:2] != (h, w) for f in frames):
        raise ValueError("every frame of a video must have the same size")
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2mp41")
    data = sum(len(s) for s in samples)
    if data + 8 < 2 ** 32:
        mdat_head = struct.pack(">I4s", 8 + data, b"mdat")
    else:
        mdat_head = struct.pack(">I4sQ", 1, b"mdat", 16 + data)
    offset = len(ftyp) + len(mdat_head)
    moov = _moov([len(s) for s in samples], offset, w, h, fps)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix="." + os.path.basename(path), suffix=".part")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(ftyp)
            f.write(mdat_head)
            for s in samples:
                f.write(s)
            f.write(moov)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


# -- reading ----------------------------------------------------------------

def _children(buf: bytes, start: int, end: int):
    """(kind, body start, body end) of each box in buf[start:end]."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        head = 8
        if size == 1:
            size = struct.unpack(">Q", buf[pos + 8:pos + 16])[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise ValueError(f"corrupt MP4: box {kind!r} of {size} bytes at {pos}")
        yield kind, pos + head, pos + size
        pos += size


def _find(buf: bytes, start: int, end: int, path: list[bytes]) -> tuple[int, int]:
    for kind, s, e in _children(buf, start, end):
        if kind == path[0]:
            return (s, e) if len(path) == 1 else _find(buf, s, e, path[1:])
    raise ValueError(f"MP4 without a {path[0].decode()} box")


def read_video(path: str) -> Video:
    """An MP4 that `write_video` wrote (one track of JPEG samples) -> its
    frames, each decoded by `data/codec.py:decode_jpeg`, and its fps."""
    with open(path, "rb") as f:
        buf = f.read()
    mdia = _find(buf, 0, len(buf), [b"moov", b"trak", b"mdia"])
    s, _ = _find(buf, *mdia, [b"mdhd"])
    version = buf[s]
    timescale = struct.unpack(">I", buf[s + (20 if version else 12):][:4])[0]
    stbl = _find(buf, *mdia, [b"minf", b"stbl"])
    tables = {kind: (s, e) for kind, s, e in _children(buf, *stbl)}
    s, _ = tables[b"stsd"]
    sample_kind = buf[s + 12:s + 16]
    if sample_kind != b"mp4v":
        raise ValueError(f"read_video reads JPEG samples in mp4v, not {sample_kind!r}")
    s, _ = tables[b"stts"]
    n_stts = struct.unpack(">I", buf[s + 4:s + 8])[0]
    deltas = struct.unpack(f">{2 * n_stts}I", buf[s + 8:s + 8 + 8 * n_stts])
    s, _ = tables[b"stsz"]
    fixed, n = struct.unpack(">II", buf[s + 4:s + 12])
    sizes = [fixed] * n if fixed else list(struct.unpack(f">{n}I", buf[s + 12:s + 12 + 4 * n]))
    s, _ = tables[b"stco"]
    k = struct.unpack(">I", buf[s + 4:s + 8])[0]
    chunks = struct.unpack(f">{k}I", buf[s + 8:s + 8 + 4 * k])
    s, _ = tables[b"stsc"]
    m = struct.unpack(">I", buf[s + 4:s + 8])[0]
    runs = [struct.unpack(">III", buf[s + 8 + 12 * i:s + 20 + 12 * i]) for i in range(m)]
    offsets = []
    for i, (first, per_chunk, _) in enumerate(runs):
        last = runs[i + 1][0] - 1 if i + 1 < m else len(chunks)
        for c in range(first - 1, last):
            pos = chunks[c]
            for _ in range(per_chunk):
                if len(offsets) == n:
                    break
                offsets.append(pos)
                pos += sizes[len(offsets) - 1]
    if len(offsets) != n:
        raise ValueError(f"corrupt MP4: {len(offsets)} sample offsets for {n} samples")
    frames = np.stack([decode_jpeg(buf[o:o + z]) for o, z in zip(offsets, sizes)]) \
        if n else np.zeros((0, 0, 0, 3), np.uint8)
    ticks = sum(c * d for c, d in zip(deltas[::2], deltas[1::2]))
    return Video(frames, timescale * n / ticks if ticks else 0.0)
