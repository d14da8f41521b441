"""The port's MP4 writer and reader (`guava_renderer_tpu_torch/utils/video.py`):
its boxes and timing, its frames through `read_video` (exactly the codec's
JPEG round trip of each truncated frame) and through OpenCV's FFmpeg
reader, odd sizes, no frames, and the atomic rename."""

import struct
import threading

import cv2
import numpy as np
import pytest

from guava_renderer_tpu_torch.data.codec import decode_jpeg, encode_jpeg
from guava_renderer_tpu_torch.utils import video

CV2_MEAN_LEVELS = 2.0     # OpenCV's (FFmpeg's) decode against the port's, mean abs a frame


def _frames(h, w, n, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([yy, xx, 0.5 * (yy + xx)], axis=-1)
    return [np.clip(base + 0.15 * np.sin(i + 3 * base) + 0.02 * rng.standard_normal(base.shape),
                    -0.1, 1.1).astype(np.float32) for i in range(n)]


def _boxes(buf, start, end, depth=0, out=None):
    out = [] if out is None else out
    containers = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"dinf"}
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        out.append((depth, kind, pos + 8, pos + size))
        if kind in containers:
            _boxes(buf, pos + 8, pos + size, depth + 1, out)
        pos += size
    assert pos == end
    return out


@pytest.mark.parametrize("fps,n", [(30, 8), (25, 3), (1, 1)])
def test_boxes_and_timing(tmp_path, fps, n):
    path = str(tmp_path / "v.mp4")
    video.write_video(path, _frames(48, 96, n), fps=fps)
    buf = open(path, "rb").read()
    boxes = _boxes(buf, 0, len(buf))
    kinds = [(d, k) for d, k, _, _ in boxes]
    assert [k for d, k in kinds if d == 0] == [b"ftyp", b"mdat", b"moov"]
    for want in (b"mvhd", b"trak", b"tkhd", b"mdia", b"mdhd", b"hdlr", b"minf", b"vmhd",
                 b"dinf", b"dref", b"stbl", b"stsd", b"stts", b"stsc", b"stsz", b"stco"):
        assert want in [k for _, k in kinds], want
    body = {k: (s, e) for _, k, s, e in boxes}
    s, _ = body[b"mvhd"]
    assert struct.unpack(">II", buf[s + 12:s + 20]) == (fps, n)       # timescale, duration
    s, _ = body[b"mdhd"]
    assert struct.unpack(">II", buf[s + 12:s + 20]) == (fps, n)
    s, _ = body[b"hdlr"]
    assert buf[s + 8:s + 12] == b"vide"
    s, e = body[b"stsd"]
    assert buf[s + 12:s + 16] == b"mp4v"
    esds = buf.index(b"esds", s, e)
    dec = buf.index(b"\x04", esds + 8)        # the DecoderConfigDescriptor's tag
    assert buf[dec + 5] == 0x6C               # objectTypeIndication: JPEG
    s, _ = body[b"stsz"]
    sizes = struct.unpack(f">{n}I", buf[s + 12:s + 12 + 4 * n])
    s, _ = body[b"stco"]
    offset = struct.unpack(">I", buf[s + 8:s + 12])[0]
    ms, me = body[b"mdat"]
    assert offset == ms and sum(sizes) == me - ms
    assert buf[offset:offset + 2] == b"\xff\xd8"
    assert video.read_video(path).fps == fps


@pytest.mark.parametrize("h,w", [(48, 96), (50, 74), (64, 64), (17, 9)])
def test_read_video_is_the_codecs_round_trip(tmp_path, h, w):
    frames = _frames(h, w, 5, seed=h)
    path = str(tmp_path / "v.mp4")
    video.write_video(path, frames, fps=30)
    got = video.read_video(path)
    assert got.frames.shape == (5, h, w, 3) and got.frames.dtype == np.uint8
    for f, g in zip(frames, got.frames):
        q = np.clip(f * 255, 0, 255).astype(np.uint8)        # JAX's truncation
        assert np.array_equal(g, decode_jpeg(encode_jpeg(q, video.JPEG_QUALITY)))


def test_uint8_frames_pass_through(tmp_path):
    q = [video.to_uint8(f) for f in _frames(32, 48, 3)]
    a, b = str(tmp_path / "a.mp4"), str(tmp_path / "b.mp4")
    video.write_video(a, q)
    video.write_video(b, _frames(32, 48, 3))
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("h,w,fps", [(48, 96, 30), (50, 74, 25), (512, 1024, 30)])
def test_opencv_reads_it(tmp_path, h, w, fps):
    n = 3 if h > 100 else 8
    frames = _frames(h, w, n)
    path = str(tmp_path / "v.mp4")
    video.write_video(path, frames, fps=fps)
    cap = cv2.VideoCapture(path)
    assert cap.isOpened()
    assert cap.get(cv2.CAP_PROP_FPS) == fps
    assert int(cap.get(cv2.CAP_PROP_FOURCC)).to_bytes(4, "little") == b"MJPG"
    got = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        got.append(f[..., ::-1])
    cap.release()
    assert len(got) == n
    ours = video.read_video(path).frames
    for g, o in zip(got, ours):
        assert g.shape == (h, w, 3)
        assert np.abs(g.astype(int) - o).mean() <= CV2_MEAN_LEVELS


def test_no_frames_no_file(tmp_path):
    path = tmp_path / "v.mp4"
    video.write_video(str(path), [], fps=30)
    assert not path.exists() and list(tmp_path.iterdir()) == []


def test_refuses_mixed_sizes_and_leaves_nothing(tmp_path):
    path = tmp_path / "v.mp4"
    with pytest.raises(ValueError, match="same size"):
        video.write_video(str(path), _frames(16, 16, 2) + _frames(16, 24, 1))
    assert list(tmp_path.iterdir()) == []


def test_a_reader_never_sees_a_partial_file(tmp_path, monkeypatch):
    """The video is written under another name and renamed when whole: a
    reader polling the final path sees nothing, then the whole file."""
    path = tmp_path / "v.mp4"
    frames = _frames(64, 96, 12)
    real = video.encode_jpeg
    seen, done = [], threading.Event()

    def slow_encode(img, quality):
        done.wait(0.01)
        return real(img, quality)

    monkeypatch.setattr(video, "encode_jpeg", slow_encode)

    def poll():
        while not done.is_set():
            if path.exists():
                seen.append(path.read_bytes())

    t = threading.Thread(target=poll)
    t.start()
    try:
        video.write_video(str(path), frames)
    finally:
        done.set()
        t.join(timeout=10)
    assert not t.is_alive()
    whole = path.read_bytes()
    assert all(s == whole for s in seen)
    assert len(video.read_video(str(path)).frames) == 12
    assert sorted(p.name for p in tmp_path.iterdir()) == ["v.mp4"]
