"""T1: the copy probes (`tools/mosaic_probe.py`). Each copies a slice of an
index array or rows of a table, at an offset given at run time, into shared
memory and writes what landed back out:

  idx32      order (65536,) i32, start s   -> (1, 1) i32 order[s]        (32 ids copied)
  idx1024    order (65536,) i32, start s   -> (1, 1) i32 order[s]        (1024 ids copied)
  idx2d      order (4096, 128) i32, flat p -> (1, 1) i32 order.flat[p + 31]
                                              (rows p // 128 and p // 128 + 1 copied)
  row1       table (300000, 128) f32, i    -> (1, 128) table[i]
  row1_loop  table (300000, 128) f32, ids (32,) i32 -> (32, 128) table[ids]
  row8       table (300000, 128) f32, i    -> (1, 128) table[i // 8 * 8] (8 rows copied)
  row64      table (300000, 64) f32, i     -> (1, 64) table[i]

For CUDA tensors `copy_probe` launches `csrc/copy_probe.cu`, through the bulk
copy engine where every source offset and size is a multiple of 16 bytes
(`route` says which) and by 4-byte cp.async otherwise, with the CTAs and
shared memory of `launch_shape`; for CPU tensors it runs `copy_probe_plain`;
nothing else.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build

PROBES = ("idx32", "idx1024", "idx2d", "row1", "row1_loop", "row8", "row64")
# name -> (source shape, dtype) as the JAX probes declare them
SOURCES = {
    "idx32": ((65536,), torch.int32),
    "idx1024": ((65536,), torch.int32),
    "idx2d": ((4096, 128), torch.int32),
    "row1": ((300_000, 128), torch.float32),
    "row1_loop": ((300_000, 128), torch.float32),
    "row8": ((300_000, 128), torch.float32),
    "row64": ((300_000, 64), torch.float32),
}
LOOP_ROWS = 32     # row1_loop's indices
MAX_SMEM = 16384   # shared bytes a CTA may take (csrc/copy_probe.cu:kMaxBytes)
launches = 0       # T1 kernel launches so far in this process


class Copy(NamedTuple):
    """What a probe copies: n_seg segments of seg_bytes, segment i at element
    (ids[i] if ids is not None else 0) + base of elem_bytes each; then
    out_bytes from byte out_off of what landed."""
    ids: torch.Tensor | None
    n_seg: int
    base: int
    elem_bytes: int
    seg_bytes: int
    out_off: int
    out_shape: tuple


def plan(name: str, at) -> Copy:
    """The copy of probe `name` at `at` (an int; the (32,) i32 ids for row1_loop)."""
    if name == "row1_loop":
        return Copy(at, LOOP_ROWS, 0, 512, 512, 0, (LOOP_ROWS, 128))
    at = int(at)
    return {
        "idx32": Copy(None, 1, at, 4, 32 * 4, 0, (1, 1)),
        "idx1024": Copy(None, 1, at, 4, 1024 * 4, 0, (1, 1)),
        "idx2d": Copy(None, 1, at // 128, 512, 2 * 512, (at % 128 + 31) * 4, (1, 1)),
        "row1": Copy(None, 1, at, 512, 512, 0, (1, 128)),
        "row8": Copy(None, 1, at // 8 * 8, 512, 8 * 512, 0, (1, 128)),
        "row64": Copy(None, 1, at, 256, 256, 0, (1, 64)),
    }[name]


class Shape(NamedTuple):
    """How csrc/copy_probe.cu launches a probe's copy: CTA c lands segment c
    into smem_bytes of dynamic shared memory and writes the part of the
    output window that lies in it."""
    ctas: int
    smem_bytes: int


def launch_shape(name: str, at) -> Shape:
    """The launch of probe `name` at `at`, as `guava_copy_probe` works it
    out: a CTA a segment, its shared memory the segment rounded up to 128
    bytes."""
    c = plan(name, at)
    return Shape(c.n_seg, -(-c.seg_bytes // 128) * 128)


def route(name: str, at) -> str:
    """"bulk" where every source offset, the destination and the size are
    multiples of 16 bytes, else "async4"."""
    c = plan(name, at)
    aligned = c.seg_bytes % 16 == 0 and c.base * c.elem_bytes % 16 == 0 \
        and (c.ids is None or c.elem_bytes % 16 == 0)
    return "bulk" if aligned else "async4"


def copy_probe_plain(name: str, src: torch.Tensor, at) -> torch.Tensor:
    """What the probe writes, in PyTorch indexing."""
    if name == "row1_loop":
        return src[at.long()]
    at = int(at)
    if name == "idx32":
        return src[at:at + 32][:1].reshape(1, 1)
    if name == "idx1024":
        return src[at:at + 1024][:1].reshape(1, 1)
    if name == "idx2d":
        return src[at // 128:at // 128 + 2].reshape(-1)[at % 128 + 31].reshape(1, 1)
    if name == "row8":
        return src[at // 8 * 8:at // 8 * 8 + 8][:1]
    return src[at:at + 1]      # row1, row64


def _check(name, src, at):
    if name not in SOURCES:
        raise ValueError(f"unknown probe {name!r}; one of {PROBES}")
    shape, dtype = SOURCES[name]
    if tuple(src.shape) != shape or src.dtype != dtype:
        raise ValueError(f"{name} reads a {shape} {dtype} array, got {tuple(src.shape)} "
                         f"{src.dtype}")
    c = plan(name, at)
    if c.ids is not None:
        if c.ids.shape != (LOOP_ROWS,) or c.ids.dtype != torch.int32 or c.ids.device != src.device:
            raise ValueError(f"{name} takes ({LOOP_ROWS},) int32 ids beside the table")
    elif c.base < 0 or c.base * c.elem_bytes + c.seg_bytes > src.numel() * src.element_size():
        raise ValueError(f"{name} at {at} copies outside its {shape} source")


def copy_probe(name: str, src: torch.Tensor, at) -> torch.Tensor:
    """The probe's copy on a CUDA tensor (`copy_probe_plain` on a CPU one):
    src of the probe's shape and dtype, `at` its start or index (row1_loop:
    (32,) i32 ids in range) -> what the probe writes."""
    global launches
    _check(name, src, at)
    if src.device.type == "cpu":
        return copy_probe_plain(name, src, at)
    if src.device.type != "cuda" or not src.is_contiguous():
        raise ValueError(f"src must be a contiguous CPU or CUDA tensor, got {src.device}")
    c = plan(name, at)
    out = torch.empty(c.out_shape, dtype=src.dtype, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().guava_copy_probe(
            src.data_ptr(), None if c.ids is None else c.ids.data_ptr(), c.n_seg, c.base,
            c.elem_bytes, c.seg_bytes, c.out_off, out.numel() * out.element_size(),
            out.data_ptr(), 0 if route(name, at) == "bulk" else 1, stream)
    build.check(err, "guava_copy_probe")
    launches += 1
    return out
