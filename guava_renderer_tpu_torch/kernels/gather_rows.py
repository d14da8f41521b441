"""K9: the row gather out[l] = rows[ids[l]] that builds the resident table
of the size-classed blend (K7).

Two entries launch `csrc/gather_rows.cu` for CUDA tensors:
`gather_resident`, which the frame calls, takes the ranking's int64 keys
(`ops/gsplat.py:resident_keys`) and returns the table with the decoded
ids; `gather_rows` takes int32 ids. For CPU tensors each runs its plain
version; nothing else. The result carries no gradient (the resident table
is not differentiated; see `kernels/blend.py:blend_resident`).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .blend import ROW

launches = 0       # K9 kernel launches so far in this process


def gather_rows_plain(rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """rows (P, 44) f32, ids (L,) int in [0, P) -> (L, 44) f32."""
    return rows.index_select(0, ids.long())


def decode_ids(keys: torch.Tensor, id_bits: int) -> torch.Tensor:
    """(L,) int64 keys score << id_bits | id -> (L,) i32 ids."""
    return (keys & ((1 << id_bits) - 1)).to(torch.int32)


def gather_resident_plain(rows: torch.Tensor, keys: torch.Tensor, id_bits: int):
    """-> (rows[ids] (L, 44) f32, ids (L,) i32) of the keys' ids."""
    lids = decode_ids(keys, id_bits)
    return gather_rows_plain(rows, lids), lids


def _check(rows, ids, dtype, what):
    if rows.dim() != 2 or rows.shape[1] != ROW or rows.dtype != torch.float32:
        raise ValueError(f"rows must be (P, {ROW}) float32, got {tuple(rows.shape)} {rows.dtype}")
    if ids.dim() != 1 or ids.dtype != dtype:
        raise ValueError(f"{what} must be (L,) {dtype}, got {tuple(ids.shape)} {ids.dtype}")
    if rows.device != ids.device or rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rows on {rows.device}, {what} on {ids.device}")
    if rows.device.type == "cuda" and not (rows.is_contiguous() and ids.is_contiguous()):
        raise ValueError(f"rows and {what} must be contiguous")
    if rows.device.type == "cuda" and rows.data_ptr() % 16:
        raise ValueError("the gather reads rows in 16-byte pieces: rows must start on a "
                         "16-byte boundary")


def _launch(entry, rows, ids, *args):
    """entry(rows, ids, *args, L, stream) on the current stream, for L =
    ids.shape[0] > 0; an empty table launches nothing."""
    global launches
    if ids.shape[0] == 0:
        return
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(build.library(), entry)(rows.data_ptr(), ids.data_ptr(), *args,
                                              ids.shape[0], stream)
    build.check(err, entry)
    launches += 1


def gather_rows(rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """rows (P, 44) f32, ids (L,) i32 in [0, P) -> rows[ids] (L, 44) f32."""
    _check(rows, ids, torch.int32, "ids")
    rows = rows.detach()
    if rows.device.type == "cpu":
        return gather_rows_plain(rows, ids)
    out = torch.empty((ids.shape[0], ROW), dtype=torch.float32, device=rows.device)
    _launch("guava_gather_rows", rows, ids, out.data_ptr())
    return out


def gather_resident(rows: torch.Tensor, keys: torch.Tensor, id_bits: int):
    """rows (P, 44) f32, keys (L,) int64 whose low id_bits bits are ids in
    [0, P) -> (rows[ids] (L, 44) f32, ids (L,) i32), in one launch."""
    _check(rows, keys, torch.int64, "keys")
    if not 1 <= id_bits <= 31:
        raise ValueError(f"id_bits must be in [1, 31], got {id_bits}")
    rows = rows.detach()
    if rows.device.type == "cpu":
        return gather_resident_plain(rows, keys, id_bits)
    out = torch.empty((keys.shape[0], ROW), dtype=torch.float32, device=rows.device)
    lids = torch.empty(keys.shape[0], dtype=torch.int32, device=rows.device)
    _launch("guava_gather_resident", rows, keys, id_bits, out.data_ptr(), lids.data_ptr())
    return out, lids


def occupancy() -> dict:
    """Resident CTAs an SM of the frame's entry and its shared memory a CTA
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    ctas, smem = ctypes.c_int(), ctypes.c_int()
    build.check(build.library().guava_gather_rows_occupancy(ctypes.addressof(ctas),
                                                            ctypes.addressof(smem)),
                "guava_gather_rows_occupancy")
    return {"ctas_per_sm": ctas.value, "smem_bytes": smem.value}
