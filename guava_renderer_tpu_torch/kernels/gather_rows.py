"""K9: the row gather out[l] = rows[ids[l]] that builds the resident table
of the size-classed blend (K7).

For CUDA tensors `gather_rows` launches `csrc/gather_rows.cu`; for CPU
tensors it runs `gather_rows_plain`; nothing else. The result carries no
gradient (the resident table is not differentiated; see
`kernels/blend.py:blend_resident`).
"""

from __future__ import annotations

import torch

from . import build
from .blend import ROW

launches = 0       # K9 kernel launches so far in this process


def gather_rows_plain(rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """rows (P, 44) f32, ids (L,) int in [0, P) -> (L, 44) f32."""
    return rows.index_select(0, ids.long())


def gather_rows(rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """rows (P, 44) f32, ids (L,) i32 in [0, P) -> rows[ids] (L, 44) f32."""
    global launches
    if rows.dim() != 2 or rows.shape[1] != ROW or rows.dtype != torch.float32:
        raise ValueError(f"rows must be (P, {ROW}) float32, got {tuple(rows.shape)} {rows.dtype}")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be (L,) int32, got {tuple(ids.shape)} {ids.dtype}")
    if rows.device != ids.device or rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rows on {rows.device}, ids on {ids.device}")
    rows = rows.detach()
    if rows.device.type == "cpu":
        return gather_rows_plain(rows, ids)
    if not (rows.is_contiguous() and ids.is_contiguous()):
        raise ValueError("rows and ids must be contiguous")
    out = torch.empty((ids.shape[0], ROW), dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().guava_gather_rows(rows.data_ptr(), ids.data_ptr(), out.data_ptr(),
                                                ids.shape[0], stream)
    build.check(err, "guava_gather_rows")
    launches += 1
    return out
