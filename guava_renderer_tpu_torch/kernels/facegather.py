"""K2: the planned deformer's face-table gather, rows[c, t] = table[ids[t], c].

`face_gather` launches `csrc/facegather.cu` for CUDA tensors and runs
`face_gather_plain` for CPU tensors; nothing else.
"""

from __future__ import annotations

import torch

from . import build

CHANNELS = 16
launches = 0   # kernel launches so far in this process


def face_gather_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (Fc, 16) f32, ids (N,) int -> rows (16, N) f32, channel-major."""
    return table[ids.long()].T.contiguous()


def face_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (Fc, 16) f32 face table, ids (N,) i32 compact face ids (sorted
    by the plan, each in [0, Fc)) -> rows (16, N) f32."""
    global launches
    if table.dim() != 2 or table.shape[1] != CHANNELS or table.dtype != torch.float32:
        raise ValueError(f"table must be (Fc, {CHANNELS}) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be (N,) int32, got {tuple(ids.shape)} {ids.dtype}")
    if table.device != ids.device:
        raise ValueError(f"table on {table.device}, ids on {ids.device}")
    if table.device.type == "cpu":
        return face_gather_plain(table, ids)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("table and ids must be contiguous")
    n = ids.shape[0]
    out = torch.empty((CHANNELS, n), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().guava_face_gather(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, stream)
    build.check(err, "guava_face_gather")
    launches += 1
    return out
