"""K2 and K4: the planned deformer's face-table gather,
rows[c, t] = table[ids[t], c], and its backward,
d_table[f, c] = sum over t with ids[t] == f of drows[c, t].

`face_gather` is differentiable in `table`. For CUDA tensors its forward
launches `csrc/facegather.cu` and its backward `csrc/facegather_bwd.cu`; for
CPU tensors they run `face_gather_plain` and `face_gather_bwd_plain`;
nothing else.
"""

from __future__ import annotations

import torch

from . import build

CHANNELS = 16
launches = 0       # K2 (forward) kernel launches so far in this process
bwd_launches = 0   # K4 (backward) kernel launches so far in this process


def face_gather_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (Fc, 16) f32, ids (N,) int -> rows (16, N) f32, channel-major."""
    return table[ids.long()].T.contiguous()


def face_gather_bwd_plain(drows: torch.Tensor, ids: torch.Tensor, n_faces: int) -> torch.Tensor:
    """drows (16, N) f32, ids (N,) int in [0, n_faces) -> d_table (n_faces, 16) f32."""
    d_table = torch.zeros((n_faces, CHANNELS), dtype=drows.dtype, device=drows.device)
    return d_table.index_add_(0, ids.long(), drows.T)


def _check(table, ids):
    if table.dim() != 2 or table.shape[1] != CHANNELS or table.dtype != torch.float32:
        raise ValueError(f"table must be (Fc, {CHANNELS}) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be (N,) int32, got {tuple(ids.shape)} {ids.dtype}")
    if table.device != ids.device:
        raise ValueError(f"table on {table.device}, ids on {ids.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    if table.is_cuda and not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("table and ids must be contiguous")


def _forward(table, ids):
    """K2 on CUDA tensors, `face_gather_plain` on CPU tensors."""
    global launches
    if table.device.type == "cpu":
        return face_gather_plain(table, ids)
    n = ids.shape[0]
    out = torch.empty((CHANNELS, n), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().guava_face_gather(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, stream)
    build.check(err, "guava_face_gather")
    launches += 1
    return out


def face_gather_bwd(drows: torch.Tensor, ids: torch.Tensor, seg: torch.Tensor | None,
                    n_faces: int) -> torch.Tensor:
    """drows (16, N) f32, ids (N,) i32 sorted compact face ids, seg
    (n_faces + 1,) i32 the first texel of each face's segment (seg[n_faces]
    = N) -> d_table (n_faces, 16) f32. K4 on CUDA tensors (which needs
    `seg`), `face_gather_bwd_plain` on CPU tensors."""
    global bwd_launches
    n = ids.shape[0]
    if drows.shape != (CHANNELS, n) or drows.dtype != torch.float32:
        raise ValueError(f"drows must be ({CHANNELS}, {n}) float32, got "
                         f"{tuple(drows.shape)} {drows.dtype}")
    if drows.device != ids.device:
        raise ValueError(f"drows on {drows.device}, ids on {ids.device}")
    if drows.device.type == "cpu":
        return face_gather_bwd_plain(drows, ids, n_faces)
    if drows.device.type != "cuda":
        raise ValueError(f"unsupported device {drows.device}")
    if seg is None:
        raise ValueError("the backward kernel needs the plan's segment starts")
    if seg.shape != (n_faces + 1,) or seg.dtype != torch.int32 or seg.device != drows.device:
        raise ValueError(f"seg must be ({n_faces + 1},) int32 on {drows.device}, got "
                         f"{tuple(seg.shape)} {seg.dtype} on {seg.device}")
    if not (drows.is_contiguous() and seg.is_contiguous()):
        raise ValueError("drows and seg must be contiguous")
    d_table = torch.empty((n_faces, CHANNELS), dtype=torch.float32, device=drows.device)
    with torch.cuda.device(drows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().guava_face_gather_bwd(
            drows.data_ptr(), seg.data_ptr(), d_table.data_ptr(), n, n_faces, stream)
    build.check(err, "guava_face_gather_bwd")
    bwd_launches += 1
    return d_table


class _FaceGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, seg):
        ctx.save_for_backward(ids, seg)
        ctx.n_faces = table.shape[0]
        return _forward(table, ids)

    @staticmethod
    def backward(ctx, drows):
        ids, seg = ctx.saved_tensors
        return face_gather_bwd(drows.contiguous(), ids, seg, ctx.n_faces), None, None


def face_gather(table: torch.Tensor, ids: torch.Tensor,
                seg: torch.Tensor | None = None) -> torch.Tensor:
    """table (Fc, 16) f32 face table, ids (N,) i32 compact face ids (sorted
    by the plan, each in [0, Fc)) -> rows (16, N) f32. Differentiable in
    `table`; on the card the backward needs `seg`, the plan's (Fc + 1,) i32
    segment starts."""
    _check(table, ids)
    return _FaceGather.apply(table, ids, seg)
