"""K2 and K4: the planned deformer's face-table gather,
rows[c, t] = table[ids[t], c], and its backward,
d_table[f, c] = sum over t with ids[t] == f of drows[c, t].

`face_gather` is differentiable in `table`. For CUDA tensors its forward
launches `csrc/facegather.cu` and its backward `csrc/facegather_bwd.cu` (two
launches: the windows, then the faces that cross them); for CPU tensors they
run `face_gather_plain` and `face_gather_bwd_plain`; nothing else.
`face_gather_bwd_windowed_plain` models the backward kernel's partition and
order of additions in PyTorch, for the tests.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

CHANNELS = 16
LANE_TEXELS = 8    # texels a lane of the backward kernel sums (csrc/facegather_bwd.cu)
WINDOW = 32 * LANE_TEXELS   # texels a warp sums
BWD_LAUNCHES = 2   # kernel launches of one backward call (windows, then the crossing faces)
launches = 0       # K2 (forward) kernel launches so far in this process
bwd_launches = 0   # K4 (backward) kernel launches so far in this process


def face_gather_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (Fc, 16) f32, ids (N,) int -> rows (16, N) f32, channel-major."""
    return table[ids.long()].T.contiguous()


def face_gather_bwd_plain(drows: torch.Tensor, ids: torch.Tensor, n_faces: int) -> torch.Tensor:
    """drows (16, N) f32, ids (N,) int in [0, n_faces) -> d_table (n_faces, 16) f32."""
    d_table = torch.zeros((n_faces, CHANNELS), dtype=drows.dtype, device=drows.device)
    return d_table.index_add_(0, ids.long(), drows.T)


def face_gather_bwd_windowed_plain(drows: torch.Tensor, ids: torch.Tensor, seg: torch.Tensor,
                                   n_faces: int) -> torch.Tensor:
    """`face_gather_bwd_plain`'s d_table, summed as K4 sums it: windows of
    32 lanes of LANE_TEXELS texels (WINDOW texels a window). A lane
    sums its texels face by face in order; a segmented Hillis-Steele scan
    over the lanes' last sums gives each lane's first face the sum its left
    neighbour ends with; a face that crosses window edges adds its windows'
    pieces in window order. The same float32 additions in the same order as
    the kernel, so the same bits."""
    n = ids.shape[0]
    device = drows.device
    d_table = torch.zeros((n_faces, CHANNELS), dtype=torch.float32, device=device)
    if n == 0 or n_faces == 0:
        return d_table
    lane_texels, window = LANE_TEXELS, WINDOW
    n_win = -(-n // window)
    pad = n_win * window - n
    # (16, windows, lanes, texels) values and (windows, lanes, texels) ids, n_faces past n
    x = torch.nn.functional.pad(drows, (0, pad)).reshape(CHANNELS, n_win, 32, lane_texels)
    full = torch.cat([ids.long(), torch.full((pad,), n_faces, dtype=torch.long, device=device)])
    a = full.reshape(n_win, 32, lane_texels)
    p = torch.cat([full.new_full((1,), -1), full[:-1]]).reshape(a.shape)[..., 0]
    nx = torch.cat([full[1:], full.new_full((1,), n_faces)]).reshape(a.shape)[..., -1]
    lane = torch.arange(32, device=device)
    first_crossing = torch.where(p[:, 0] == a[:, 0, 0], a[:, 0, 0], -1)        # (windows,)
    s = [x[..., 0]]
    for j in range(1, lane_texels):
        s.append(torch.where(a[..., j] == a[..., j - 1], s[-1] + x[..., j], x[..., j]))
    v = s[-1]
    flag = (lane == 0) | (a[..., -1] != p)                                      # (windows, 32)
    d = 1
    while d < 32:
        y = torch.nn.functional.pad(v, (d, 0))[..., :32]
        g = torch.nn.functional.pad(flag, (d, 0))[..., :32]
        upd = lane >= d
        v = torch.where(upd & ~flag, y + v, v)
        flag = torch.where(upd, flag | g, flag)
        d *= 2
    e = torch.nn.functional.pad(v, (1, 0))[..., :32]
    cont = (lane > 0) & (a[..., 0] == p)
    head = torch.zeros((n_win, CHANNELS), dtype=torch.float32, device=device)
    tail = torch.zeros_like(head)
    for j in range(lane_texels):
        f = a[..., j]
        part = torch.where(cont & (f == a[..., 0]), e + s[j], s[j])            # (16, windows, 32)
        after = a[..., j + 1] if j + 1 < lane_texels else nx
        ends = (f != after) & (f < n_faces)
        to_head = ends & (f == first_crossing[:, None])
        wi, li = (ends & ~to_head).nonzero(as_tuple=True)
        d_table[f[wi, li]] = part[:, wi, li].T
        wi, li = to_head.nonzero(as_tuple=True)
        head[wi] = part[:, wi, li].T
    last = a[:, 31, -1]
    goes_on = (last < n_faces) & (nx[:, 31] == last)
    tail[goes_on] = part[:, goes_on, 31].T
    # the faces that cross window edges, each from the first edge it crosses
    for b in range(1, n_win):
        t = b * window
        f = int(full[t])
        if int(full[t - 1]) != f or int(seg[f]) < t - window:
            continue
        lastw = (int(seg[f + 1]) - 1) // window
        acc = tail[b - 1]
        for w in range(b, lastw):
            acc = acc + tail[w]
        d_table[f] = acc + head[lastw]
    return d_table


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
    if table.is_cuda and table.data_ptr() % 16:
        raise ValueError("the gather reads table rows in 16-byte pieces: the table must start "
                         "on a 16-byte boundary")


def occupancy():
    """{"ctas_per_sm": n, "smem_bytes": b} of the built K2
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    n, smem = ctypes.c_int(0), ctypes.c_int(0)
    build.check(build.library().guava_face_gather_occupancy(ctypes.addressof(n),
                                                             ctypes.addressof(smem)),
                "guava_face_gather_occupancy")
    return {"ctas_per_sm": n.value, "smem_bytes": smem.value}


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
    `seg` and N % 4 == 0; two launches), `face_gather_bwd_plain` on CPU
    tensors."""
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
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be (N,) int32, got {tuple(ids.shape)} {ids.dtype}")
    if seg is None:
        raise ValueError("the backward kernel needs the plan's segment starts")
    if seg.shape != (n_faces + 1,) or seg.dtype != torch.int32 or seg.device != drows.device:
        raise ValueError(f"seg must be ({n_faces + 1},) int32 on {drows.device}, got "
                         f"{tuple(seg.shape)} {seg.dtype} on {seg.device}")
    if not (drows.is_contiguous() and ids.is_contiguous() and seg.is_contiguous()):
        raise ValueError("drows, ids and seg must be contiguous")
    if n % 4 or drows.data_ptr() % 16 or ids.data_ptr() % 16:
        raise ValueError(f"the backward kernel reads 16-byte pieces: N ({n}) must be a multiple "
                         f"of 4 and drows and ids must start on 16-byte boundaries")
    d_table = torch.empty((n_faces, CHANNELS), dtype=torch.float32, device=drows.device)
    carry = torch.empty((2, -(-n // WINDOW), CHANNELS), dtype=torch.float32, device=drows.device)
    with torch.cuda.device(drows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().guava_face_gather_bwd(
            drows.data_ptr(), ids.data_ptr(), seg.data_ptr(), carry.data_ptr(),
            d_table.data_ptr(), n, n_faces, stream)
    build.check(err, "guava_face_gather_bwd")
    if n > 0 and n_faces > 0:
        bwd_launches += BWD_LAUNCHES
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
