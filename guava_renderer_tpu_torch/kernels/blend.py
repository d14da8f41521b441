"""K1: the forward tile blend of the 32-channel Gaussian rasterizer.

`blend` launches `csrc/blend.cu` for CUDA tensors and runs `blend_plain`
for CPU tensors; nothing else.

Per-Gaussian rows are (P, 44) f32:
  [x, y, conic_a, conic_b, conic_c, alpha, 0, 0 | 32 colors, invdepth, 0, 0, 0].
`order` lists Gaussian ids grouped by tile (tiles row-major) and
depth-ascending within each tile; tile t owns order[ranges[t]:ranges[t+1]].
"""

from __future__ import annotations

import torch

from . import build

GEOM = 8
CHANNELS = 32
ROW = 44
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_MIN = 1e-4
launches = 0   # kernel launches so far in this process


def blend_plain(rows, order, ranges, bg, height, width, tile):
    """Same contract as `blend`, in PyTorch ops.

    All tiles advance together, one instance per step, in the kernel's
    sequential per-pixel order (so T is the same running product). Tiles
    are visited in descending instance count, which makes the tiles still
    running at step i a prefix of that order.
    """
    device = rows.device
    gx = width // tile
    n_tiles = gx * (height // tile)
    pix = tile * tile
    counts = (ranges[1:] - ranges[:-1]).long()
    counts_desc, tiles = torch.sort(counts, descending=True, stable=True)
    active = counts_desc.cpu()
    starts = ranges[:-1].long()[tiles]
    lin = torch.arange(pix, device=device)
    px = ((tiles % gx)[:, None] * tile + lin % tile).float()
    py = ((tiles // gx)[:, None] * tile + lin // tile).float()

    T = torch.ones((n_tiles, pix), dtype=torch.float32, device=device)
    done = torch.zeros((n_tiles, pix), dtype=torch.bool, device=device)
    acc = torch.zeros((n_tiles, CHANNELS + 1, pix), dtype=torch.float32, device=device)
    n_steps = int(active[0]) if n_tiles else 0
    k = n_tiles
    for i in range(n_steps):
        while active[k - 1] <= i:
            k -= 1
        r = rows[order[starts[:k] + i].long()]               # (k, ROW)
        d0 = r[:, 0:1] - px[:k]
        d1 = r[:, 1:2] - py[:k]
        power = -0.5 * (r[:, 2:3] * d0 * d0 + r[:, 4:5] * d1 * d1) - r[:, 3:4] * d0 * d1
        ag = r[:, 5:6] * torch.exp(power)
        contrib = (power <= 0.0) & (ag >= ALPHA_MIN) & ~done[:k]
        alpha = torch.clamp(ag, max=ALPHA_MAX)
        Tk = T[:k]
        test_t = Tk * (1.0 - alpha)
        dies = contrib & (test_t < T_MIN)
        use = contrib & ~dies
        w = torch.where(use, alpha * Tk, 0.0)
        acc[:k] += r[:, GEOM:GEOM + CHANNELS + 1, None] * w[:, None, :]
        T[:k] = torch.where(use, test_t, Tk)
        done[:k] |= dies

    # tile order -> image
    inv = torch.empty_like(tiles)
    inv[tiles] = torch.arange(n_tiles, device=device)
    gy = height // tile

    def to_image(x):   # (n_tiles, C, pix) in sorted order -> (H, W, C)
        x = x[inv].reshape(gy, gx, -1, tile, tile)
        return x.permute(0, 3, 1, 4, 2).reshape(height, width, -1)

    out = to_image(acc)
    T_img = to_image(T[:, None, :])[..., 0]
    color = out[..., :CHANNELS] + T_img[..., None] * bg
    return color, out[..., CHANNELS:], T_img


def blend(rows, order, ranges, bg, height, width, tile):
    """rows (P, 44) f32, order (N,) i32, ranges (gy*gx + 1,) i32, bg (32,) f32
    -> color (H, W, 32), invdepth (H, W, 1), final transmittance (H, W)."""
    global launches
    if height % tile or width % tile or tile * tile > 1024:
        raise ValueError(f"image {height}x{width} must tile by {tile} (tile^2 <= 1024)")
    n_tiles = (height // tile) * (width // tile)
    if rows.dim() != 2 or rows.shape[1] != ROW or rows.dtype != torch.float32:
        raise ValueError(f"rows must be (P, {ROW}) float32, got {tuple(rows.shape)} {rows.dtype}")
    if order.dim() != 1 or order.dtype != torch.int32:
        raise ValueError(f"order must be (N,) int32, got {tuple(order.shape)} {order.dtype}")
    if ranges.shape != (n_tiles + 1,) or ranges.dtype != torch.int32:
        raise ValueError(f"ranges must be ({n_tiles + 1},) int32, got "
                         f"{tuple(ranges.shape)} {ranges.dtype}")
    if bg.shape != (CHANNELS,) or bg.dtype != torch.float32:
        raise ValueError(f"bg must be ({CHANNELS},) float32")
    devices = {t.device for t in (rows, order, ranges, bg)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    device = rows.device
    if device.type == "cpu":
        return blend_plain(rows, order, ranges, bg, height, width, tile)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not all(t.is_contiguous() for t in (rows, order, ranges, bg)):
        raise ValueError("blend inputs must be contiguous")
    color = torch.empty((height, width, CHANNELS), dtype=torch.float32, device=device)
    invdepth = torch.empty((height, width, 1), dtype=torch.float32, device=device)
    final_t = torch.empty((height, width), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().guava_blend_fwd(
            rows.data_ptr(), order.data_ptr(), ranges.data_ptr(), bg.data_ptr(),
            color.data_ptr(), invdepth.data_ptr(), final_t.data_ptr(),
            height, width, tile, stream)
    build.check(err, "guava_blend_fwd")
    launches += 1
    return color, invdepth, final_t
