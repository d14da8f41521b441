"""K1 and K3: the tile blend of the 32-channel Gaussian rasterizer, forward
and backward.

`blend` is differentiable in `rows` and `bg`. For CUDA tensors its forward
launches `csrc/blend.cu` and its backward `csrc/blend_bwd.cu`; for CPU
tensors they run `blend_plain` and `blend_bwd_plain`; nothing else.

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
launches = 0       # K1 (forward) kernel launches so far in this process
bwd_launches = 0   # K3 (backward) kernel launches so far in this process


def _tile_order(ranges, width, tile):
    """Tiles in descending instance count -> (tile ids, their counts on the
    host, their first instance, pixel x (n_tiles, pix), pixel y)."""
    device = ranges.device
    gx = width // tile
    pix = tile * tile
    counts = (ranges[1:] - ranges[:-1]).long()
    counts_desc, tiles = torch.sort(counts, descending=True, stable=True)
    lin = torch.arange(pix, device=device)
    px = ((tiles % gx)[:, None] * tile + lin % tile).float()
    py = ((tiles // gx)[:, None] * tile + lin // tile).float()
    return tiles, counts_desc.cpu(), ranges[:-1].long()[tiles], px, py


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
    tiles, active, starts, px, py = _tile_order(ranges, width, tile)

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


def blend_bwd_plain(rows, order, ranges, bg, color, invdepth, final_t, g_color, g_invdepth,
                    tile):
    """Gradient of `blend_plain`'s (color, invdepth) with respect to `rows`,
    as an explicit replay in PyTorch ops (no autograd graph).

    rows (P, 44), order, ranges, bg (32,) as in `blend`; color (H, W, 32),
    invdepth (H, W, 1), final_t (H, W) are the forward's outputs; g_color
    (H, W, 32), g_invdepth (H, W, 1) the output gradients -> d_rows (P, 44).

    All tiles advance together, one instance a step, front to back with the
    forward's decisions. With gc = sum_c color_c * g_c over the 33 channels,
    w = alpha * T and a running prefix = sum w * gc, a contributing pair has
      d alpha = T * gc - (u - prefix) / (1 - alpha) - T_final * gbg / (1 - alpha),
    u = sum_c g_c * (out_c - bg_c * T_final), gbg = sum_c g_c * bg_c. The
    gradient passes the 0.99 clamp as identity, as in the CUDA reference.
    """
    device = rows.device
    height, width = final_t.shape
    gy, gx = height // tile, width // tile
    n_tiles = gx * gy
    pix = tile * tile
    tiles, active, starts, px, py = _tile_order(ranges, width, tile)

    def to_tiles(x):   # (H, W, C) -> (n_tiles, C, pix) in the sorted tile order
        C = x.shape[-1]
        x = x.reshape(gy, tile, gx, tile, C).permute(0, 2, 4, 1, 3)
        return x.reshape(n_tiles, C, pix)[tiles]

    g = to_tiles(torch.cat([g_color, g_invdepth], dim=-1))          # (n_tiles, 33, pix)
    out = to_tiles(torch.cat([color, invdepth], dim=-1))
    t_final = to_tiles(final_t[..., None])[:, 0]                     # (n_tiles, pix)
    bg33 = torch.cat([bg, bg.new_zeros(1)])[None, :, None]
    u = (g * (out - bg33 * t_final[:, None])).sum(1)
    tfg = t_final * (g * bg33).sum(1)

    T = torch.ones((n_tiles, pix), dtype=torch.float32, device=device)
    done = torch.zeros((n_tiles, pix), dtype=torch.bool, device=device)
    prefix = torch.zeros((n_tiles, pix), dtype=torch.float32, device=device)
    d_rows = torch.zeros_like(rows)
    n_steps = int(active[0]) if n_tiles else 0
    k = n_tiles
    for i in range(n_steps):
        while active[k - 1] <= i:
            k -= 1
        gid = order[starts[:k] + i].long()
        r = rows[gid]                                                # (k, ROW)
        d0 = r[:, 0:1] - px[:k]
        d1 = r[:, 1:2] - py[:k]
        power = -0.5 * (r[:, 2:3] * d0 * d0 + r[:, 4:5] * d1 * d1) - r[:, 3:4] * d0 * d1
        gexp = torch.exp(torch.clamp(power, max=0.0))   # power > 0 never contributes
        ag = r[:, 5:6] * gexp
        contrib = (power <= 0.0) & (ag >= ALPHA_MIN) & ~done[:k]
        alpha = torch.clamp(ag, max=ALPHA_MAX)
        Tk = T[:k]
        test_t = Tk * (1.0 - alpha)
        dies = contrib & (test_t < T_MIN)
        use = contrib & ~dies
        gk = g[:k]
        gc = torch.einsum("kc,kcp->kp", r[:, GEOM:GEOM + CHANNELS + 1], gk)
        w = torch.where(use, alpha * Tk, 0.0)
        prefix[:k] += w * gc
        inv1ma = 1.0 / (1.0 - alpha)
        dalpha = torch.where(use, Tk * gc - (u[:k] - prefix[:k]) * inv1ma - tfg[:k] * inv1ma, 0.0)
        dG = r[:, 5:6] * dalpha
        gdx = gexp * d0
        gdy = gexp * d1
        grad = torch.zeros((k, ROW), dtype=torch.float32, device=device)
        grad[:, 0] = (dG * (-gdx * r[:, 2:3] - gdy * r[:, 3:4])).sum(1)
        grad[:, 1] = (dG * (-gdy * r[:, 4:5] - gdx * r[:, 3:4])).sum(1)
        grad[:, 2] = (dG * (-0.5 * gdx * d0)).sum(1)
        grad[:, 3] = (dG * (-gdx * d1)).sum(1)
        grad[:, 4] = (dG * (-0.5 * gdy * d1)).sum(1)
        grad[:, 5] = (gexp * dalpha).sum(1)
        grad[:, GEOM:GEOM + CHANNELS + 1] = torch.einsum("kp,kcp->kc", w, gk)
        d_rows.index_add_(0, gid, grad)
        T[:k] = torch.where(use, test_t, Tk)
        done[:k] |= dies
    return d_rows


def _check_inputs(rows, order, ranges, bg, height, width, tile):
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
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")
    if rows.device.type == "cuda" and not all(
            t.is_contiguous() for t in (rows, order, ranges, bg)):
        raise ValueError("blend inputs must be contiguous")


def _forward(rows, order, ranges, bg, height, width, tile):
    """K1 on CUDA tensors, `blend_plain` on CPU tensors."""
    global launches
    device = rows.device
    if device.type == "cpu":
        return blend_plain(rows, order, ranges, bg, height, width, tile)
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


def blend_bwd(rows, order, ranges, bg, color, invdepth, final_t, g_color, g_invdepth, tile):
    """d_rows (P, 44) of the blend: K3 on CUDA tensors, `blend_bwd_plain` on
    CPU tensors. Arguments as `blend_bwd_plain`."""
    global bwd_launches
    height, width = final_t.shape
    _check_inputs(rows, order, ranges, bg, height, width, tile)
    images = {"color": (color, CHANNELS), "invdepth": (invdepth, 1),
              "g_color": (g_color, CHANNELS), "g_invdepth": (g_invdepth, 1)}
    for name, (t, c) in images.items():
        if t.shape != (height, width, c) or t.dtype != torch.float32 \
                or t.device != rows.device or (t.is_cuda and not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({height}, {width}, {c}) float32 "
                             f"tensor on {rows.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if final_t.dtype != torch.float32 or final_t.device != rows.device \
            or (final_t.is_cuda and not final_t.is_contiguous()):
        raise ValueError("final_t must be a contiguous float32 tensor beside rows")
    device = rows.device
    if device.type == "cpu":
        return blend_bwd_plain(rows, order, ranges, bg, color, invdepth, final_t, g_color,
                               g_invdepth, tile)
    if (tile * tile) % 32:
        raise ValueError(f"the backward kernel reduces per warp: tile^2 = {tile * tile} "
                         f"must be a multiple of 32")
    d_rows = torch.zeros_like(rows)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().guava_blend_bwd(
            rows.data_ptr(), order.data_ptr(), ranges.data_ptr(), bg.data_ptr(),
            color.data_ptr(), invdepth.data_ptr(), final_t.data_ptr(),
            g_color.data_ptr(), g_invdepth.data_ptr(), d_rows.data_ptr(),
            height, width, tile, stream)
    build.check(err, "guava_blend_bwd")
    bwd_launches += 1
    return d_rows


class _Blend(torch.autograd.Function):
    """(rows, bg) -> (color, invdepth, final_t); final_t carries no gradient."""

    @staticmethod
    def forward(ctx, rows, bg, order, ranges, height, width, tile):
        color, invdepth, final_t = _forward(rows, order, ranges, bg, height, width, tile)
        ctx.save_for_backward(rows, bg, order, ranges, color, invdepth, final_t)
        ctx.tile = tile
        ctx.mark_non_differentiable(final_t)
        return color, invdepth, final_t

    @staticmethod
    def backward(ctx, g_color, g_invdepth, _g_final_t):
        rows, bg, order, ranges, color, invdepth, final_t = ctx.saved_tensors
        g_color = torch.zeros_like(color) if g_color is None else g_color.contiguous()
        g_invdepth = (torch.zeros_like(invdepth) if g_invdepth is None
                      else g_invdepth.contiguous())
        d_rows = d_bg = None
        if ctx.needs_input_grad[0]:
            d_rows = blend_bwd(rows, order, ranges, bg, color, invdepth, final_t, g_color,
                               g_invdepth, ctx.tile)
        if ctx.needs_input_grad[1]:
            d_bg = (final_t[..., None] * g_color).sum(dim=(0, 1))
        return d_rows, d_bg, None, None, None, None, None


def blend(rows, order, ranges, bg, height, width, tile):
    """rows (P, 44) f32, order (N,) i32, ranges (gy*gx + 1,) i32, bg (32,) f32
    -> color (H, W, 32), invdepth (H, W, 1), final transmittance (H, W).
    Differentiable in rows and bg."""
    _check_inputs(rows, order, ranges, bg, height, width, tile)
    return _Blend.apply(rows, bg, order, ranges, height, width, tile)
