"""K1 and K3: the tile blend of the 32-channel Gaussian rasterizer, forward
and backward, and the forward's variants K6 (bf16 rows), K7 (a resident
table for the largest Gaussians) and K8 (a per-instance stream), whose
backward is K3; and K1p (`blend_probe`, `csrc/blend_probe.cu`), K1 with a
count of the rounds each tile ran, for the early-exit probe
(`tools/ee_probe.py`).

Every blend walks each bin tile as sub-tiles of 16 x 16 pixels (8 x 8 at
tile 8), one CTA each, and each warp drops the rows no pixel of its own
8 x 4 block can take (`csrc/blend_subtile.cuh`); `subtile_geometry` and
`cull_keep_plain` state that cut and that cull in PyTorch ops. The forward
blends are one kernel (`csrc/blend_subtile_fwd.cuh`) with four row sources:
the table (K1, and K1p with its rounds), the table or the resident table by
id (K7; `resident_source_plain`), packed rows widened to f32 (K6;
`unpack_rows_bf16`) and the stream, instance i at row i (K8). On the same
f32 rows their images are the same bit for bit.

`blend`, `blend_bf16`, `blend_resident` and `blend_stream` are
differentiable in `rows` and `bg`. For CUDA tensors their forwards launch
`csrc/blend.cu`, `csrc/blend_bf16.cu`, `csrc/blend_resident.cu` and
`csrc/blend_stream.cu`, and every backward `csrc/blend_bwd.cu`; for CPU
tensors they run the plain versions (`blend_plain` and the `*_plain`
functions below, `blend_bwd_plain`); nothing else.

Per-Gaussian rows are (P, 44) f32:
  [x, y, conic_a, conic_b, conic_c, alpha, 0, 0 | 32 colors, invdepth, 0, 0, 0].
`order` lists Gaussian ids grouped by tile (tiles row-major) and
depth-ascending within each tile; tile t owns order[ranges[t]:ranges[t+1]].
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..utils.logging_utils import spanned
from . import build

GEOM = 8
CHANNELS = 32
ROW = 44
ROW_BF16 = 56      # a packed row: geometry hi and lo, 32 colors + invdepth, zeros (112 B)
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_MIN = 1e-4
launches = 0            # K1 (forward) kernel launches so far in this process
bwd_launches = 0        # K3 (backward) kernel launches so far in this process
bf16_launches = 0       # K6
resident_launches = 0   # K7
stream_launches = 0     # K8
probe_launches = 0      # K1p
MAX_PROBE_CHUNK = 256   # K1p's largest stage (csrc/blend_probe.cu)
# the cull's room for float32 rounding, a share of the largest quadratic term
# over the box (csrc/blend_subtile.cuh:kCullSlack)
CULL_SLACK = 2.0 ** -18


class SubtileGeometry(NamedTuple):
    """How K1 and K3 cut an image tiled by `tile` into CTAs
    (csrc/blend_subtile.cuh:subtile_of)."""

    side: int              # sub-tile side: 16, 8, or the tile itself
    per_tile: int          # sub-tiles a bin tile
    n_ctas: int            # one a sub-tile; bin tile t's are CTAs t * per_tile + s
    threads: int           # threads a CTA: side^2 in whole warps
    px: torch.Tensor       # (n_ctas, threads) int64 pixel x of each thread, -1 for none
    py: torch.Tensor       # (n_ctas, threads) int64 pixel y


def subtile_side(tile: int) -> int:
    """Side of the sub-tiles of a bin tile: 16 for multiples of 16, 8 for
    other multiples of 8, else the tile itself."""
    return 16 if tile % 16 == 0 else 8 if tile % 8 == 0 else tile


def subtile_geometry(height: int, width: int, tile: int) -> SubtileGeometry:
    """The CTAs of K1 and K3 and each thread's pixel. Sub-tiles of side 8
    and 16 give each warp an 8 x 4 block of pixels, the warps row-major
    over the sub-tile; other sides lay the pixels out row-major."""
    side = subtile_side(tile)
    per = tile // side
    gx = width // tile
    n_tiles = gx * (height // tile)
    threads = (side * side + 31) // 32 * 32
    tiles = torch.arange(n_tiles)[:, None]
    s = torch.arange(per * per)
    x0 = (tiles % gx) * tile + (s % per) * side      # (n_tiles, per_tile) first pixels
    y0 = (tiles // gx) * tile + (s // per) * side
    t = torch.arange(threads)
    if side % 8 == 0:
        warp, lane = t // 32, t % 32
        lx = (warp % (side // 8)) * 8 + lane % 8
        ly = (warp // (side // 8)) * 4 + lane // 8
    else:
        lx, ly = t % side, t // side
    active = t < side * side
    px = torch.where(active, x0.reshape(-1, 1) + lx, -1)
    py = torch.where(active, y0.reshape(-1, 1) + ly, -1)
    return SubtileGeometry(side, per * per, n_tiles * per * per, threads, px, py)


def cull_qcut_plain(conic, alpha):
    """The q above which alpha * exp(-q / 2) is below the blend's 1/255:
    2 ln(max(255 alpha, 1)) + 1e-3, +inf where the conic (..., 3) = (a, b,
    c) is not positive definite (the JAX package's `_cull_qcut`)."""
    ca, cb, cc = conic.unbind(-1)
    pd = (ca > 0.0) & (cc > 0.0) & (ca * cc - cb * cb > 0.0)
    qcut = 2.0 * torch.log(torch.clamp(255.0 * alpha, min=1.0)) + 1e-3
    return torch.where(pd, qcut, math.inf)


def box_qmin_plain(bx0, by0, span_x, span_y, conic):
    """Minimum of q(d) = a dx^2 + 2 b dx dy + c dy^2 over the box
    [bx0, bx0 + span_x] x [by0, by0 + span_y] of offsets d = pixel - mean,
    for a positive definite conic (..., 3): 0 if the box holds d = 0, else
    the least of the four edges' minima (the JAX package's `_slot_qmin`, on
    a rectangle)."""
    ca, cb, cc = conic.unbind(-1)
    bx1 = bx0 + span_x
    by1 = by0 + span_y

    def edge_x(e):
        dy = torch.minimum(torch.maximum(-cb * e / torch.clamp(cc, min=1e-20), by0), by1)
        return (ca * e + 2.0 * cb * dy) * e + cc * dy * dy

    def edge_y(e):
        dx = torch.minimum(torch.maximum(-cb * e / torch.clamp(ca, min=1e-20), bx0), bx1)
        return (cc * e + 2.0 * cb * dx) * e + ca * dx * dx

    qmin = torch.minimum(torch.minimum(edge_x(bx0), edge_x(bx1)),
                         torch.minimum(edge_y(by0), edge_y(by1)))
    inside = (bx0 <= 0.0) & (bx1 >= 0.0) & (by0 <= 0.0) & (by1 >= 0.0)
    return torch.where(inside, 0.0, qmin)


def row_may_reach_plain(geom, x0, y0, span_x, span_y):
    """csrc/blend_subtile.cuh:row_may_reach in PyTorch ops: geom (..., 6) =
    (x, y, conic a, b, c, alpha) rows against boxes of pixel centres
    [x0, x0 + span_x] x [y0, y0 + span_y] -> bool, False only where the
    box's q-minimum lies above the cut by more than CULL_SLACK of the
    largest quadratic term over the box. Rows with a non-finite field are
    kept."""
    mx, my = geom[..., 0], geom[..., 1]
    conic, alpha = geom[..., 2:5], geom[..., 5]
    bx0 = x0 - mx
    by0 = y0 - my
    qmin = box_qmin_plain(bx0, by0, span_x, span_y, conic)
    ex = torch.maximum(bx0.abs(), (bx0 + span_x).abs())
    ey = torch.maximum(by0.abs(), (by0 + span_y).abs())
    ca, cb, cc = conic.unbind(-1)
    largest = ca * ex * ex + 2.0 * cb.abs() * ex * ey + cc * ey * ey
    cull = qmin > cull_qcut_plain(conic, alpha) + CULL_SLACK * largest
    return ~(cull & torch.isfinite(geom).all(-1))


def cull_boxes(tile, level="warp"):
    """The boxes of pixel centres in a bin tile that K1 and K3 cull against:
    level "warp", the bounds of each warp's pixels (what the kernels test),
    or "subtile", each sub-tile. -> x0, y0, span_x, span_y (B,) float32 in
    the tile's own coordinates, and box_of (tile * tile,) int64, the box of
    each pixel of the tile (row-major)."""
    geo = subtile_geometry(tile, tile, tile)
    group = 32 if level == "warp" else geo.threads
    px = geo.px.reshape(-1, group)
    py = geo.py.reshape(-1, group)
    held = px >= 0
    x_lo = torch.where(held, px, tile).amin(1)
    y_lo = torch.where(held, py, tile).amin(1)
    x_hi, y_hi = px.amax(1), py.amax(1)
    box_of = torch.empty(tile * tile, dtype=torch.int64)
    box_of[(py * tile + px)[held]] = torch.arange(px.shape[0])[:, None].expand_as(px)[held]
    return (x_lo.float(), y_lo.float(), (x_hi - x_lo).float(), (y_hi - y_lo).float(), box_of)


def cull_keep_plain(rows, order, ranges, height, width, tile, level="warp"):
    """(N, B) bool: whether instance i (Gaussian order[i], in bin tile t) is
    kept for box k of `cull_boxes(tile, level)` in t, i.e. may reach a pixel
    of it (`row_may_reach_plain`). Arguments as `blend`; level "warp" is
    the kernels' own cull."""
    gx = width // tile
    x0, y0, span_x, span_y, _ = (v.to(rows.device) for v in cull_boxes(tile, level))
    counts = (ranges[1:] - ranges[:-1]).long()
    tile_of = torch.repeat_interleave(torch.arange(counts.numel(), device=rows.device), counts)
    ox = ((tile_of % gx) * tile).float()[:, None]
    oy = ((tile_of // gx) * tile).float()[:, None]
    geom = rows[order[:tile_of.numel()].long(), :6]
    return row_may_reach_plain(geom[:, None, :], ox + x0, oy + y0, span_x, span_y)


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
    return _walk_plain(rows, order, ranges, bg, height, width, tile)


def blend_culled_plain(rows, order, ranges, bg, height, width, tile):
    """K1's walk as the kernel runs it, in PyTorch ops: `blend_plain` with
    every pixel skipping the rows its warp's cull drops (`cull_keep_plain`).
    Equal to `blend_plain` bit for bit wherever the cull drops only rows
    the pixels would have skipped."""
    return _walk_plain(rows, order, ranges, bg, height, width, tile,
                       keep=_warp_keep(rows, order, ranges, height, width, tile))


def blend_probe_plain(rows, order, ranges, bg, height, width, tile, level="tile",
                      culled=False):
    """`blend_plain`'s (color, invdepth, final_t) and last_death int32: the
    instance (0 = the tile's first) at which the last pixel of a tile
    (level "tile": (gy, gx)) or of each of its sub-tiles (level "subtile":
    (gy, gx, sub-tiles a tile), sub-tile s at column s % (tile / side), row
    s // (tile / side), as K1p's CTAs take them) finished, i.e. hit
    T * (1 - alpha) < 1e-4 on a contributing instance; -1 where some pixel
    never finishes. With culled, each pixel skips the rows its warp's cull
    drops, as the kernel walks. `chunks_run` turns a last death into K1p's
    count for any (chunk, exit_every); the tile's count is the largest of
    its sub-tiles' (csrc/blend_probe.cu)."""
    if level not in ("tile", "subtile"):
        raise ValueError(f"level must be 'tile' or 'subtile', got {level!r}")
    keep = _warp_keep(rows, order, ranges, height, width, tile) if culled else None
    return _walk_plain(rows, order, ranges, bg, height, width, tile, deaths=level, keep=keep)


def chunks_run(last_death, ranges, chunk, exit_every):
    """int32 rounds a tile (gy, gx) or a sub-tile (gy, gx, s) of K1p (and a
    tile of the JAX blend_probe) runs, from `blend_probe_plain`'s last
    death: ceil(n / chunk) where exit_every is 0 or some pixel never
    finishes, else min(ceil(n / chunk), exit_every * ceil((c + 1) /
    exit_every)) with c = last_death // chunk, the round in which the last
    pixel finished."""
    gy, gx = last_death.shape[:2]
    n = (ranges[1:] - ranges[:-1]).long().reshape(gy, gx, *(1,) * (last_death.dim() - 2))
    total = (n + chunk - 1) // chunk
    if exit_every == 0:
        return total.expand(last_death.shape).to(torch.int32)
    last = last_death.long()
    stop = (last // chunk + exit_every) // exit_every * exit_every
    return torch.where(last >= 0, torch.minimum(total, stop), total).to(torch.int32)


def probe_stage_rows(chunk):
    """Rows a round of the stage K1p runs `chunk` rows a round in: K1's
    stage (128) up to 128, the 256-row stage past it (csrc/blend_probe.cu)."""
    if not 1 <= chunk <= MAX_PROBE_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_PROBE_CHUNK}], got {chunk}")
    return 128 if chunk <= 128 else 256


def _warp_keep(rows, order, ranges, height, width, tile):
    """The kernels' per-warp keep masks and each pixel's box, as
    `_walk_plain` takes them."""
    return cull_keep_plain(rows, order, ranges, height, width, tile), cull_boxes(tile)[4]


def _walk_plain(rows, order, ranges, bg, height, width, tile, deaths=None, keep=None):
    """`blend_plain`, and with deaths "tile" or "subtile" also
    `blend_probe_plain`'s last_death at that level; with keep = (mask
    (N, B), box_of (tile * tile,)), a pixel skips the instances its box does
    not keep."""
    device = rows.device
    gx = width // tile
    n_tiles = gx * (height // tile)
    pix = tile * tile
    tiles, active, starts, px, py = _tile_order(ranges, width, tile)
    if keep is not None:
        keep, box_of = keep[0], keep[1].to(device)

    T = torch.ones((n_tiles, pix), dtype=torch.float32, device=device)
    done = torch.zeros((n_tiles, pix), dtype=torch.bool, device=device)
    acc = torch.zeros((n_tiles, CHANNELS + 1, pix), dtype=torch.float32, device=device)
    death = torch.full((n_tiles, pix), -1, dtype=torch.int32, device=device) if deaths else None
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
        if keep is not None:
            contrib &= keep[starts[:k] + i][:, box_of]
        alpha = torch.clamp(ag, max=ALPHA_MAX)
        Tk = T[:k]
        test_t = Tk * (1.0 - alpha)
        dies = contrib & (test_t < T_MIN)
        use = contrib & ~dies
        w = torch.where(use, alpha * Tk, 0.0)
        acc[:k] += r[:, GEOM:GEOM + CHANNELS + 1, None] * w[:, None, :]
        T[:k] = torch.where(use, test_t, Tk)
        done[:k] |= dies
        if deaths:
            death[:k] = torch.where(dies, i, death[:k])

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
    if not deaths:
        return color, out[..., CHANNELS:], T_img
    if deaths == "subtile":   # (n_tiles, spt, side^2): each sub-tile's pixels
        side = subtile_side(tile)
        lin = torch.arange(pix, device=device)
        sub = (lin // tile // side) * (tile // side) + lin % tile // side
        death = death[:, torch.argsort(sub, stable=True)].reshape(n_tiles, -1, side * side)
    else:
        death = death[:, None, :]
    last = torch.where((death >= 0).all(-1), death.max(-1).values, -1)[inv]
    last = last.reshape(gy, gx, -1) if deaths == "subtile" else last.reshape(gy, gx)
    return color, out[..., CHANNELS:], T_img, last.to(torch.int32)


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


def pack_rows_bf16(rows: torch.Tensor) -> torch.Tensor:
    """(P, 44) f32 rows -> (P, 56) bf16 packed rows (counterpart of the JAX
    package's `_pack_rows_bf16`, with a 112-byte row for its 128 lanes):
    [0:8) geometry rounded to bf16 (hi), [8:16) the rest rounded to bf16
    (lo), so that hi + lo carries ~16 mantissa bits; [16:49) the 32 colors
    and the inverse depth rounded to bf16; zeros. Rounding is to nearest
    even, as `.astype(bfloat16)` rounds."""
    geom = rows[:, :GEOM]
    hi = geom.to(torch.bfloat16)
    lo = (geom - hi.float()).to(torch.bfloat16)
    colors = rows[:, GEOM:GEOM + CHANNELS + 1].to(torch.bfloat16)
    pad = hi.new_zeros((rows.shape[0], ROW_BF16 - 2 * GEOM - CHANNELS - 1))
    return torch.cat([hi, lo, colors, pad], dim=-1).contiguous()


def unpack_rows_bf16(packed: torch.Tensor) -> torch.Tensor:
    """(P, 56) packed rows -> (P, 44) f32 rows holding exactly the values K6
    blends: geometry hi + lo (one f32 addition), colors and invdepth
    widened."""
    geom = packed[:, :GEOM].float() + packed[:, GEOM:2 * GEOM].float()
    colors = packed[:, 2 * GEOM:2 * GEOM + CHANNELS + 1].float()
    pad = geom.new_zeros((packed.shape[0], ROW - GEOM - CHANNELS - 1))
    return torch.cat([geom, colors, pad], dim=-1)


def blend_bf16_plain(packed, order, ranges, bg, height, width, tile):
    """K6's contract in PyTorch ops: `blend_plain` on the unpacked rows."""
    return blend_plain(unpack_rows_bf16(packed), order, ranges, bg, height, width, tile)


def resident_source_plain(rows, ltable, order):
    """K7's row source (`ResidentRows` in csrc/blend_subtile.cuh) in PyTorch
    ops: the (P + L, 44) table whose row P + r is ltable[r], and `order` with
    every id past P + L - 1 clipped to it, as the kernel (and the TPU
    kernel) clips it. Instance i reads table[order'[i]]."""
    table = torch.cat([rows, ltable])
    return table, order.clamp(max=table.shape[0] - 1)


def blend_resident_plain(rows, ltable, order, ranges, bg, height, width, tile):
    """K7's contract in PyTorch ops: `blend_plain` on the rows that
    `resident_source_plain` gives each instance."""
    return blend_plain(*resident_source_plain(rows, ltable, order), ranges, bg, height, width,
                       tile)


def blend_stream_plain(stream, ranges, bg, height, width, tile):
    """K8's contract in PyTorch ops: `blend_plain` reading the (N, 44)
    stream's rows in their own order."""
    order = torch.arange(stream.shape[0], dtype=torch.int32, device=stream.device)
    return blend_plain(stream, order, ranges, bg, height, width, tile)


def _check_inputs(rows, order, ranges, bg, height, width, tile, row_width=ROW,
                  row_dtype=torch.float32):
    """Check the blend's inputs; `order` None for the stream, which has none."""
    if height % tile or width % tile or tile * tile > 1024:
        raise ValueError(f"image {height}x{width} must tile by {tile} (tile^2 <= 1024)")
    n_tiles = (height // tile) * (width // tile)
    if rows.dim() != 2 or rows.shape[1] != row_width or rows.dtype != row_dtype:
        raise ValueError(f"rows must be (P, {row_width}) {row_dtype}, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if order is not None and (order.dim() != 1 or order.dtype != torch.int32):
        raise ValueError(f"order must be (N,) int32, got {tuple(order.shape)} {order.dtype}")
    if ranges.shape != (n_tiles + 1,) or ranges.dtype != torch.int32:
        raise ValueError(f"ranges must be ({n_tiles + 1},) int32, got "
                         f"{tuple(ranges.shape)} {ranges.dtype}")
    if bg.shape != (CHANNELS,) or bg.dtype != torch.float32:
        raise ValueError(f"bg must be ({CHANNELS},) float32")
    inputs = [t for t in (rows, order, ranges, bg) if t is not None]
    devices = {t.device for t in inputs}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")
    if rows.device.type == "cuda" and not all(t.is_contiguous() for t in inputs):
        raise ValueError("blend inputs must be contiguous")
    if rows.device.type == "cuda" and rows.data_ptr() % 16:
        raise ValueError("rows must start on a 16-byte boundary (the kernels copy 16-byte pieces)")


def _launch(entry, args, height, width, tile, device, extra_out=(), params=()):
    """Allocate the blend's outputs, launch `entry`(*args, outputs, *extra_out,
    height, width, tile, *params, stream) and raise on a launch error."""
    color = torch.empty((height, width, CHANNELS), dtype=torch.float32, device=device)
    invdepth = torch.empty((height, width, 1), dtype=torch.float32, device=device)
    final_t = torch.empty((height, width), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(build.library(), entry)(
            *args, color.data_ptr(), invdepth.data_ptr(), final_t.data_ptr(),
            *(t.data_ptr() for t in extra_out), height, width, tile, *params, stream)
    build.check(err, entry)
    return color, invdepth, final_t


@spanned("guava.blend")
def _forward(rows, order, ranges, bg, height, width, tile):
    """K1 on CUDA tensors, `blend_plain` on CPU tensors."""
    global launches
    if rows.device.type == "cpu":
        return blend_plain(rows, order, ranges, bg, height, width, tile)
    out = _launch("guava_blend_fwd",
                  (rows.data_ptr(), order.data_ptr(), ranges.data_ptr(), bg.data_ptr()),
                  height, width, tile, rows.device)
    launches += 1
    return out


def forward_bf16(packed, order, ranges, bg, height, width, tile):
    """K6 on CUDA tensors, `blend_bf16_plain` on CPU tensors: the forward
    blend of (P, 56) packed rows. Not differentiable (see `blend_bf16`)."""
    global bf16_launches
    _check_inputs(packed, order, ranges, bg, height, width, tile, ROW_BF16, torch.bfloat16)
    if packed.device.type == "cpu":
        return blend_bf16_plain(packed, order, ranges, bg, height, width, tile)
    out = _launch("guava_blend_bf16_fwd",
                  (packed.data_ptr(), order.data_ptr(), ranges.data_ptr(), bg.data_ptr()),
                  height, width, tile, packed.device)
    bf16_launches += 1
    return out


def forward_resident(rows, ltable, order, ranges, bg, height, width, tile):
    """K7 on CUDA tensors, `blend_resident_plain` on CPU tensors: the
    forward blend where an id P + r reads ltable[r] (r < L) and any other
    id reads rows[id]. Not differentiable (see `blend_resident`)."""
    global resident_launches
    _check_inputs(rows, order, ranges, bg, height, width, tile)
    if ltable.dim() != 2 or ltable.shape[1] != ROW or ltable.dtype != torch.float32 \
            or ltable.device != rows.device or (ltable.is_cuda and not ltable.is_contiguous()):
        raise ValueError(f"ltable must be a contiguous (L, {ROW}) float32 tensor on "
                         f"{rows.device}, got {tuple(ltable.shape)} {ltable.dtype}")
    if rows.device.type == "cpu":
        return blend_resident_plain(rows, ltable, order, ranges, bg, height, width, tile)
    if ltable.data_ptr() % 16:
        raise ValueError("ltable must start on a 16-byte boundary (its rows are bulk copies)")
    out = _launch("guava_blend_resident_fwd",
                  (rows.data_ptr(), ltable.data_ptr(), rows.shape[0], ltable.shape[0],
                   order.data_ptr(), ranges.data_ptr(), bg.data_ptr()),
                  height, width, tile, rows.device)
    resident_launches += 1
    return out


def forward_stream(stream, ranges, bg, height, width, tile):
    """K8 on CUDA tensors, `blend_stream_plain` on CPU tensors: the forward
    blend of an (N, 44) per-instance stream, tile t's rows at
    stream[ranges[t]:ranges[t+1]]. Not differentiable (see `blend_stream`)."""
    global stream_launches
    _check_inputs(stream, None, ranges, bg, height, width, tile)
    if stream.device.type == "cpu":
        return blend_stream_plain(stream, ranges, bg, height, width, tile)
    out = _launch("guava_blend_stream_fwd", (stream.data_ptr(), ranges.data_ptr(), bg.data_ptr()),
                  height, width, tile, stream.device)
    stream_launches += 1
    return out


def blend_probe(rows, order, ranges, bg, height, width, tile, chunk, exit_every):
    """K1p on CUDA tensors, `blend_probe_plain` + `chunks_run` on CPU tensors:
    K1's (color, invdepth, final_t) and chunks_run (gy, gx) int32, the rounds
    of `chunk` instances each tile ran when it tests for every pixel being
    done every `exit_every` rounds (0: never). Arguments as `blend`, with
    1 <= chunk <= 256. Not differentiable (as the JAX package's)."""
    global probe_launches
    _check_inputs(rows, order, ranges, bg, height, width, tile)
    if not 1 <= chunk <= MAX_PROBE_CHUNK or exit_every < 0:
        raise ValueError(f"chunk must be in [1, {MAX_PROBE_CHUNK}] and exit_every >= 0, got "
                         f"chunk={chunk}, exit_every={exit_every}")
    rows = rows.detach()
    if rows.device.type == "cpu":
        *out, last = blend_probe_plain(rows, order, ranges, bg, height, width, tile)
        return (*out, chunks_run(last, ranges, chunk, exit_every))
    # each sub-tile CTA raises its tile's count to the rounds it ran (atomicMax)
    counts = torch.zeros((height // tile, width // tile), dtype=torch.int32, device=rows.device)
    out = _launch("guava_blend_probe",
                  (rows.data_ptr(), order.data_ptr(), ranges.data_ptr(), bg.data_ptr()),
                  height, width, tile, rows.device, (counts,),
                  (chunk, exit_every, probe_stage_rows(chunk)))
    probe_launches += 1
    return (*out, counts)


def occupancy(tile):
    """{"K1": {"ctas_per_sm": n, "smem_bytes": b}, "K3": {...}, ...}: CTAs of
    the built K1, K3, K7, K6, K8 and K1p (its 128- and 256-row stages,
    "K1p/128" and "K1p/256") resident on one SM at once at this tile
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the dynamic shared
    memory each CTA takes."""
    lib = build.library()
    queries = {"K1": ("guava_blend_fwd_occupancy",), "K3": ("guava_blend_bwd_occupancy",),
               "K7": ("guava_blend_resident_occupancy",), "K6": ("guava_blend_bf16_occupancy",),
               "K8": ("guava_blend_stream_occupancy",),
               "K1p/128": ("guava_blend_probe_occupancy", 128),
               "K1p/256": ("guava_blend_probe_occupancy", 256)}
    out = {}
    for key, (entry, *stage) in queries.items():
        n, smem = ctypes.c_int(0), ctypes.c_int(0)
        build.check(getattr(lib, entry)(tile, *stage, ctypes.addressof(n),
                                        ctypes.addressof(smem)), entry)
        out[key] = {"ctas_per_sm": n.value, "smem_bytes": smem.value}
    return out


@spanned("guava.blend")
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


def _grads(ctx, rows, order, ranges, bg, color, invdepth, final_t, g_color, g_invdepth):
    """(d rows, d bg) of a forward blend whose decisions K3 replays from
    (rows, order); `ctx.needs_input_grad` (rows, bg, ...) picks which."""
    g_color = torch.zeros_like(color) if g_color is None else g_color.contiguous()
    g_invdepth = torch.zeros_like(invdepth) if g_invdepth is None else g_invdepth.contiguous()
    d_rows = d_bg = None
    if ctx.needs_input_grad[0]:
        d_rows = blend_bwd(rows, order, ranges, bg, color, invdepth, final_t, g_color,
                           g_invdepth, ctx.tile)
    if ctx.needs_input_grad[1]:
        d_bg = (final_t[..., None] * g_color).sum(dim=(0, 1))
    return d_rows, d_bg


class _Blend(torch.autograd.Function):
    """(rows, bg) -> (color, invdepth, final_t); final_t carries no gradient."""

    @staticmethod
    def forward(ctx, rows, bg, order, ranges, height, width, tile):
        color, invdepth, final_t = _forward(rows, order, ranges, bg, height, width, tile)
        ctx.save_for_backward(rows, order, ranges, bg, color, invdepth, final_t)
        ctx.tile = tile
        ctx.mark_non_differentiable(final_t)
        return color, invdepth, final_t

    @staticmethod
    def backward(ctx, g_color, g_invdepth, _g_final_t):
        return (*_grads(ctx, *ctx.saved_tensors, g_color, g_invdepth),
                None, None, None, None, None)


class _BlendBf16(torch.autograd.Function):
    """K6 on the packed rows; K3 on the unpacked ones, so the gradient passes
    straight through the packing (counterpart of `blend_tiles_bf16`)."""

    @staticmethod
    def forward(ctx, rows, bg, order, ranges, height, width, tile):
        packed = pack_rows_bf16(rows)
        color, invdepth, final_t = forward_bf16(packed, order, ranges, bg, height, width, tile)
        ctx.save_for_backward(packed, order, ranges, bg, color, invdepth, final_t)
        ctx.tile = tile
        ctx.mark_non_differentiable(final_t)
        return color, invdepth, final_t

    @staticmethod
    def backward(ctx, g_color, g_invdepth, _g_final_t):
        packed, *rest = ctx.saved_tensors
        return (*_grads(ctx, unpack_rows_bf16(packed), *rest, g_color, g_invdepth),
                None, None, None, None, None)


class _BlendResident(torch.autograd.Function):
    """K7 on (rows, ltable, remapped order); K3 on (rows, original order).
    ltable carries no gradient: its rows are rows[lids], whose gradient K3
    already adds into rows (counterpart of `blend_tiles_vmem`)."""

    @staticmethod
    def forward(ctx, rows, bg, ltable, order, order_orig, ranges, height, width, tile):
        color, invdepth, final_t = forward_resident(rows, ltable, order, ranges, bg, height,
                                                    width, tile)
        ctx.save_for_backward(rows, order_orig, ranges, bg, color, invdepth, final_t)
        ctx.tile = tile
        ctx.mark_non_differentiable(final_t)
        return color, invdepth, final_t

    @staticmethod
    def backward(ctx, g_color, g_invdepth, _g_final_t):
        return (*_grads(ctx, *ctx.saved_tensors, g_color, g_invdepth),
                None, None, None, None, None, None, None)


class _BlendStream(torch.autograd.Function):
    """K8 on the stream; K3 on the f32 per-Gaussian rows and `order`, as the
    JAX package replays on its per-Gaussian table (counterpart of
    `blend_tiles_stream`)."""

    @staticmethod
    def forward(ctx, rows, bg, stream, order, ranges, height, width, tile):
        color, invdepth, final_t = forward_stream(stream, ranges, bg, height, width, tile)
        ctx.save_for_backward(rows, order, ranges, bg, color, invdepth, final_t)
        ctx.tile = tile
        ctx.mark_non_differentiable(final_t)
        return color, invdepth, final_t

    @staticmethod
    def backward(ctx, g_color, g_invdepth, _g_final_t):
        return (*_grads(ctx, *ctx.saved_tensors, g_color, g_invdepth),
                None, None, None, None, None, None)


def blend(rows, order, ranges, bg, height, width, tile):
    """rows (P, 44) f32, order (N,) i32, ranges (gy*gx + 1,) i32, bg (32,) f32
    -> color (H, W, 32), invdepth (H, W, 1), final transmittance (H, W).
    Differentiable in rows and bg."""
    _check_inputs(rows, order, ranges, bg, height, width, tile)
    return _Blend.apply(rows, bg, order, ranges, height, width, tile)


def blend_bf16(rows, order, ranges, bg, height, width, tile):
    """`blend` with the rows packed to bf16 for the forward (K6): the same
    arguments and returns. The image is K1's on `unpack_rows_bf16(
    pack_rows_bf16(rows))`; the gradient is taken there and passed to rows
    unchanged."""
    _check_inputs(rows, order, ranges, bg, height, width, tile)
    return _BlendBf16.apply(rows, bg, order, ranges, height, width, tile)


def blend_resident(rows, ltable, order, order_orig, ranges, bg, height, width, tile):
    """`blend` with a resident table (K7): `order` has the ids of the
    resident Gaussians remapped to P + r, where ltable (L, 44) = rows[lids]
    and r is the Gaussian's place in lids; `order_orig` is the same order
    with the original ids. The image equals `blend(rows, order_orig, ...)`'s."""
    _check_inputs(rows, order_orig, ranges, bg, height, width, tile)
    return _BlendResident.apply(rows, bg, ltable, order, order_orig, ranges, height, width,
                                tile)


def blend_stream(rows, stream, order, ranges, bg, height, width, tile):
    """`blend` reading an (N, 44) per-instance stream (K8): stream[i] carries
    the row of Gaussian order[i] (geometry exact, colors and invdepth as
    the caller rounded them). The gradient is K3's on (rows, order)."""
    _check_inputs(rows, order, ranges, bg, height, width, tile)
    return _BlendStream.apply(rows, bg, stream, order, ranges, height, width, tile)
