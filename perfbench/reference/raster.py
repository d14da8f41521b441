"""The reference rasterizer: projection (frozen), tile binning and the tile
blend, in plain PyTorch ops.

It computes what the port's `ops/gsplat.py:rasterize` computes on its
default path (kernel K1), written again from the 3DGS rules rather than
from the port's binning and walk:

- a Gaussian bins into every tile of its rect (`tile_rect` over
  `radius_bin`) when it is in the frustum and its opacity reaches 1/255;
- a tile takes its Gaussians by ascending depth, ties by Gaussian id;
- a pixel (x, y), at integer coordinates, takes Gaussian i where
  power = -(a dx^2 + c dy^2) / 2 - b dx dy <= 0 and alpha_i = opacity
  * exp(power) >= 1/255, at min(alpha_i, 0.99) with weight alpha_i * T,
  T the product of (1 - alpha_j) over the Gaussians it took before; it
  stops at the first Gaussian that would take T below 1e-4, without it.

The blend walks all tiles at once, `chunk` instances a step, the running
product within a step by `cumprod`. It counts the (pixel, Gaussian) pairs
that contribute, which the roofline counts take as the work the inputs
need (`perfbench/counts.py`).
"""

from __future__ import annotations

import torch

from .frozen.ops.gsplat_project import project_gaussians, tile_rect

CHANNELS = 32
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_MIN = 1e-4


def bin_tiles(proj, width: int, height: int, tile: int):
    """-> (starts (n_tiles,), counts (n_tiles,), ids (N,)) : tile t holds the
    Gaussian ids ids[starts[t]:starts[t] + counts[t]], depth-ascending."""
    dev = proj.mean2d.device
    gx, gy = -(-width // tile), -(-height // tile)
    x0, y0, x1, y1 = tile_rect(proj.mean2d, proj.radius_bin, width, height, tile)
    rw, rh = (x1 - x0).long(), (y1 - y0).long()
    ok = proj.valid & (proj.alpha >= ALPHA_MIN) & (rw > 0) & (rh > 0)
    n_rect = torch.where(ok, rw * rh, 0)
    gid = torch.repeat_interleave(torch.arange(n_rect.shape[0], device=dev), n_rect)
    first = torch.cumsum(n_rect, 0) - n_rect
    k = torch.arange(gid.shape[0], device=dev) - first[gid]
    tiles = (y0.long()[gid] + k // rw[gid]) * gx + x0.long()[gid] + k % rw[gid]
    # ascending depth, ties by id (gid ascends), then tiles in order
    by_depth = torch.sort(proj.depth[gid], stable=True).indices
    gid, tiles = gid[by_depth], tiles[by_depth]
    by_tile = torch.sort(tiles, stable=True).indices
    counts = torch.bincount(tiles, minlength=gx * gy)
    return torch.cumsum(counts, 0) - counts, counts, gid[by_tile]


def _blend_chunk(T_in, done_in, mean2d, conic, alpha, feats, g, live, px, py):
    """One step of the differentiable walk over (k tiles, chunk instances):
    -> (weighted sum (k, pix, C), T after, done after, contributing pairs).
    The 0.99 clamp passes the gradient as the identity, as the port's
    backward (K3) and the CUDA reference take it."""
    dx = mean2d[g, 0][..., None] - px[:, None, :]
    dy = mean2d[g, 1][..., None] - py[:, None, :]
    ca, cb, cc = (conic[g, i][..., None] for i in range(3))
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    ag = alpha[g][..., None] * torch.exp(torch.clamp(power, max=0.0))
    take = live[..., None] & (power <= 0.0) & (ag >= ALPHA_MIN) & ~done_in[:, None, :]
    clamped = ag - (ag - torch.clamp(ag, max=ALPHA_MAX)).detach()
    a = torch.where(take, clamped, torch.zeros_like(ag))
    t_in = T_in[:, None, :] * torch.cumprod(1.0 - a, dim=1)
    dies = take & (t_in < T_MIN)
    use = take & (torch.cumsum(dies.int(), dim=1) == 0)
    t_before = torch.cat([T_in[:, None, :], t_in[:, :-1]], dim=1)
    w = torch.where(use, a * t_before, torch.zeros_like(a))
    contrib = torch.einsum("kjp,kjc->kpc", w, feats[g])
    T_out = T_in * torch.prod(torch.where(use, 1.0 - a, torch.ones_like(a)), dim=1)
    return contrib, T_out, done_in | dies.any(dim=1), use.sum()


def blend_tiles(mean2d, conic, alpha, feats, starts, counts, ids, width: int, height: int,
                tile: int, chunk: int = 8, grad: bool = False):
    """-> (acc (H, W, C), contributing pairs): acc the weighted sum of
    `feats` (P, C). With `grad`, gradients reach mean2d, conic, alpha and
    feats: each step is a function of its inputs alone, recomputed in the
    backward pass (torch.utils.checkpoint), so the walk keeps one
    transmittance a step."""
    import torch.utils.checkpoint as ckpt

    dev = mean2d.device
    gx, gy = width // tile, height // tile
    n_tiles, pix, C = counts.shape[0], tile * tile, feats.shape[1]
    counts_desc, order = torch.sort(counts, descending=True, stable=True)
    counts_host = counts_desc.cpu()
    lin = torch.arange(pix, device=dev)
    px = ((order % gx)[:, None] * tile + lin % tile).float()
    py = ((order // gx)[:, None] * tile + lin // tile).float()
    first = starts[order]
    T = torch.ones(n_tiles, pix, device=dev)
    done = torch.zeros(n_tiles, pix, dtype=torch.bool, device=dev)
    acc = torch.zeros(n_tiles, pix, C, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    j = torch.arange(chunk, device=dev)
    steps = int(counts_host[0]) if n_tiles else 0
    for s in range(0, steps, chunk):
        k = int((counts_host > s).sum())            # tiles still walking: a prefix
        pos = s + j
        live = pos[None, :] < counts_desc[:k, None]   # (k, chunk)
        g = ids[torch.where(live, first[:k, None] + pos, 0)]
        args = (T[:k], done[:k], mean2d, conic, alpha, feats, g, live, px[:k], py[:k])
        contrib, T_k, done_k, n = (ckpt.checkpoint(_blend_chunk, *args, use_reentrant=False)
                                   if grad else _blend_chunk(*args))
        acc = torch.cat([acc[:k] + contrib, acc[k:]])
        T = torch.cat([T_k, T[k:]])
        done = torch.cat([done_k, done[k:]])
        pairs = pairs + n
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n_tiles, device=dev)
    acc = acc[inv].reshape(gy, gx, tile, tile, C).permute(0, 2, 1, 3, 4)
    return acc.reshape(height, width, C), int(pairs)


def rasterize(means3d, colors, opacities, scales, quats, cam, tile: int, chunk: int = 8,
              grad: bool = False):
    """(P, 3), (P, 32), (P, 1), (P, 3), (P, 4) wxyz and a camera ->
    (color (H, W, 32) on a black background, invdepth (H, W), contributing
    pairs, binned instances); with `grad`, differentiable in every input."""
    proj = project_gaussians(means3d, scales, quats, opacities, cam, 1.0, False)
    with torch.no_grad():
        starts, counts, ids = bin_tiles(proj, cam.width, cam.height, tile)
    invd = 1.0 / torch.clamp(proj.depth, min=1e-8)
    feats = torch.cat([colors, invd[:, None]], dim=1)
    acc, pairs = blend_tiles(proj.mean2d, proj.conic, proj.alpha, feats, starts, counts, ids,
                             cam.width, cam.height, tile, chunk, grad)
    return acc[..., :CHANNELS], acc[..., CHANNELS], pairs, int(ids.shape[0])
