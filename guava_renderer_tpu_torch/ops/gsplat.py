"""32-channel Gaussian tile rasterizer, host side (counterpart of the
default path of `guava_renderer_tpu/ops/gsplat.py`).

  stage 1  project (gsplat_project.py)
  stage 2  tile binning in PyTorch ops, uncapped as in the CUDA reference
           (rasterizer_impl.cu:280-320): count each contributing Gaussian's
           tile rect, exclusive prefix sum, emit (tile, depth) instance keys
           in Gaussian-id order, one stable sort of the int64 key
           `tile << 32 | float_bits(depth)`, tile ranges by bincount+cumsum.
           Depth ties resolve by Gaussian id, as the JAX presort path does.
  stage 3  the tile blend, kernel K1 (kernels/blend.py).

`rasterize` = `rasterize_prep` (stages 1-2) + `rasterize_blend` (stage 3).

`rasterize` is differentiable in means, colors, opacities, scales, quats and
bg: binning runs on detached values (which tiles a Gaussian reaches carries
no gradient, as in the JAX package), the blend rows stay in the graph, and
the blend's backward is kernel K3.

The JAX package caps each Gaussian's duplication (a static instance-sort
size is a TPU requirement); on every configuration where its cap truncates
nothing the two instance sets are equal, and where it would truncate, this
port renders the uncapped composite. Its TPU scheduling knobs (duplication
caps, size classes, tile cull, DMA banks, streaming, bf16 rows, ...) have
no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.cameras import Camera
from ..kernels.blend import ALPHA_MIN, CHANNELS, ROW, blend
from .gsplat_project import ProjectedGaussians, project_gaussians, tile_rect


class RasterizeSettings(NamedTuple):
    tile: int = 16               # pixels per tile side
    scale_modifier: float = 1.0
    antialiasing: bool = False


def bin_gaussians(proj: ProjectedGaussians, width: int, height: int, tile: int):
    """-> (ranges (gy*gx + 1,) i32, order (N,) i32): Gaussian ids grouped by
    tile (row-major), depth-ascending within a tile; N is the number of
    (Gaussian, tile) instances of the contributing Gaussians."""
    device = proj.mean2d.device
    gx = (width + tile - 1) // tile
    n_tiles = gx * ((height + tile - 1) // tile)
    contributing = proj.valid & (proj.alpha >= ALPHA_MIN)
    x0, y0, x1, y1 = tile_rect(proj.mean2d, proj.radius_bin, width, height, tile)
    rw = (x1 - x0).long()
    rh = (y1 - y0).long()
    counts = torch.where(contributing & (rw > 0) & (rh > 0), rw * rh, 0)
    ends = torch.cumsum(counts, 0)
    n = int(ends[-1]) if ends.numel() else 0   # the one host sync of binning

    gid = torch.repeat_interleave(torch.arange(counts.shape[0], device=device), counts,
                                  output_size=n)
    local = torch.arange(n, device=device) - (ends - counts)[gid]
    w = rw[gid]
    tiles = (y0.long()[gid] + local // w) * gx + x0.long()[gid] + local % w
    # valid depths are > 0.2, so their float bits order like the floats
    depth_bits = proj.depth.view(torch.int32).long()[gid]
    _, perm = torch.sort((tiles << 32) | depth_bits, stable=True)
    order = gid[perm].to(torch.int32)
    ranges = torch.zeros(n_tiles + 1, dtype=torch.int64, device=device)
    ranges[1:] = torch.cumsum(torch.bincount(tiles, minlength=n_tiles), 0)
    return ranges.to(torch.int32), order


def pack_rows(proj: ProjectedGaussians, colors: torch.Tensor) -> torch.Tensor:
    """(P, 44) blend rows: [x, y, conic a/b/c, alpha, 0, 0 | 32 colors, invdepth, 0 x3]."""
    P = colors.shape[0]
    invd = 1.0 / torch.clamp(proj.depth, min=1e-8)
    z2 = colors.new_zeros((P, 2))
    return torch.cat(
        [proj.mean2d, proj.conic, proj.alpha[:, None], z2, colors, invd[:, None],
         colors.new_zeros((P, ROW - 8 - CHANNELS - 1))],
        dim=-1,
    ).contiguous()


class RasterPrep(NamedTuple):
    """A projected and binned frame, ready for the blend."""
    rows: torch.Tensor     # (P, 44) f32 blend rows (pack_rows)
    order: torch.Tensor    # (N,) i32 Gaussian ids, tile-grouped, depth-sorted
    ranges: torch.Tensor   # (gy*gx + 1,) i32 per-tile instance ranges
    radius: torch.Tensor   # (P,) projected pixel radius


def rasterize_prep(means3d, colors, opacities, scales, quats, cam: Camera,
                   settings: RasterizeSettings = RasterizeSettings()) -> RasterPrep:
    """Projection + binning + blend rows (stages 1 and 2)."""
    proj = project_gaussians(means3d, scales, quats, opacities, cam,
                             settings.scale_modifier, settings.antialiasing)
    with torch.no_grad():
        ranges, order = bin_gaussians(ProjectedGaussians(*(t.detach() for t in proj)),
                                      cam.width, cam.height, settings.tile)
    return RasterPrep(pack_rows(proj, colors), order, ranges, proj.radius)


def rasterize_blend(prep: RasterPrep, bg: torch.Tensor, height: int, width: int,
                    settings: RasterizeSettings = RasterizeSettings(),
                    channels_first: bool = True):
    """Blend a prepped frame (stage 3, kernel K1; its backward is K3).
    -> (color, invdepth) in the layouts `rasterize` returns them."""
    color, invdepth, _ = blend(prep.rows, prep.order, prep.ranges, bg, height, width,
                               settings.tile)
    if channels_first:
        return color.permute(2, 0, 1), invdepth.permute(2, 0, 1)
    return color, invdepth


def rasterize(
    means3d: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    cam: Camera,
    bg: torch.Tensor,
    settings: RasterizeSettings = RasterizeSettings(),
    channels_first: bool = True,
):
    """means3d (P,3), colors (P,32), opacities (P,1), scales (P,3), quats
    (P,4) wxyz, camera, bg (32,) -> (color (32,H,W), radii (P,), invdepth
    (1,H,W)); with channels_first=False (color (H,W,32), radii, invdepth (H,W,1))."""
    prep = rasterize_prep(means3d, colors, opacities, scales, quats, cam, settings)
    color, invdepth = rasterize_blend(prep, bg, cam.height, cam.width, settings, channels_first)
    return color, prep.radius, invdepth
