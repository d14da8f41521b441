"""One frame's rows over the ranks (counterpart of
`guava_renderer_tpu/parallel/sharded_render.py`).

The frame is cut into n bands of H/n rows. Each rank projects all the
Gaussians (cheap, replicated), shifts their 2D means into its band's pixel
frame, bins with the band's height and blends its band's tiles, kernel K1
(or K6 under `bf16_rows`, which the JAX function drops); the bands are then
gathered along H. `render_band` is the band alone, with no collective, so a
process can render the bands of every rank one after another;
`rasterize_row_sharded` is a rank's band plus the gather.

The port bins uncapped, so each band blends exactly the instances that
reach it and the bands equal the port's own full-frame render up to the
rounding of the shifted means; they equal the JAX bands wherever its caps
truncate nothing. Forward only, as the JAX function is.
"""

from __future__ import annotations

import torch

from ..core.cameras import Camera
from ..ops.gsplat import (
    RasterizeSettings, RasterPrep, _check_settings, bin_gaussians, pack_rows, rasterize_blend)
from ..ops.gsplat_project import project_gaussians
from .mesh import Group, all_gather_cat


@torch.no_grad()
def band_prep(d: int, n: int, means3d, colors, opacities, scales, quats, cam: Camera,
              settings: RasterizeSettings = RasterizeSettings()) -> RasterPrep:
    """Band d of n of one frame, projected and binned for the blend: the
    rows carry 2D means in the band's pixel frame and the ranges cover its
    H/n rows of tiles. H must split into bands of whole tiles."""
    _check_settings(settings)
    H, W, tile = cam.height, cam.width, settings.tile
    if H % (n * tile):
        raise AssertionError("H must split into tile-aligned bands")
    Hl = H // n
    proj = project_gaussians(means3d, scales, quats, opacities, cam, settings.scale_modifier,
                             settings.antialiasing)
    shift = torch.tensor([0.0, float(d * Hl)], dtype=proj.mean2d.dtype,
                         device=proj.mean2d.device)
    band = proj._replace(mean2d=proj.mean2d - shift)
    ranges, order = bin_gaussians(band, W, Hl, tile)
    return RasterPrep(pack_rows(band, colors), order, ranges, proj.radius)


@torch.no_grad()
def render_band(d: int, n: int, means3d, colors, opacities, scales, quats, cam: Camera,
                bg: torch.Tensor, settings: RasterizeSettings = RasterizeSettings()):
    """Band d of n of one frame -> (color (32, H/n, W), radii (P,), invdepth
    (1, H/n, W)). The blend is K1, or K6 with `settings.bf16_rows`;
    `size_classes`, `vmem_classes` and `streaming` are not read here, as the
    JAX function reads none of them."""
    prep = band_prep(d, n, means3d, colors, opacities, scales, quats, cam, settings)
    color, invdepth = rasterize_blend(prep, bg, cam.height // n, cam.width, settings._replace(
        size_classes=(), vmem_classes=0, streaming=False))
    return color, prep.radius, invdepth


def rasterize_row_sharded(means3d, colors, opacities, scales, quats, cam: Camera,
                          bg: torch.Tensor, group: Group,
                          settings: RasterizeSettings = RasterizeSettings()):
    """One frame over the ranks of `group` -> (color (32, H, W), radii (P,),
    invdepth (1, H, W)) on every rank: rank r renders band r of n and the
    bands are gathered along H. Radii are every rank's own (replicated)."""
    color, radii, invdepth = render_band(group.rank, group.size, means3d, colors, opacities,
                                         scales, quats, cam, bg, settings)
    return all_gather_cat(color, group, dim=1), radii, all_gather_cat(invdepth, group, dim=1)
