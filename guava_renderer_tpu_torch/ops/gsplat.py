"""32-channel Gaussian tile rasterizer, host side (counterpart of
`guava_renderer_tpu/ops/gsplat.py`).

  stage 1  project (gsplat_project.py)
  stage 2  tile binning in PyTorch ops, uncapped as in the CUDA reference
           (rasterizer_impl.cu:280-320): count each contributing Gaussian's
           tile rect, exclusive prefix sum, emit (tile, depth) instance keys
           in Gaussian-id order, one stable sort of the int64 key
           `tile << 32 | float_bits(depth)`, tile ranges by bincount+cumsum.
           Depth ties resolve by Gaussian id, as the JAX presort path does.
  stage 3  the tile blend: kernel K1 (kernels/blend.py), or one of its
           variants, as the settings choose:
             bf16_rows                    K6 on rows packed to bf16;
             size_classes + vmem_classes  K7, the largest Gaussians' rows
                                          from a resident table that K9
                                          (kernels/gather_rows.py) gathers;
             streaming                    K8 on a per-instance stream.

`rasterize` = `rasterize_prep` (stages 1-2) + `rasterize_blend` (stage 3)
on the default and bf16 paths; the resident and streaming paths are
`rasterize` alone, as in the JAX package. `blend_probe` is stage 3 by K1p,
the blend that also counts the rounds each tile ran (the early-exit probe,
`tools/ee_probe.py`).

`rasterize` is differentiable in means, colors, opacities, scales, quats and
bg: binning runs on detached values (which tiles a Gaussian reaches carries
no gradient, as in the JAX package), the blend rows stay in the graph, and
the backward of every blend is kernel K3.

The JAX package caps each Gaussian's duplication (a static instance-sort
size is a TPU requirement), by `max_tiles_per_gaussian` and by the caps of
`size_classes`; on every configuration where the caps truncate nothing the
two instance sets are equal, and where they would truncate, this port
renders the uncapped composite. So `size_classes` decides here only which
Gaussians are resident (the first `vmem_classes` classes of the area
ranking), and without `vmem_classes` it renders exactly what the default
path renders. The JAX package's other TPU scheduling knobs (chunk, caps,
tile cull, presort, DMA banks, instance budget, exit cadence, ...) have no
counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.cameras import Camera
from ..kernels import blend as kblend
from ..kernels.blend import (
    ALPHA_MIN, CHANNELS, GEOM, ROW, blend, blend_bf16, blend_resident, blend_stream)
from ..kernels.gather_rows import decode_ids, gather_resident
from .gsplat_project import ProjectedGaussians, project_gaussians, tile_rect

# The largest resident table the JAX package accepts (8 MB of its 512-byte
# rows); the port accepts the same settings.
MAX_RESIDENT_ROWS = 16384


class RasterizeSettings(NamedTuple):
    tile: int = 16               # pixels per tile side
    scale_modifier: float = 1.0
    antialiasing: bool = False
    # forward blend on rows packed to bf16 (K6): geometry as bf16 hi + lo
    # pairs, colors and invdepth as bf16; the backward replays on the
    # unpacked rows, and the gradient passes straight through the packing
    bf16_rows: bool = False
    # ((count, cap), ...): classes of the Gaussians ranked by descending
    # tile-rect area. The port bins uncapped, so the caps truncate nothing;
    # the classes only pick the Gaussians that vmem_classes keeps resident
    size_classes: tuple = ()
    # the first vmem_classes classes blend from a resident table (K7, built
    # by K9); needs size_classes
    vmem_classes: int = 0
    # forward blend from a per-instance stream of rows in the sorted order
    # (K8): geometry exact, colors and invdepth rounded to bf16
    streaming: bool = False


def _check_settings(settings: RasterizeSettings) -> None:
    """Raise the JAX package's ValueErrors for the settings it refuses."""
    if (settings.vmem_classes or settings.streaming) and settings.bf16_rows:
        raise ValueError(
            "bf16_rows covers the default (row-gather) blend path only; "
            "vmem_classes/streaming keep their f32 tables")
    if settings.vmem_classes and not settings.size_classes:
        raise ValueError("vmem_classes requires size_classes")


def resident_count(settings: RasterizeSettings, P: int) -> int:
    """L: how many of P Gaussians the first `vmem_classes` size classes hold."""
    start = 0
    for count, _cap in settings.size_classes[:settings.vmem_classes]:
        count = min(int(count), P - start)
        if count <= 0:
            break
        start += count
    return start


def _tile_counts(proj: ProjectedGaussians, width: int, height: int, tile: int):
    """(x0, y0, rw, rh, counts): each Gaussian's tile rect and the instances
    it bins (0 for one that does not contribute)."""
    contributing = proj.valid & (proj.alpha >= ALPHA_MIN)
    x0, y0, x1, y1 = tile_rect(proj.mean2d, proj.radius_bin, width, height, tile)
    rw = (x1 - x0).long()
    rh = (y1 - y0).long()
    counts = torch.where(contributing & (rw > 0) & (rh > 0), rw * rh, 0)
    return x0, y0, rw, rh, counts


def bin_gaussians(proj: ProjectedGaussians, width: int, height: int, tile: int):
    """-> (ranges (gy*gx + 1,) i32, order (N,) i32): Gaussian ids grouped by
    tile (row-major), depth-ascending within a tile; N is the number of
    (Gaussian, tile) instances of the contributing Gaussians."""
    device = proj.mean2d.device
    gx = (width + tile - 1) // tile
    n_tiles = gx * ((height + tile - 1) // tile)
    x0, y0, rw, rh, counts = _tile_counts(proj, width, height, tile)
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


def resident_keys(proj: ProjectedGaussians, width: int, height: int, tile: int,
                  n_resident: int) -> tuple[torch.Tensor, int]:
    """The ranking of the n_resident Gaussians with the largest tile rects:
    ((L,) int64 keys, id_bits), the first L of all P keys (area + 1) <<
    id_bits | id in descending order, a Gaussian that bins nothing counting
    as area -1, so ties go to the larger id (the JAX package's size-class
    ranking, `_bin_nopresort`). K9 (`gather_resident`) decodes the ids."""
    counts = _tile_counts(proj, width, height, tile)[-1]
    P = counts.shape[0]
    id_bits = max(1, (P - 1).bit_length())
    ids = torch.arange(P, device=counts.device)
    key = (torch.where(counts > 0, counts + 1, 0) << id_bits) | ids
    return torch.topk(key, n_resident).values, id_bits


def resident_ids(proj: ProjectedGaussians, width: int, height: int, tile: int,
                 n_resident: int) -> torch.Tensor:
    """(L,) i32 ids of the n_resident Gaussians with the largest tile rects,
    in the order of `resident_keys`."""
    return decode_ids(*resident_keys(proj, width, height, tile, n_resident))


def remap_resident(order: torch.Tensor, lids: torch.Tensor, P: int) -> torch.Tensor:
    """`order` with each instance of a resident Gaussian, lids[r], given the
    id P + r, which K7 reads from the resident table's row r."""
    rank = torch.full((P,), -1, dtype=torch.int32, device=order.device)
    rank[lids.long()] = torch.arange(lids.shape[0], dtype=torch.int32, device=order.device)
    r = rank[order.long()]
    return torch.where(r >= 0, P + r, order)


def round_colors_bf16(rows: torch.Tensor) -> torch.Tensor:
    """Rows with the 32 colors and the inverse depth rounded to bf16 (to
    nearest even) and stored back as f32: the values the JAX package's
    stream carries (`_pack_colors_bf16`, `_unpack_colors_bf16`)."""
    cols = slice(GEOM, GEOM + CHANNELS + 1)
    out = rows.clone()
    out[:, cols] = rows[:, cols].to(torch.bfloat16).float()
    return out


def stream_rows(rows: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """(N, 44) per-instance stream for K8: stream[i] is Gaussian order[i]'s
    row with geometry exact and colors rounded to bf16. The JAX package
    carries this payload through its instance sort; a gather after the
    sort gives the same rows. Detached: the stream carries no gradient."""
    return round_colors_bf16(rows.detach()).index_select(0, order.long())


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


def _project_and_bin(means3d, colors, opacities, scales, quats, cam: Camera,
                     settings: RasterizeSettings):
    """-> (detached projection, RasterPrep)."""
    proj = project_gaussians(means3d, scales, quats, opacities, cam,
                             settings.scale_modifier, settings.antialiasing)
    proj_sg = ProjectedGaussians(*(t.detach() for t in proj))
    with torch.no_grad():
        ranges, order = bin_gaussians(proj_sg, cam.width, cam.height, settings.tile)
    return proj_sg, RasterPrep(pack_rows(proj, colors), order, ranges, proj.radius)


def rasterize_prep(means3d, colors, opacities, scales, quats, cam: Camera,
                   settings: RasterizeSettings = RasterizeSettings()) -> RasterPrep:
    """Projection + binning + blend rows (stages 1 and 2) of the default and
    bf16 paths."""
    if settings.vmem_classes or settings.streaming:
        raise ValueError(
            "rasterize_prep covers the default blend path only "
            "(vmem_classes/streaming keep their fused form in rasterize)")
    return _project_and_bin(means3d, colors, opacities, scales, quats, cam, settings)[1]


def _layout(color, invdepth, channels_first):
    if channels_first:
        return color.permute(2, 0, 1), invdepth.permute(2, 0, 1)
    return color, invdepth


def rasterize_blend(prep: RasterPrep, bg: torch.Tensor, height: int, width: int,
                    settings: RasterizeSettings = RasterizeSettings(),
                    channels_first: bool = True):
    """Blend a prepped frame (stage 3: K1, or K6 with bf16_rows; the
    backward is K3). -> (color, invdepth) in the layouts `rasterize` returns
    them."""
    fn = blend_bf16 if settings.bf16_rows else blend
    color, invdepth, _ = fn(prep.rows, prep.order, prep.ranges, bg, height, width,
                            settings.tile)
    return _layout(color, invdepth, channels_first)


def blend_probe(prep: RasterPrep, bg: torch.Tensor, height: int, width: int, tile: int,
                chunk: int, exit_every: int, channels_first: bool = True):
    """Instrumented forward blend of a prepped frame (counterpart of the JAX
    package's `blend_probe`): K1p stages `chunk` instances a round and tests
    whether every pixel of the tile is done every `exit_every` rounds (0:
    never). -> (color, invdepth) as `rasterize_blend` returns them, final T
    (H, W) and chunks_run (gy, gx) int32, the rounds each tile ran. The image
    is K1's at every (chunk, exit_every). Not differentiable."""
    color, invdepth, final_t, counts = kblend.blend_probe(
        prep.rows, prep.order, prep.ranges, bg, height, width, tile, chunk, exit_every)
    return (*_layout(color, invdepth, channels_first), final_t, counts)


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
    _check_settings(settings)
    H, W, tile = cam.height, cam.width, settings.tile
    if not settings.vmem_classes and not settings.streaming:
        prep = rasterize_prep(means3d, colors, opacities, scales, quats, cam, settings)
        color, invdepth = rasterize_blend(prep, bg, H, W, settings, channels_first)
        return color, prep.radius, invdepth

    P = means3d.shape[0]
    L = resident_count(settings, P)
    if L > MAX_RESIDENT_ROWS:
        raise ValueError(f"vmem_classes table {L} rows exceeds the limit of "
                         f"{MAX_RESIDENT_ROWS} rows: fewer/smaller classes")
    proj_sg, prep = _project_and_bin(means3d, colors, opacities, scales, quats, cam, settings)
    # the resident table, the remapped ids and the stream carry no gradient
    if settings.vmem_classes:
        ltable, lids = gather_resident(prep.rows, *resident_keys(proj_sg, W, H, tile, L))
        color, invdepth, _ = blend_resident(prep.rows, ltable, remap_resident(prep.order, lids, P),
                                            prep.order, prep.ranges, bg, H, W, tile)
    else:
        color, invdepth, _ = blend_stream(prep.rows, stream_rows(prep.rows, prep.order),
                                          prep.order, prep.ranges, bg, H, W, tile)
    color, invdepth = _layout(color, invdepth, channels_first)
    return color, prep.radius, invdepth
