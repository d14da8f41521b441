"""Mesh z-buffer rasterizer, host side (counterpart of
`guava_renderer_tpu/ops/meshraster.py`): visibility and attribute renders.

Triangles are projected and binned to tiles in PyTorch ops, kernel K5
(kernels/meshraster.py) keeps the nearest hit per pixel, and face ids,
barycentrics and interpolated attributes are recovered with gathers.

Binning is uncapped, as the Gaussian binning of this package is: count
each valid face's tile rectangle, prefix-sum, emit (tile, face) instances
in face order, one stable sort by tile (one host sync, for the instance
count). Within a tile the faces stand in ascending id, which is the JAX
package's order, and so its tie rule, wherever no face covers more than
that package's cap of 32 tiles.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.cameras import Camera, project_points
from ..kernels.meshraster import TRI, mesh_zbuffer


class MeshRasterResult(NamedTuple):
    face_idx: torch.Tensor   # (H, W) i32, -1 = empty
    depth: torch.Tensor      # (H, W) f32 (inf where empty)
    bary: torch.Tensor       # (H, W, 3) f32 screen-space barycentrics


class MeshBins(NamedTuple):
    """A projected and binned mesh, ready for the z-buffer."""
    tris: torch.Tensor       # (F, 12) f32 triangle table (kernels/meshraster.py)
    inst_fid: torch.Tensor   # (N,) i32 face ids, tile-grouped, ascending in a tile
    ranges: torch.Tensor     # (gy*gx + 1,) i32 per-tile instance ranges
    tri: torch.Tensor        # (F, 3, 2) f32 projected pixel coordinates
    tiles_per_face: torch.Tensor   # (F,) i64 tile-rectangle area, 0 for a culled face


def bin_mesh(verts: torch.Tensor, faces: torch.Tensor, cam: Camera, tile: int = 16) -> MeshBins:
    """Project verts (V, 3) world and bin faces (F, 3) to tile x tile tiles."""
    pix, z = project_points(cam, verts)      # (V, 2), (V,)
    faces = faces.long()
    return bin_triangles(pix[faces], z[faces], cam.height, cam.width, tile)


def bin_triangles(tri: torch.Tensor, tri_z: torch.Tensor, height: int, width: int,
                  tile: int = 16) -> MeshBins:
    """Bin projected triangles, tri (F, 3, 2) pixel xy and tri_z (F, 3)
    camera depth, to the tile x tile tiles of a height x width image."""
    H, W = height, width
    if H % tile or W % tile:
        raise ValueError(f"image {H}x{W} must tile by {tile}")
    device = tri.device
    gx, gy = W // tile, H // tile
    n_tiles = gx * gy
    F = tri.shape[0]
    valid = (tri_z > 0.01).all(dim=-1)       # near-plane cull (conservative)

    def tile_index(v, hi, plus):
        # float -> int truncates toward zero; clamping the float first keeps
        # the cast in range and leaves the clipped result unchanged
        return torch.clamp(torch.clamp(v / tile, -1.0, hi + 1.0).to(torch.int32) + plus, 0, hi)

    x0 = tile_index(tri[..., 0].amin(1), gx, 0)
    y0 = tile_index(tri[..., 1].amin(1), gy, 0)
    x1 = tile_index(tri[..., 0].amax(1), gx, 1)
    y1 = tile_index(tri[..., 1].amax(1), gy, 1)
    rw = torch.clamp(x1 - x0, min=0).long()
    rh = torch.clamp(y1 - y0, min=0).long()
    counts = torch.where(valid, rw * rh, 0)
    ends = torch.cumsum(counts, 0)
    n = int(ends[-1]) if F else 0            # the one host sync of binning

    fid = torch.repeat_interleave(torch.arange(F, device=device), counts, output_size=n)
    local = torch.arange(n, device=device) - (ends - counts)[fid]
    w = rw[fid]
    tiles = (y0.long()[fid] + local // w) * gx + x0.long()[fid] + local % w
    _, perm = torch.sort(tiles, stable=True)
    inst_fid = fid[perm].to(torch.int32)
    ranges = torch.zeros(n_tiles + 1, dtype=torch.int64, device=device)
    ranges[1:] = torch.cumsum(torch.bincount(tiles, minlength=n_tiles), 0)

    tris = torch.zeros((F, 3, TRI // 3), dtype=torch.float32, device=device)
    tris[..., :2] = tri
    tris[..., 2] = tri_z
    return MeshBins(tris.reshape(F, TRI), inst_fid, ranges.to(torch.int32), tri, counts)


@torch.no_grad()
def rasterize_mesh(verts: torch.Tensor, faces: torch.Tensor, cam: Camera,
                   tile: int = 16) -> MeshRasterResult:
    """Single-mesh z-buffer rasterization. verts (V, 3) world, faces (F, 3).
    Visibility is queried without gradients, as the reference does."""
    H, W = cam.height, cam.width
    bins = bin_mesh(verts, faces, cam, tile)
    best, depth = mesh_zbuffer(bins.tris, bins.inst_fid, bins.ranges, H, W, tile)

    hit = best >= 0
    if bins.inst_fid.shape[0] == 0:
        face_idx = torch.full_like(best, -1)
    else:
        face_idx = torch.where(hit, bins.inst_fid[torch.clamp(best, min=0).long()], -1)

    # barycentrics recomputed for hit pixels
    tri_hit = bins.tri[torch.clamp(face_idx, min=0).long()]     # (H, W, 3, 2)
    xs = torch.arange(W, dtype=torch.float32, device=verts.device)[None, :]
    ys = torch.arange(H, dtype=torch.float32, device=verts.device)[:, None]
    a, b, c = tri_hit[..., 0, :], tri_hit[..., 1, :], tri_hit[..., 2, :]
    det = (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) \
        - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0])
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    w0 = ((b[..., 0] - xs) * (c[..., 1] - ys) - (b[..., 1] - ys) * (c[..., 0] - xs)) / det
    w1 = ((c[..., 0] - xs) * (a[..., 1] - ys) - (c[..., 1] - ys) * (a[..., 0] - xs)) / det
    bary = torch.stack([w0, w1, 1.0 - w0 - w1], dim=-1)
    bary = torch.where(hit[..., None], bary, 0.0)
    return MeshRasterResult(face_idx=face_idx, depth=depth, bary=bary)


def visible_faces_mask(face_idx: torch.Tensor, num_faces: int) -> torch.Tensor:
    """(F,) bool: the faces present in the id image."""
    flat = face_idx.reshape(-1).long()
    # empty pixels (-1) go to a spare slot that is cut off
    mask = torch.zeros(num_faces + 1, dtype=torch.bool, device=face_idx.device)
    mask[torch.where(flat >= 0, flat, num_faces)] = True
    return mask[:num_faces]


def interpolate_attributes(res: MeshRasterResult, faces: torch.Tensor,
                           vertex_attrs: torch.Tensor) -> torch.Tensor:
    """Per-pixel interpolation of vertex attributes (V, A) -> (H, W, A), 0
    where empty (the reference's position / LBS-weight mesh renders)."""
    tri = faces.long()[torch.clamp(res.face_idx, min=0).long()]      # (H, W, 3)
    attrs = vertex_attrs[tri]                                       # (H, W, 3, A)
    out = torch.einsum("hwka,hwk->hwa", attrs, res.bary)
    return torch.where((res.face_idx >= 0)[..., None], out, 0.0)
