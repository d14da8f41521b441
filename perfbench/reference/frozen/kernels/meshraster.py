"""K5's plain version: the mesh z-buffer, nearest triangle hit per pixel
over binned tiles, in PyTorch ops on any device. (This frozen copy keeps
the plain walk only; the port's kernel is held to it bit for bit.)

`tris` is the (F, 12) f32 triangle table
[ax, ay, az, 0 | bx, by, bz, 0 | cx, cy, cz, 0] (pixel xy, camera depth);
`inst_fid` lists face ids grouped by tile (tiles row-major), ascending
within a tile; tile t owns inst_fid[ranges[t]:ranges[t+1]], and no tile
reads the instances before ranges[0] or from ranges[n_tiles] on.
"""

from __future__ import annotations

import torch

TRI = 12
EDGE_EPS = -1e-6
DET_EPS = 1e-12
SEGMENT = 64       # instances a CTA walks at most (csrc/meshraster.cu kSegment)
LAUNCHES = 2       # kernel launches of one call (the segments, then the merge)
# the kernel's exact cull (csrc/meshraster.cu): a pixel is rejected without
# dividing when s e0 or s e1 <= -TAU_SCALE |d|, or s e0 + s e1 >=
# fl(SUM_SCALE |d|); a warp skips a triangle when one rule holds over its
# whole box, by the affine range of e0 and e1 in float widened by ERR_REL of
# the product terms plus ERR_ABS; faces with |d| >= CULL_MAX_DET or a term of
# TERM_MAX or more are never culled (every constant is a float32)
TAU_SCALE = 2.0 ** -19
SUM_SCALE = 1.0 + 2.0 ** -16
CULL_MAX_DET = 1e30
ERR_REL = 2.0 ** -19
ERR_ABS = 2.0 ** -100
TERM_MAX = 2.0 ** 100
EMPTY_KEY = torch.iinfo(torch.int64).max   # the model's "no hit" key (the kernel's is all ones)
launches = 0   # kernel launches so far in this process


def mesh_zbuffer_plain(tris, inst_fid, ranges, height, width, tile):
    """Same contract as `mesh_zbuffer`, in PyTorch ops.

    All tiles advance together, one instance per step, in the kernel's
    ascending per-pixel order with the same strict `<`, each product and
    difference rounded on its own. Tiles are visited in descending instance
    count, which makes the tiles still running at step i a prefix."""
    device = tris.device
    gx, gy = width // tile, height // tile
    n_tiles = gx * gy
    pix = tile * tile
    counts = (ranges[1:] - ranges[:-1]).long()
    counts_desc, tiles = torch.sort(counts, descending=True, stable=True)
    active = counts_desc.cpu()
    starts = ranges[:-1].long()[tiles]
    lin = torch.arange(pix, device=device)
    px = ((tiles % gx)[:, None] * tile + lin % tile).float()
    py = ((tiles // gx)[:, None] * tile + lin // tile).float()

    best = torch.full((n_tiles, pix), -1, dtype=torch.int32, device=device)
    zbest = torch.full((n_tiles, pix), float("inf"), dtype=torch.float32, device=device)
    n_steps = int(active[0]) if n_tiles else 0
    k = n_tiles
    for i in range(n_steps):
        while active[k - 1] <= i:
            k -= 1
        inst = starts[:k] + i
        t = tris[inst_fid[inst].long()]                    # (k, 12)
        ax, ay, az = t[:, 0:1], t[:, 1:2], t[:, 2:3]
        bx, by, bz = t[:, 4:5], t[:, 5:6], t[:, 6:7]
        cx, cy, cz = t[:, 8:9], t[:, 9:10], t[:, 10:11]
        x, y = px[:k], py[:k]
        det = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        det_safe = torch.where(det.abs() < DET_EPS, DET_EPS, det)
        w0 = ((bx - x) * (cy - y) - (by - y) * (cx - x)) / det_safe
        w1 = ((cx - x) * (ay - y) - (cy - y) * (ax - x)) / det_safe
        w2 = 1.0 - w0 - w1
        z = w0 * az + w1 * bz + w2 * cz
        upd = (w0 >= EDGE_EPS) & (w1 >= EDGE_EPS) & (w2 >= EDGE_EPS) & (z > 0.0) \
            & (z < zbest[:k])
        best[:k] = torch.where(upd, inst[:, None].to(torch.int32), best[:k])
        zbest[:k] = torch.where(upd, z, zbest[:k])

    inv = torch.empty_like(tiles)
    inv[tiles] = torch.arange(n_tiles, device=device)

    def to_image(x):   # (n_tiles, pix) in sorted order -> (H, W)
        return x[inv].reshape(gy, gx, tile, tile).permute(0, 2, 1, 3).reshape(height, width)

    return to_image(best), to_image(zbest)


def mesh_zbuffer(tris, inst_fid, ranges, height, width, tile):
    """tris (F, 12) f32, inst_fid (N,) i32, ranges (gy*gx + 1,) i32
    nondecreasing within [0, N] -> best (H, W) i32 index into inst_fid of
    the nearest hit (-1 where empty), depth (H, W) f32 (+inf where empty)."""
    if height % tile or width % tile or tile * tile > 1024:
        raise ValueError(f"image {height}x{width} must tile by {tile} (tile^2 <= 1024)")
    return mesh_zbuffer_plain(tris, inst_fid, ranges, height, width, tile)
