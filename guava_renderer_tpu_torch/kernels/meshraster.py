"""K5: the mesh z-buffer, nearest triangle hit per pixel over binned tiles.

`mesh_zbuffer` launches `csrc/meshraster.cu` for CUDA tensors (two launches:
the segments, then the merge) and runs `mesh_zbuffer_plain` for CPU
tensors; nothing else. `mesh_zbuffer_split_plain` models the kernel's
segments, its cull and its key merge in PyTorch, for the tests.

`tris` is the (F, 12) f32 triangle table
[ax, ay, az, 0 | bx, by, bz, 0 | cx, cy, cz, 0] (pixel xy, camera depth);
`inst_fid` lists face ids grouped by tile (tiles row-major), ascending
within a tile; tile t owns inst_fid[ranges[t]:ranges[t+1]], and no tile
reads the instances before ranges[0] or from ranges[n_tiles] on.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

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


def cta_layout(tile):
    """The kernel's CTA at this tile -> (lx, ly, has_pixel) of each thread
    (int64, int64, bool; the thread count rounded up to whole warps), and each
    warp's box as (centre x, centre y) in the tile (float32, (warps,)) and its
    half sizes (hx, hy). With tile % 8 == 0 a warp holds an 8 x 4 block;
    otherwise pixels are row-major and every box is the whole tile."""
    threads = -(-tile * tile // 32) * 32
    tid = torch.arange(threads)
    warp, lane = tid // 32, tid % 32
    if tile % 8 == 0:
        per_row = tile // 8
        bx, by = warp % per_row, warp // per_row
        lx, ly = 8 * bx + lane % 8, 4 * by + lane // 8
        has = torch.ones(threads, dtype=torch.bool)
        cx, cy = (8 * bx[::32] + 3.5).float(), (4 * by[::32] + 1.5).float()
        hx, hy = 3.5, 1.5
    else:
        lx, ly, has = tid % tile, tid // tile, tid < tile * tile
        cx = cy = torch.full((threads // 32,), 0.5 * (tile - 1), dtype=torch.float32)
        hx = hy = 0.5 * (tile - 1)
    return lx, ly, has, cx, cy, hx, hy


def cull_constants(t):
    """Triangles t (n, 12) f32 -> (d, s, tau, sum_min), each (n, 1) f32:
    det_safe, its sign (+-1), and the thresholds of the cull's rules
    (NaN, so that no rule holds, for a face with |d| >= CULL_MAX_DET)."""
    ax, ay, bx, by, cx, cy = (t[:, k:k + 1] for k in (0, 1, 4, 5, 8, 9))
    det = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    d = torch.where(det.abs() < DET_EPS, DET_EPS, det)
    ad = d.abs()
    cullable = ad < CULL_MAX_DET
    s = torch.where(d > 0.0, 1.0, -1.0)
    tau = torch.where(cullable, ad * TAU_SCALE, float("nan"))
    sum_min = torch.where(cullable, ad * SUM_SCALE, float("nan"))
    return d, s, tau, sum_min


def edge_functions(t, px, py):
    """(e0, e1) f32 of triangles t (n, 12) at pixel centres (px, py), each
    product and difference rounded on its own, as `mesh_zbuffer_plain`."""
    ax, ay, bx, by, cx, cy = (t[:, k:k + 1] for k in (0, 1, 4, 5, 8, 9))
    e0 = (bx - px) * (cy - py) - (by - py) * (cx - px)
    e1 = (cx - px) * (ay - py) - (cy - py) * (ax - px)
    return e0, e1


def pair_rejects(e0, e1, s, tau, sum_min):
    """The kernel's per-pixel rules R1-R3 (f32): True where the plain
    predicate provably rejects the pixel, so it need not divide."""
    g0, g1 = e0 * s, e1 * s
    return (g0 <= -tau) | (g1 <= -tau) | (g0 + g1 >= sum_min)


def box_rejects(t, s, tau, sum_min, xc, yc, hx, hy):
    """The kernel's warp test (f32): True where one of R1-R3 holds at every
    pixel of the box centred (xc, yc) (f32 tensors broadcasting against t's
    rows) with half sizes (hx, hy)."""
    ax, ay, bx, by, cx, cy = (t[:, k:k + 1] for k in (0, 1, 4, 5, 8, 9))
    r0 = (by - cy).abs() * hx + (cx - bx).abs() * hy
    r1 = (cy - ay).abs() * hx + (ax - cx).abs() * hy
    r01 = (by - ay).abs() * hx + (ax - bx).abs() * hy
    dxa, dya, dxb, dyb, dxc, dyc = ax - xc, ay - yc, bx - xc, by - yc, cx - xc, cy - yc
    e0 = dxb * dyc - dyb * dxc
    e1 = dxc * dya - dyc * dxa
    xa, ya = dxa.abs() + hx, dya.abs() + hy
    xb, yb = dxb.abs() + hx, dyb.abs() + hy
    xcc, ycc = dxc.abs() + hx, dyc.abs() + hy
    m0 = xb * ycc + yb * xcc
    m1 = xcc * ya + ycc * xa
    err0 = ERR_REL * m0 + ERR_ABS
    err1 = ERR_REL * m1 + ERR_ABS
    hi0 = s * e0 + r0 + err0
    hi1 = s * e1 + r1 + err1
    lo01 = s * (e0 + e1) - r01 - err0 - err1
    return (m0 < TERM_MAX) & (m1 < TERM_MAX) \
        & ((hi0 <= -tau) | (hi1 <= -tau) | (lo01 >= sum_min))


def mesh_zbuffer_split_plain(tris, inst_fid, ranges, height, width, tile, segment=SEGMENT,
                             stats=None):
    """`mesh_zbuffer_plain`'s images, computed as K5 computes them: each
    tile's run cut at the multiples of `segment` in the instance list, every
    segment's pixels keyed (bits(z) << 32) | instance over the pairs the cull
    keeps (`box_rejects` a warp, then `pair_rejects` a pixel, in the
    kernel's order of operations), each segment's least key a pixel, then the
    least over a tile's segments, decoded. A dict passed as `stats` receives
    the cull's counts: (instance, warp) pairs, those the warps walk,
    (instance, pixel) pairs walked and those that divide."""
    device = tris.device
    gx, gy = width // tile, height // tile
    n_tiles = gx * gy
    lx, ly, has, wcx, wcy, hx, hy = (v.to(device) if torch.is_tensor(v) else v
                                     for v in cta_layout(tile))
    threads, warps = lx.shape[0], wcx.shape[0]
    ranges = ranges.long()
    inst = torch.arange(int(ranges[0]), int(ranges[-1]), device=device)   # the runs' instances
    n = inst.shape[0]
    tile_of = torch.searchsorted(ranges[1:], inst, right=True)          # ranges[t] <= i < ranges[t+1]
    starts = (inst == ranges[:-1][tile_of]) | (inst % segment == 0)
    piece = torch.cumsum(starts.long(), 0) - 1
    n_pieces = int(piece[-1]) + 1 if n else 0
    piece_tile = tile_of[starts]
    piece_keys = torch.full((n_pieces, threads), EMPTY_KEY, dtype=torch.int64, device=device)
    counts = {"warp_pairs": n * warps, "warp_pairs_walked": 0, "pairs_walked": 0,
              "pairs_divided": 0}
    warp_of = torch.arange(threads, device=device) // 32
    chunk = max(1, (1 << 22) // threads)
    for c0 in range(0, n, chunk):
        i, i_tile = inst[c0:c0 + chunk], tile_of[c0:c0 + chunk]
        t = tris[inst_fid[i].long()]
        d, s, tau, sum_min = cull_constants(t)
        tx0, ty0 = (i_tile % gx)[:, None] * tile, (i_tile // gx)[:, None] * tile
        walk = ~box_rejects(t, s, tau, sum_min, tx0 + wcx, ty0 + wcy, hx, hy)
        walk_px = walk[:, warp_of]                                      # (chunk, threads)
        e0, e1 = edge_functions(t, (tx0 + lx).float(), (ty0 + ly).float())
        keep = walk_px & ~pair_rejects(e0, e1, s, tau, sum_min)
        w0 = e0 / d
        w1 = e1 / d
        w2 = 1.0 - w0 - w1
        z = w0 * t[:, 2:3] + w1 * t[:, 6:7] + w2 * t[:, 10:11]
        hit = keep & has & (w0 >= EDGE_EPS) & (w1 >= EDGE_EPS) & (w2 >= EDGE_EPS) & (z > 0.0)
        key = (z.contiguous().view(torch.int32).long() << 32) | i[:, None]
        key = torch.where(hit, key, EMPTY_KEY)
        piece_keys.scatter_reduce_(0, piece[c0:c0 + chunk][:, None].expand_as(key), key, "amin")
        counts["warp_pairs_walked"] += int(walk.sum())
        counts["pairs_walked"] += int(walk_px.sum())
        counts["pairs_divided"] += int((keep & has).sum())
    if stats is not None:
        stats.update(counts)
    tile_keys = torch.full((n_tiles, threads), EMPTY_KEY, dtype=torch.int64, device=device)
    tile_keys.scatter_reduce_(0, piece_tile[:, None].expand_as(piece_keys), piece_keys, "amin")
    empty = tile_keys == EMPTY_KEY
    best_t = torch.where(empty, -1, tile_keys & 0xffffffff).to(torch.int32)
    depth_t = torch.where(empty, float("inf"),
                          (tile_keys >> 32).to(torch.int32).view(torch.float32))
    best = torch.full((height, width), -1, dtype=torch.int32, device=device)
    depth = torch.full((height, width), float("inf"), dtype=torch.float32, device=device)
    tiles = torch.arange(n_tiles, device=device)[:, None]
    rows = ((tiles // gx) * tile + ly)[:, has]
    cols = ((tiles % gx) * tile + lx)[:, has]
    best[rows, cols] = best_t[:, has]
    depth[rows, cols] = depth_t[:, has]
    return best, depth


def occupancy(tile):
    """{"ctas_per_sm": n, "smem_bytes": b}: CTAs of the built K5 segment
    kernel resident on one SM at once at this tile
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and its shared memory."""
    n, smem = ctypes.c_int(0), ctypes.c_int(0)
    build.check(build.library().guava_mesh_zbuffer_occupancy(
        tile, ctypes.addressof(n), ctypes.addressof(smem)), "guava_mesh_zbuffer_occupancy")
    return {"ctas_per_sm": n.value, "smem_bytes": smem.value}


def mesh_zbuffer(tris, inst_fid, ranges, height, width, tile):
    """tris (F, 12) f32, inst_fid (N,) i32, ranges (gy*gx + 1,) i32
    nondecreasing within [0, N] -> best (H, W) i32 index into inst_fid of
    the nearest hit (-1 where empty), depth (H, W) f32 (+inf where empty).
    Tile t reads inst_fid[ranges[t]:ranges[t+1]] alone. On the card each CTA
    walks at most SEGMENT instances."""
    global launches
    if height % tile or width % tile or tile * tile > 1024:
        raise ValueError(f"image {height}x{width} must tile by {tile} (tile^2 <= 1024)")
    n_tiles = (height // tile) * (width // tile)
    if tris.dim() != 2 or tris.shape[1] != TRI or tris.dtype != torch.float32:
        raise ValueError(f"tris must be (F, {TRI}) float32, got {tuple(tris.shape)} {tris.dtype}")
    if inst_fid.dim() != 1 or inst_fid.dtype != torch.int32:
        raise ValueError(f"inst_fid must be (N,) int32, got {tuple(inst_fid.shape)} "
                         f"{inst_fid.dtype}")
    if ranges.shape != (n_tiles + 1,) or ranges.dtype != torch.int32:
        raise ValueError(f"ranges must be ({n_tiles + 1},) int32, got "
                         f"{tuple(ranges.shape)} {ranges.dtype}")
    devices = {t.device for t in (tris, inst_fid, ranges)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    device = tris.device
    if device.type == "cpu":
        return mesh_zbuffer_plain(tris, inst_fid, ranges, height, width, tile)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not all(t.is_contiguous() for t in (tris, inst_fid, ranges)):
        raise ValueError("mesh_zbuffer inputs must be contiguous")
    if tris.data_ptr() % 16:
        raise ValueError("the z-buffer reads triangles in 16-byte pieces: tris must start on a "
                         "16-byte boundary")
    n = inst_fid.shape[0]
    best = torch.empty((height, width), dtype=torch.int32, device=device)
    depth = torch.empty((height, width), dtype=torch.float32, device=device)
    # the segments' keys where a tile has several: its first segment's, and
    # the one starting at each multiple of SEGMENT after the first
    first = torch.empty((n_tiles, tile * tile), dtype=torch.int64, device=device)
    cont = torch.empty((max(-(-n // SEGMENT) - 1, 1), tile * tile), dtype=torch.int64,
                       device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().guava_mesh_zbuffer(
            tris.data_ptr(), inst_fid.data_ptr(), ranges.data_ptr(), best.data_ptr(),
            depth.data_ptr(), first.data_ptr(), cont.data_ptr(), n, height, width, tile, stream)
    build.check(err, "guava_mesh_zbuffer")
    if n_tiles:
        launches += LAUNCHES
    return best, depth
