"""Early-exit probe of the forward blend (counterpart of tools/ee_probe.py).

A tile's blend may stop once every pixel's transmittance has fallen below
1e-4. This tool runs K1p (`ops/gsplat.py:blend_probe`), K1 with a count of
the rounds each tile ran, on frame 0 of the bench scene (projected, binned
uncapped, packed):

  counts   rounds run of rounds total at chunk 32 for exit_every 1 and 4,
           with a checksum of the image;
  timing   an A/B over exit_every:chunk (--variants; 1:128 is K1's own
           walk, plus one atomic a CTA; chunks up to 256 are taken), CUDA
           events, median of --iters launches;
  stages   (--stages) project, bin, pack, the blend (K1) and the whole
           `rasterize`, CUDA events.

    python -m guava_renderer_tpu_torch.tools.ee_probe [--device cuda] [--stages]

The JAX tool's TPU-only options (--platform, --ladder, --priority-window)
have no counterpart: the port bins uncapped. Neither have its
--stages3..7, XLA dead-code and fusion experiments with no eager
counterpart.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..benchscene import frame0_gaussians, make_bench_scene
from ..device import resolve_device
from ..kernels.blend import blend
from ..ops.gsplat import (
    RasterizeSettings, RasterPrep, bin_gaussians, blend_probe, pack_rows, rasterize)
from ..ops.gsplat_project import project_gaussians
from . import device_ms, fmt_ms

COUNT_CHUNK = 32


def probe_frame(sc, tile: int) -> RasterPrep:
    """Frame 0 of the bench scene, projected, binned and packed."""
    gs = frame0_gaussians(sc)
    with torch.no_grad():
        proj = project_gaussians(gs.xyz[0], gs.scaling[0], gs.rotation[0], gs.opacity[0], sc.cam)
        ranges, order = bin_gaussians(proj, sc.size, sc.size, tile)
        return RasterPrep(pack_rows(proj, gs.colors[0]), order, ranges, proj.radius)


def _rounds_total(ranges, chunk):
    n = (ranges[1:] - ranges[:-1]).long()
    return int(((n + chunk - 1) // chunk).sum())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", default="1:32,0:32,4:32,8:32,1:64,4:64,1:128",
                    help="comma list of exit_every:chunk")
    ap.add_argument("--stages", action="store_true",
                    help="also time project, bin, pack, the blend and rasterize")
    ap.add_argument("--size", type=int, default=512, help="image side of the bench scene")
    ap.add_argument("--uv", type=int, default=512, help="UV chart side of the bench scene")
    ap.add_argument("--body-side", type=int, default=101)
    ap.add_argument("--head-side", type=int, default=15)
    ap.add_argument("--tile", type=int, default=32)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.perf_counter()
    sc = make_bench_scene(args.size, args.uv, args.body_side, args.head_side, device=dev)
    prep = probe_frame(sc, args.tile)
    size, tile = sc.size, args.tile
    bg = torch.zeros(32, device=dev)
    print(f"[ee] scene and frame 0 on {dev}: P={prep.rows.shape[0]} "
          f"instances={prep.order.shape[0]} truncated=0 ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    result = {"device": str(dev), "prep": prep, "size": size, "tile": tile, "counts": {},
              "variants": [], "stages": {}}

    total = _rounds_total(prep.ranges, COUNT_CHUNK)
    for ee in (1, 4):
        color, _, _, cnt = blend_probe(prep, bg, size, size, tile, COUNT_CHUNK, ee,
                                       channels_first=False)
        run = int(cnt.sum())
        result["counts"][ee] = (run, total)
        print(f"[ee] counts exit_every={ee} chunk={COUNT_CHUNK}: run={run} of {total} "
              f"({run / max(total, 1):.1%}) checksum={float(color.sum()):.1f}", flush=True)

    for spec in filter(None, args.variants.split(",")):
        ee, ch = (int(x) for x in spec.split(":"))
        out = blend_probe(prep, bg, size, size, tile, ch, ee, channels_first=False)
        ms = device_ms(lambda: blend_probe(prep, bg, size, size, tile, ch, ee), dev, args.iters)
        run, total = int(out[3].sum()), _rounds_total(prep.ranges, ch)
        result["variants"].append({"exit_every": ee, "chunk": ch, "ms": ms, "run": run,
                                   "total": total})
        print(f"[ee] blend exit_every={ee} chunk={ch}: {fmt_ms(ms)} (median of {args.iters}), "
              f"rounds run {run} of {total}, checksum={float(out[0].sum()):.1f}", flush=True)

    if args.stages:
        gs = frame0_gaussians(sc)
        xyz, scl, rot, opa, col = (gs.xyz[0], gs.scaling[0], gs.rotation[0], gs.opacity[0],
                                   gs.colors[0])
        with torch.no_grad():
            proj = project_gaussians(xyz, scl, rot, opa, sc.cam)
            stages = {
                "project": lambda: project_gaussians(xyz, scl, rot, opa, sc.cam),
                "bin": lambda: bin_gaussians(proj, size, size, tile),
                "pack": lambda: pack_rows(proj, col),
                "blend (K1)": lambda: blend(prep.rows, prep.order, prep.ranges, bg, size, size,
                                            tile),
                "rasterize": lambda: rasterize(xyz, col, opa, scl, rot, sc.cam, bg,
                                               RasterizeSettings(tile=tile)),
            }
            for name, fn in stages.items():
                fn()                       # runs on the CPU too, where nothing is timed
                ms = device_ms(fn, dev, args.iters)
                result["stages"][name] = ms
                note = "; with its one host sync" if name in ("bin", "rasterize") else ""
                print(f"[ee] stage {name}: {fmt_ms(ms)} (median of {args.iters}{note})",
                      flush=True)
    return result


if __name__ == "__main__":
    main()
