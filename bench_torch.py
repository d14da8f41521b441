"""Benchmark of the PyTorch/CUDA port: the 512x512 self-reenactment
animation loop on one GPU (counterpart of `bench.py`, which measures the JAX
package on a TPU).

    python3 bench_torch.py                       # on the card, the defaults below
    python3 bench_torch.py --device cpu --size 64 --uv 32 --frames 2 --repeats 1 \
        --body-side 21 --skip-infer              # a small drive on the CPU

Each frame is the reference's render_set hot path (EHM deform, 32-channel
rasterization, refiner at 512^2, batch 1) through the port's
`FramePipeline.render_frames`, on the bench scene
(`benchscene.make_bench_scene`: full-scale synthetic rig, trained-avatar
splat statistics) with random refiner weights from seed 0. The raster
settings are the `MODEL.raster` block of configs/train/ubody_512.yaml, read
with the port's config reader, under the flags that have a port
counterpart; the refiner runs in bf16 unless `--no-bf16`, as `bench.py`'s
does. The JAX bench's TPU scheduling flags are accepted and echoed under
"ignored".

Output: exactly one JSON line on stdout, `bench.py`'s keys ("metric",
"value" = frames per second on the host clock, "unit", "vs_baseline"
against the same 60 fps) plus the host-clock ms/frame (best and median of
the repeats), the device-busy ms/frame, idle share and device kernels a
frame from a torch.profiler window over one pass of the loop (null on the
CPU, which has no device time), the creation latency ("infer_ms"), the
raster settings run and whether they match the training config, and the
card's name and power limit. Logs go to stderr. On any failure the script
exits non-zero and prints no metric line.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

BASELINE_FPS = 60.0
TRAIN_CONFIG = os.path.join(ROOT, "configs", "train", "ubody_512.yaml")
FEAT_SIZE = 518                # the creation path's source image
HEAD_SIDE = 15
N_CREATIONS = 2                # creations a repeat, as bench.py's run_infer_bench
# bench.py's flags that schedule the TPU kernels: accepted, echoed, unused
TPU_FLAGS = (("--chunk", int), ("--tpg", int), ("--large-k", int), ("--tpg-large", int),
             ("--banks", int), ("--priority-window", int), ("--phases", int))
TPU_SWITCHES = ("--presort", "--tile-cull", "--static-class-order", "--face-plan")


def log(msg):
    print(f"[bench_torch] {msg}", file=sys.stderr, flush=True)


def parse_args(argv):
    ap = argparse.ArgumentParser(description="The port's animation-loop benchmark.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--uv", type=int, default=512)
    ap.add_argument("--body-side", type=int, default=101)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--group", type=int, default=4,
                    help="frames a render_frames group (the port renders a group frame "
                         "by frame)")
    ap.add_argument("--tile", type=int, default=None, help="default: the training config's")
    ap.add_argument("--size-classes", default=None,
                    help="'count:cap,...' by descending rect area; default: the training "
                         "config's ladder; '' for none")
    ap.add_argument("--vmem-classes", type=int, default=None)
    ap.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                    help="bf16 refiner (the rasterizer stays float32)")
    ap.add_argument("--bf16-rows", action=argparse.BooleanOptionalAction, default=None)
    ap.add_argument("--streaming", action=argparse.BooleanOptionalAction, default=None)
    ap.add_argument("--skip-infer", action="store_true",
                    help="skip the avatar-creation latency")
    for flag, typ in TPU_FLAGS:
        ap.add_argument(flag, type=typ, default=None, help="TPU only: accepted and ignored")
    for flag in TPU_SWITCHES:
        ap.add_argument(flag, action=argparse.BooleanOptionalAction, default=None,
                        help="TPU only: accepted and ignored")
    args = ap.parse_args(argv)
    if args.frames < 1 or args.repeats < 1 or args.group < 1:
        ap.error("--frames, --repeats and --group must be >= 1")
    return args


def raster_from(args, train_raster):
    """(RasterizeSettings, the settings as JSON, the config's kept knobs as JSON)."""
    from guava_renderer_tpu_torch.cli.context import raster_settings
    from guava_renderer_tpu_torch.ops.gsplat import _check_settings

    base, _ = raster_settings(train_raster)
    over = {}
    if args.tile is not None:
        over["tile"] = args.tile
    if args.size_classes is not None:
        over["size_classes"] = tuple(tuple(int(v) for v in pair.split(":"))
                                     for pair in args.size_classes.split(",") if pair)
    if args.vmem_classes is not None:
        over["vmem_classes"] = args.vmem_classes
    if args.bf16_rows is not None:
        over["bf16_rows"] = args.bf16_rows
    if args.streaming is not None:
        over["streaming"] = args.streaming
    settings = base._replace(**over)
    _check_settings(settings)

    def as_json(s):
        return {"tile": s.tile, "size_classes": [list(p) for p in s.size_classes],
                "vmem_classes": s.vmem_classes, "bf16_rows": s.bf16_rows,
                "streaming": s.streaming}

    return settings, as_json(settings), as_json(base)


def card(dev):
    """{"kind": device name, "smi": nvidia-smi's "name, power.limit"}."""
    import torch

    if dev.type != "cuda":
        return {"kind": "cpu", "smi": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    return {"kind": torch.cuda.get_device_name(dev), "smi": smi[0]}


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def render_loop(args, settings, dev):
    """-> (host ms/frame of each repeat, device ms/frame, kernels a frame, P)."""
    import numpy as np
    import torch

    from guava_renderer_tpu_torch.avatar.renderer import NeuralRefiner
    from guava_renderer_tpu_torch.benchscene import INVTANFOV, make_bench_scene
    from guava_renderer_tpu_torch.cli.inference import FramePipeline
    from guava_renderer_tpu_torch.models.styleunet import init_params_
    from guava_renderer_tpu_torch.tools import profile_window

    t0 = time.perf_counter()
    sc = make_bench_scene(args.size, args.uv, args.body_side, HEAD_SIDE, device=dev)
    refiner = init_params_(NeuralRefiner(args.size), torch.Generator().manual_seed(0))
    pipe = FramePipeline(sc.ehm, sc.faces, refiner, image_size=args.size, invtanfov=INVTANFOV,
                         settings=settings, opacity_threshold=0.0,
                         refiner_dtype=torch.bfloat16 if args.bf16 else None, device=dev)
    avatar = pipe.prepare_avatar(sc.avatar)
    P = int(sc.avatar.vtx_positions.shape[1] + sc.avatar.uv_valid.sum())
    n_shape, n_exp = sc.smplx.n_shape, sc.smplx.n_exp
    targets = [{"params": {"shape": np.zeros(n_shape, np.float32),
                           "body_pose": np.full((21, 3), 0.01 * i, np.float32),
                           "flame_shape": np.zeros(n_shape, np.float32),
                           "flame_exp": np.zeros(n_exp, np.float32),
                           "flame_jaw": np.zeros(3, np.float32)},
                "w2c": sc.w2c} for i in range(args.frames)]
    log(f"scene {args.size}^2, P={P}, planned gather {pipe.plan is not None}, "
        f"set up in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    outs = pipe.render_frames(avatar, targets, args.group)       # warm-up: builds the kernels
    sync(dev)
    for out in outs:
        img = out["render"]
        if img.shape != (args.size, args.size, 3) or not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"bad render {tuple(img.shape)}")
    log(f"warm-up pass in {time.perf_counter() - t0:.1f} s")

    host = []
    for rep in range(args.repeats):
        t0 = time.perf_counter()
        pipe.render_frames(avatar, targets, args.group)
        sync(dev)
        host.append((time.perf_counter() - t0) * 1e3 / args.frames)
        log(f"repeat {rep + 1}/{args.repeats}: {host[-1]:.3f} ms/frame")
    device_ms = kernels = None
    if dev.type == "cuda":
        busy, count, top = profile_window(lambda: pipe.render_frames(avatar, targets, args.group),
                                          1)
        if busy <= 0:
            raise RuntimeError("torch.profiler recorded no device time")
        device_ms, kernels = busy / args.frames, count / args.frames
        log(f"profiler: {device_ms:.3f} ms/frame device busy, {kernels:.1f} kernels a frame; "
            f"top: {top}")
    return host, device_ms, kernels, P


def infer_latency(args, dev):
    """Best ms a creation (`FramePipeline.infer_avatar` without the prune)."""
    import torch

    from guava_renderer_tpu_torch.avatar.inferer import InfererConfig, UbodyGaussianInferer
    from guava_renderer_tpu_torch.avatar.renderer import NeuralRefiner
    from guava_renderer_tpu_torch.benchscene import INVTANFOV, make_create_scene
    from guava_renderer_tpu_torch.cli.inference import FramePipeline
    from guava_renderer_tpu_torch.models.styleunet import init_params_

    csc = make_create_scene(args.size, args.uv, args.body_side, HEAD_SIDE, feat_size=FEAT_SIZE,
                            device=dev)
    gen = torch.Generator().manual_seed(0)
    inferer = init_params_(UbodyGaussianInferer(
        InfererConfig(image_size=args.size, uvmap_size=args.uv), csc.smplx.num_vertices), gen)
    pipe = FramePipeline(csc.ehm, csc.faces, NeuralRefiner(args.size), inferer=inferer,
                         uv_tables=csc.uv_tables, image_size=args.size, invtanfov=INVTANFOV,
                         device=dev)
    pipe.infer_avatar(csc.source, prune=False)                  # warm-up
    sync(dev)
    best = float("inf")
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        for _ in range(N_CREATIONS):
            avatar, _ = pipe.infer_avatar(csc.source, prune=False)
        sync(dev)
        best = min(best, (time.perf_counter() - t0) * 1e3 / N_CREATIONS)
    if not bool(torch.isfinite(avatar.uv_colors).all()):
        raise RuntimeError("creation gave non-finite colors")
    log(f"creation: {best:.3f} ms best of {args.repeats} x {N_CREATIONS}")
    return best


def main(argv=None) -> dict:
    args = parse_args(argv)

    from guava_renderer_tpu_torch.device import resolve_device
    from guava_renderer_tpu_torch.utils.config import load_config

    dev = resolve_device(args.device)
    train_raster = load_config(TRAIN_CONFIG).MODEL.raster.to_dict()
    settings, run_raster, train_kept = raster_from(args, train_raster)
    ignored = {flag: getattr(args, flag[2:].replace("-", "_"))
               for flag in [f for f, _ in TPU_FLAGS] + list(TPU_SWITCHES)
               if getattr(args, flag[2:].replace("-", "_")) is not None}
    if ignored:
        log(f"TPU-only flags ignored: {ignored}")
    device = card(dev)
    log(f"device {device}; raster {run_raster}; bf16 refiner {args.bf16}")

    host, device_ms, kernels, P = render_loop(args, settings, dev)
    best, median = min(host), statistics.median(host)
    fps = 1e3 / best
    rec = {
        "metric": f"self-reenactment render FPS @{args.size}px, P={P} gaussians, "
                  f"tile={settings.tile}"
                  + (f" ladder[{len(settings.size_classes)} classes]" if settings.size_classes
                     else "")
                  + (", bf16 refiner" if args.bf16 else "") + f", {device['kind']} (PyTorch port)",
        "value": fps,
        "unit": "fps",
        "vs_baseline": fps / BASELINE_FPS,
        "ms_per_frame_host": {"best": best, "median": median, "repeats": host},
        "ms_per_frame_device": device_ms,
        "idle_share": None if device_ms is None else 1.0 - device_ms / median,
        "kernels_per_frame": kernels,
        "frames": args.frames,
        "group": args.group,
        "bf16_refiner": args.bf16,
        "raster_settings": run_raster,
        "matches_train_config": run_raster == train_kept,
        "train_config_raster": train_raster,
        "ignored": ignored,
        "device": device,
    }
    if not args.skip_infer:
        rec["infer_ms"] = infer_latency(args, dev)
    if not fps > 0:
        raise RuntimeError(f"no frame rate measured ({fps})")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
