"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (one line each, then a JSON line of the kernels, then a last line
{"ok": true, "device": {...}}); any failure exits non-zero before that line:
  1. the device, and `nvidia-smi`'s name and power limit;
  2. build the CUDA kernels from `guava_renderer_tpu_torch/csrc`;
  3. each kernel against its plain PyTorch version at the shapes of the
     full-scale bench scene's frame 0, with times (CUDA events, medians);
  4. the main path at full width: FramePipeline with StyleUNet-small 512
     renders 20 frames through render_frame and through render_frames,
     with launch counts, fps and a per-stage split;
  5. the same pipeline on a small scene, on the GPU against the CPU.
Needs a CUDA device; run from the repository root.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "guava_renderer_tpu_torch").is_dir():
    sys.exit("chip_smoke.py must run from a checkout of the repository")
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device; none is available")

from guava_renderer_tpu_torch.avatar.deformer import (  # noqa: E402
    _face_table, deform_avatar, deform_with_vertices, sort_avatar_by_plan)
from guava_renderer_tpu_torch.avatar.renderer import NeuralRefiner  # noqa: E402
from guava_renderer_tpu_torch.benchscene import INVTANFOV, make_bench_scene  # noqa: E402
from guava_renderer_tpu_torch.bodymodel.ehm import ehm_forward  # noqa: E402
from guava_renderer_tpu_torch.cli.inference import (  # noqa: E402
    FramePipeline, _batched_params, _unpack_params)
from guava_renderer_tpu_torch.kernels import blend as k1  # noqa: E402
from guava_renderer_tpu_torch.kernels import build  # noqa: E402
from guava_renderer_tpu_torch.kernels import facegather as k2  # noqa: E402
from guava_renderer_tpu_torch.models.styleunet import init_params_  # noqa: E402
from guava_renderer_tpu_torch.ops.facegather import build_face_sort_plan, compact_faces  # noqa: E402
from guava_renderer_tpu_torch.ops.gsplat import RasterizeSettings, bin_gaussians, pack_rows  # noqa: E402
from guava_renderer_tpu_torch.ops.gsplat_project import project_gaussians  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12             # H100 SXM, FP32 outside the tensor cores
# K1 operation counts per (instance, pixel) pair, from csrc/blend.cu: a
# visited pair evaluates the offset, the conic quadratic, an exp and the two
# tests (~16 FP32 ops); a contributing pair adds the alpha clamp, the
# transmittance update and 33 FMAs into the accumulators (~71 more)
K1_OPS_VISITED = 16
K1_OPS_CONTRIB = 71
SIZE, UV, BODY_SIDE, HEAD_SIDE = 512, 512, 101, 15
TILE = 32
N_FRAMES = 20
K1_TOL = 1e-4


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    """Median device time of fn() over reps runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_pairs(rows, order, ranges, tile):
    """(visited, contributing) (instance, pixel) pairs of the blend on these
    inputs: a pixel visits its tile's instances in order until its
    transmittance would fall below 1e-4 (that instance included)."""
    gx = SIZE // tile
    pix = tile * tile
    counts = (ranges[1:] - ranges[:-1]).long()
    counts_desc, tiles = torch.sort(counts, descending=True, stable=True)
    active = counts_desc.cpu()
    starts = ranges[:-1].long()[tiles]
    lin = torch.arange(pix, device=DEV)
    px = ((tiles % gx)[:, None] * tile + lin % tile).float()
    py = ((tiles // gx)[:, None] * tile + lin // tile).float()
    T = torch.ones((len(tiles), pix), device=DEV)
    done = torch.zeros_like(T, dtype=torch.bool)
    visited = torch.zeros((), dtype=torch.int64, device=DEV)
    contrib_n = torch.zeros((), dtype=torch.int64, device=DEV)
    k = len(tiles)
    for i in range(int(active[0])):
        while active[k - 1] <= i:
            k -= 1
        r = rows[order[starts[:k] + i].long()]
        d0 = r[:, 0:1] - px[:k]
        d1 = r[:, 1:2] - py[:k]
        power = -0.5 * (r[:, 2:3] * d0 * d0 + r[:, 4:5] * d1 * d1) - r[:, 3:4] * d0 * d1
        ag = r[:, 5:6] * torch.exp(power)
        live = ~done[:k]
        contrib = (power <= 0.0) & (ag >= k1.ALPHA_MIN) & live
        visited += live.sum()
        contrib_n += contrib.sum()
        test_t = T[:k] * (1.0 - torch.clamp(ag, max=k1.ALPHA_MAX))
        dies = contrib & (test_t < k1.T_MIN)
        T[:k] = torch.where(contrib & ~dies, test_t, T[:k])
        done[:k] |= dies
    return int(visited), int(contrib_n)


def main():
    t_start = time.perf_counter()
    # ---- 1. device ----
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    say(1, f"device {name}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
           f"cuda {torch.version.cuda}")
    print(smi, flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    build.library()
    spent = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    say(2, f"kernels built and loaded in {spent:.2f} s "
           f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'})")
    for ln in ptxas:
        say(2, f"  ptxas: {ln}")

    # ---- 3. kernels vs plain at the main path's shapes ----
    sc = make_bench_scene(SIZE, UV, BODY_SIDE, HEAD_SIDE, device=DEV)
    plan = build_face_sort_plan(sc.avatar.uv_binding_face.cpu().numpy(),
                                sc.avatar.uv_valid.cpu().numpy())
    avatar = sort_avatar_by_plan(sc.avatar, plan)
    dplan = plan.to(DEV)
    cfaces = torch.as_tensor(compact_faces(plan, sc.smplx.faces), dtype=torch.int64, device=DEV)
    with torch.no_grad():
        res = ehm_forward(sc.ehm, sc.base_body, sc.base_flame)
        tri = res.vertices[0, cfaces.reshape(-1)].reshape(-1, 3, 3)
        table = _face_table(tri).contiguous()
        ids = dplan.compact_ids
        got2 = k2.face_gather(table, ids)
        want2 = k2.face_gather_plain(table, ids)
        torch.cuda.synchronize()
        err2 = float((got2 - want2).abs().max())
        if not torch.equal(got2, want2):
            raise SystemExit(f"K2 disagrees with its plain version: max abs {err2}")
        k2_ms = cuda_ms(lambda: k2.face_gather(table, ids))
        k2_plain_ms = cuda_ms(lambda: k2.face_gather_plain(table, ids))
        k2_lib_ms = cuda_ms(lambda: table[ids].T.contiguous())
        n_tex, n_faces = ids.shape[0], table.shape[0]
        k2_bytes = 16 * n_tex * 4 + n_tex * 4 + n_faces * 16 * 4
        k2_bound = k2_bytes / HBM_BYTES_PER_S * 1e3
        say(3, f"K2 face gather: N={n_tex} Fc={n_faces}, equal to plain (max abs {err2}); "
               f"kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms, table[ids].T {k2_lib_ms:.4f} ms, "
               f"bound {k2_bound:.4f} ms ({k2_bytes / 1e6:.2f} MB)")

        gs = deform_avatar(avatar, sc.ehm, sc.faces, sc.base_body, sc.base_flame,
                           plan=dplan, compact_faces=cfaces)
        proj = project_gaussians(gs.xyz[0], gs.scaling[0], gs.rotation[0], gs.opacity[0], sc.cam)
        ranges, order = bin_gaussians(proj, SIZE, SIZE, TILE)
        rows = pack_rows(proj, gs.colors[0])
        bg = torch.zeros(32, device=DEV)
        got1 = k1.blend(rows, order, ranges, bg, SIZE, SIZE, TILE)
        want1 = k1.blend_plain(rows, order, ranges, bg, SIZE, SIZE, TILE)
        err1 = max(float((g - w).abs().max()) for g, w in zip(got1, want1))
        counts = ranges[1:] - ranges[:-1]
        if not err1 <= K1_TOL:
            raise SystemExit(f"K1 disagrees with its plain version: max abs {err1} > {K1_TOL}")
        k1_ms = cuda_ms(lambda: k1.blend(rows, order, ranges, bg, SIZE, SIZE, TILE))
        plain_reps = 3   # the plain blend steps through the busiest tile's run: seconds a call
        k1_plain_ms = cuda_ms(lambda: k1.blend_plain(rows, order, ranges, bg, SIZE, SIZE, TILE),
                              reps=plain_reps, warmup=0)
        visited, contrib = k1_pairs(rows, order, ranges, TILE)
        P, N = rows.shape[0], order.shape[0]
        k1_bytes = P * k1.ROW * 4 + N * 4 + ranges.numel() * 4 + 32 * 4 + SIZE * SIZE * 34 * 4
        k1_ops = visited * K1_OPS_VISITED + contrib * K1_OPS_CONTRIB
        k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / FP32_FLOPS) * 1e3
        k1_bound_by = "operations" if k1_ops / FP32_FLOPS > k1_bytes / HBM_BYTES_PER_S else "bytes"
        say(3, f"K1 tile blend: P={P} instances={N} busiest tile={int(counts.max())} "
               f"visited pairs={visited} contributing pairs={contrib}; max abs vs plain {err1:.3g} "
               f"(tol {K1_TOL}); kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.2f} ms "
               f"(median of {plain_reps}), bound {k1_bound:.4f} ms by {k1_bound_by} "
               f"({k1_ops / 1e9:.2f} GFLOP, {k1_bytes / 1e6:.1f} MB)")
    del got1, want1, got2, want2

    # ---- 4. the main path at full width ----
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(4, f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
           f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    refiner = init_params_(NeuralRefiner(SIZE, style_dim=512, num_mlp=8, channel_scale=1.0),
                           torch.Generator().manual_seed(0))
    pipe = FramePipeline(sc.ehm, sc.faces, refiner, image_size=SIZE, invtanfov=INVTANFOV,
                         settings=RasterizeSettings(tile=TILE), opacity_threshold=0.0,
                         device=DEV)
    main_avatar = pipe.prepare_avatar(sc.avatar)
    if pipe.plan is None:
        raise SystemExit("the main path did not take the planned face gather")
    n_shape, n_exp = sc.smplx.n_shape, sc.smplx.n_exp
    targets = [{"params": {"shape": np.zeros(n_shape, np.float32),
                           "body_pose": np.full((21, 3), 0.01 * i, np.float32),
                           "flame_shape": np.zeros(n_shape, np.float32),
                           "flame_exp": np.zeros(n_exp, np.float32),
                           "flame_jaw": np.zeros(3, np.float32)},
                "w2c": sc.w2c} for i in range(N_FRAMES)]
    pipe.render_frame(main_avatar, targets[0])       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    seq = [pipe.render_frame(main_avatar, t) for t in targets]
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3 / N_FRAMES
    after_seq = (k1.launches, k2.launches)
    t0 = time.perf_counter()
    grouped = pipe.render_frames(main_avatar, targets, group=4)
    torch.cuda.synchronize()
    grp_ms = (time.perf_counter() - t0) * 1e3 / N_FRAMES
    launches = {"K1": k1.launches, "K2": k2.launches}
    if after_seq != (N_FRAMES, N_FRAMES) or launches != {"K1": 2 * N_FRAMES, "K2": 2 * N_FRAMES}:
        raise SystemExit(f"launch counts {after_seq} then {launches}: expected one of each a frame")
    diff = max(float((s[k] - g[k]).abs().max()) for s, g in zip(seq, grouped)
               for k in ("render", "raw", "invdepth"))
    if diff > 1e-5:
        raise SystemExit(f"render_frames disagrees with render_frame: max abs {diff}")
    for out in seq:
        for k in ("render", "raw"):
            v = out[k]
            if v.shape != (SIZE, SIZE, 3) or not bool(torch.isfinite(v).all()) \
                    or float(v.min()) < 0.0 or float(v.max()) > 1.0:
                raise SystemExit(f"{k}: bad image {tuple(v.shape)}")
        if not bool(torch.isfinite(out["invdepth"]).all()):
            raise SystemExit("invdepth not finite")
    covered = float((seq[0]["raw"].sum(-1) > 1e-3).float().mean())
    if covered < 0.01:
        raise SystemExit(f"frame 0 is background ({covered:.4f} of pixels covered)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(4, f"{N_FRAMES} frames {SIZE}^2: render_frame {seq_ms:.2f} ms/frame "
           f"({1e3 / seq_ms:.2f} fps), render_frames(group=4) {grp_ms:.2f} ms/frame "
           f"({1e3 / grp_ms:.2f} fps); launches {launches}; render_frames vs render_frame "
           f"max abs {diff}; frame 0 covers {covered:.3f} of pixels; peak mem {peak_gb:.2f} GB")

    # per-stage split of the same frame (CUDA events between stages)
    stages = ("ehm", "deform", "project", "bin", "blend", "refine")
    acc = dict.fromkeys(stages, 0.0)
    n_split = 5
    with torch.no_grad():
        for t in targets[:n_split]:
            body, flame = _unpack_params(_batched_params(t["params"], DEV))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
            ev[0].record()
            res = ehm_forward(sc.ehm, body, flame)
            ev[1].record()
            gs = deform_with_vertices(main_avatar, res.vertices, res.vertex_transforms,
                                      pipe.faces, plan=pipe.plan, compact_faces=pipe.cfaces)
            ev[2].record()
            proj = project_gaussians(gs.xyz[0], gs.scaling[0], gs.rotation[0], gs.opacity[0],
                                     sc.cam)
            ev[3].record()
            ranges, order = bin_gaussians(proj, SIZE, SIZE, TILE)
            ev[4].record()
            color, _, _ = k1.blend(pack_rows(proj, gs.colors[0]), order, ranges, bg, SIZE, SIZE,
                                   TILE)
            ev[5].record()
            pipe.renderer.neural_refiner(color[None])
            ev[6].record()
            ev[6].synchronize()
            for i, s in enumerate(stages):
                acc[s] += ev[i].elapsed_time(ev[i + 1]) / n_split
    # device busy share of the main path (torch.profiler over n_split frames)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for t in targets[:n_split]:
            pipe.render_frame(main_avatar, t)
        torch.cuda.synchronize()
    kernels_seen = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels_seen) / 1e3 / n_split
    launches_per_frame = sum(e.count for e in kernels_seen) / n_split
    top = sorted(kernels_seen, key=lambda e: -e.self_device_time_total)[:6]
    if busy_ms > 0:
        say(4, f"profiler: device busy {busy_ms:.3f} ms/frame = {busy_ms / seq_ms:.3f} of the "
               f"unprofiled {seq_ms:.2f} ms/frame (idle share {1 - busy_ms / seq_ms:.3f}); "
               f"{launches_per_frame:.0f} device kernels a frame; top: "
               + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / n_split:.3f} ms "
                           f"x{e.count // n_split}" for e in top))
    else:
        say(4, "profiler recorded no device time: busy share not measured")
    say(4, "stage split (ms, mean of 5 frames): "
           + ", ".join(f"{s} {acc[s]:.3f}" for s in stages)
           + f"; sum {sum(acc.values()):.2f}")

    # ---- 5. small scene: the GPU path against the CPU path ----
    small = {}
    for key, dev in (("cpu", torch.device("cpu")), ("gpu", DEV)):
        ssc = make_bench_scene(64, 64, 21, 7, device=dev)
        sref = init_params_(NeuralRefiner(64, style_dim=64, num_mlp=2, channel_scale=4.0),
                            torch.Generator().manual_seed(1))
        spipe = FramePipeline(ssc.ehm, ssc.faces, sref, image_size=64, invtanfov=INVTANFOV,
                              settings=RasterizeSettings(tile=16), device=dev)
        sav = spipe.prepare_avatar(ssc.avatar)
        small[key] = {k: v.cpu() for k, v in spipe.render_frame(sav, targets[3]).items()}
    small_err = max(float((small["cpu"][k] - small["gpu"][k]).abs().max()) for k in small["cpu"])
    if not small_err <= 1e-4:
        raise SystemExit(f"64^2 frame: GPU vs CPU max abs {small_err} > 1e-4")
    say(5, f"64^2 frame on the GPU vs the CPU (plain kernels): max abs {small_err:.3g} (tol 1e-4)")

    kernels = [
        {"name": "K1 tile blend", "route": "cuda",
         "source": "guava_renderer_tpu_torch/csrc/blend.cu",
         "replaces": "guava_renderer_tpu/ops/gsplat.py:1018", "launches": launches["K1"],
         "max_abs_err": err1, "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_bound_by, "library_ms": None},
        {"name": "K2 face gather", "route": "cuda",
         "source": "guava_renderer_tpu_torch/csrc/facegather.cu",
         "replaces": "guava_renderer_tpu/ops/facegather.py:125", "launches": launches["K2"],
         "max_abs_err": err2, "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": k2_lib_ms},
    ]
    if not all(math.isfinite(k[f]) for k in kernels for f in ("ms", "plain_ms", "bound_ms")):
        raise SystemExit(f"non-finite timing in {kernels}")
    say("done", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
