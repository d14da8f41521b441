"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (one line each, then a JSON line of the kernels, then a last line
{"ok": true, "device": {...}}); any failure exits non-zero before that line:
  1. the device, and `nvidia-smi`'s name and power limit;
  2. build the CUDA kernels from `guava_renderer_tpu_torch/csrc`;
  3. each of the five kernels against its plain PyTorch version at the
     shapes of the full-scale bench scene's frame 0, with times (CUDA
     events, medians);
  4. the frame path at full width: FramePipeline with StyleUNet-small 512
     renders 20 frames through render_frame and through render_frames,
     with launch counts, fps and a per-stage split;
  5. the same pipeline on a small scene, on the GPU against the CPU;
  6. the creation path at full width: FramePipeline.infer_avatar with the
     full InfererConfig (ViT-B/14, 518^2 source, 512^2 chart) creates an
     avatar 5 times, with launch counts, ms/creation, a per-stage split
     and one frame rendered from the created avatar;
  7. create then render at 64^2 and narrow widths, on the GPU against the
     CPU;
  8. the training step at full width: 3 warm-up and 5 timed steps of batch 1
     through `run_training` (creation, deform, 32-channel rasterization
     forward and backward, refiner, LPIPS loss, Adam over the inferer and
     the refiner), a checkpoint restored, one accumulated step of batch 2,
     a per-stage split and a profiler window over one step;
  9. a 32^2 training step of batch 2, on the GPU against the CPU;
 10. the gradient of the planned deform path (face gather forward and
     backward kernels) against the row-gather path's at the bench avatar.
Needs a CUDA device; run from the repository root.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
from guava_renderer_tpu_torch.avatar.inferer import (  # noqa: E402
    InfererConfig, UbodyGaussianInferer, assemble_avatar, build_avatar, texel_visibility)
from guava_renderer_tpu_torch.avatar.renderer import NeuralRefiner  # noqa: E402
from guava_renderer_tpu_torch.benchscene import (  # noqa: E402
    INVTANFOV, make_bench_scene, make_create_scene, make_train_scene)
from guava_renderer_tpu_torch.bodymodel.ehm import ehm_forward  # noqa: E402
from guava_renderer_tpu_torch.cli.inference import (  # noqa: E402
    FramePipeline, _batched_params, _unpack_params)
from guava_renderer_tpu_torch.cli.trainer_loop import run_training  # noqa: E402
from guava_renderer_tpu_torch.core.cameras import Camera  # noqa: E402
from guava_renderer_tpu_torch.kernels import blend as k1  # noqa: E402
from guava_renderer_tpu_torch.kernels import build  # noqa: E402
from guava_renderer_tpu_torch.kernels import facegather as k2  # noqa: E402
from guava_renderer_tpu_torch.kernels import meshraster as k5  # noqa: E402
from guava_renderer_tpu_torch.models.layers import harmonic_embedding  # noqa: E402
from guava_renderer_tpu_torch.models.styleunet import init_params_  # noqa: E402
from guava_renderer_tpu_torch.ops.facegather import build_face_sort_plan, compact_faces  # noqa: E402
from guava_renderer_tpu_torch.ops.gsplat import (  # noqa: E402
    RasterizeSettings, bin_gaussians, pack_rows, rasterize)
from guava_renderer_tpu_torch.ops.gsplat_project import project_gaussians, tile_rect  # noqa: E402
from guava_renderer_tpu_torch.ops.meshraster import bin_mesh, rasterize_mesh  # noqa: E402
from guava_renderer_tpu_torch.testing import make_micro_pipeline  # noqa: E402
from guava_renderer_tpu_torch.train.checkpoints import CheckpointManager  # noqa: E402
from guava_renderer_tpu_torch.train.losses import LossConfig, OptimizationLoss  # noqa: E402
from guava_renderer_tpu_torch.train.lpips import LPIPS, init_lpips_  # noqa: E402
from guava_renderer_tpu_torch.train.pipeline import (  # noqa: E402
    PipelineStatics, make_loss_fn, make_models)
from guava_renderer_tpu_torch.train.trainstep import (  # noqa: E402
    make_sample_scan_step, make_train_state, make_train_step, scrub_nan_grads)

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12             # H100 SXM, FP32 outside the tensor cores
# K1 operation counts per (instance, pixel) pair, from csrc/blend.cu: a
# visited pair evaluates the offset, the conic quadratic, an exp and the two
# tests (~16 FP32 ops); a contributing pair adds the alpha clamp, the
# transmittance update and 33 FMAs into the accumulators (~71 more)
K1_OPS_VISITED = 16
K1_OPS_CONTRIB = 71
# K3 operation counts per pair, from csrc/blend_bwd.cu: a visited pair costs
# what the forward's does; a contributing pair adds the 33-term dot product
# (66), w, the prefix and d alpha (12), the geometry chain (30), the 33
# colour gradients (33) and one addition per value into the per-Gaussian
# sums (39)
K3_OPS_VISITED = 16
K3_OPS_CONTRIB = 180
# K5 operation counts, from csrc/meshraster.cu: an (instance, pixel) pair
# evaluates two edge functions with a division each (2 x 8), the third
# weight (2), the depth (5) and five comparisons; the determinant (7 + 2)
# depends on the triangle alone and is counted once an instance
K5_OPS_PAIR = 28
K5_OPS_INSTANCE = 9
SIZE, UV, BODY_SIDE, HEAD_SIDE = 512, 512, 101, 15
FEAT = 518
TILE = 32
MESH_TILE = 16
N_FRAMES = 20
N_CREATIONS = 5
K1_TOL = 1e-4
# K3 against its plain version, per row column, as a share of the column's
# largest gradient: both sum float32 contributions with atomic adds, whose
# order changes from run to run, and a pixel within an ulp of a 1/255 or 1e-4
# threshold may be decided differently by expf and torch.exp
K3_TOL = 1e-3
# K4 against its plain version on the card (index_add_, atomic adds in any
# order): |difference| <= K4_TOL * sum |drows| over the face's segment
K4_TOL = 1e-6
N_WARMUP_STEPS = 3
N_TIMED_STEPS = 5
TRAIN_LR = 1e-4                # configs/train/ubody_512.yaml
# kernels N(0, (gain / sqrt(fan_in))^2): at gain 1 the full-depth model starts
# with UV offsets of 1e4 and its second step overflows float32 (init_params_)
TRAIN_INIT_GAIN = 0.5
MICRO_LOSS_RTOL = 1e-4
# 32^2 step, GPU against CPU, per parameter: rtol and atol as a share of the
# gradient's largest entry (cuDNN's and the CPU's convolutions sum in other
# orders, and the blend backward adds atomically)
MICRO_GRAD_RTOL, MICRO_GRAD_ATOL = 2e-3, 1e-4
PLANNED_GRAD_TOL = 1e-4        # planned against row-gather vertex gradient, share of its max
K5_DEPTH_TOL = 1e-6
SMALL_CREATE_TOL = 1e-3        # GPU vs CPU through ~40 float32 layers and the blend
# a frame of an avatar created with random weights is rendered only if it
# bins at most this many (Gaussian, tile) instances
INSTANCE_BUDGET = 64_000_000
CREATE_LIMIT_MS = 1000.0       # the reference's "sub-second" creation


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


def frame_instances(gs, cam, tile):
    """(Gaussian, tile) instances a frame of this Gaussian set would bin."""
    proj = project_gaussians(gs.xyz[0], gs.scaling[0], gs.rotation[0], gs.opacity[0], cam)
    x0, y0, x1, y1 = tile_rect(proj.mean2d, proj.radius_bin, cam.width, cam.height, tile)
    rw, rh = (x1 - x0).long(), (y1 - y0).long()
    contributing = proj.valid & (proj.alpha >= k1.ALPHA_MIN) & (rw > 0) & (rh > 0)
    return int(torch.where(contributing, rw * rh, 0).sum())


def creation_split(pipe, source, n):
    """Mean stage times (ms, CUDA events) of n creations, stage by stage as
    `build_avatar` and `prepare_avatar` run them."""
    stages = ("ehm", "zbuffer", "encoder", "vertex", "uv", "prune+plan")
    acc = dict.fromkeys(stages, 0.0)
    f_idx, f_bary, mask = pipe.uv_tables
    inferer = pipe.inferer
    with torch.no_grad():
        for _ in range(n):
            body, flame = _unpack_params(_batched_params(source["params"], pipe.device))
            image = torch.as_tensor(source["image"], dtype=torch.float32,
                                    device=pipe.device)[None]
            w2c = torch.as_tensor(source["w2c"], dtype=torch.float32, device=pipe.device)[None]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
            ev[0].record()
            res = ehm_forward(pipe.ehm, body, flame)
            ev[1].record()
            texel_mask, _ = texel_visibility(res.vertices, pipe.faces, w2c, f_idx, mask,
                                             pipe.image_size, pipe.invtanfov)
            ev[2].record()
            feats = inferer.encode(image)
            ev[3].record()
            cam_dirs = harmonic_embedding(w2c[:, :3, 2], 4)
            vertex_gs = inferer.vertex_branch(feats, w2c, res.vertices, cam_dirs)
            ev[4].record()
            uv_gs, _ = inferer.uv_branch(image, feats, w2c, res.vertices, texel_mask, f_idx,
                                         f_bary, pipe.faces, cam_dirs)
            ev[5].record()
            pipe.prepare_avatar(assemble_avatar(vertex_gs, uv_gs, pipe.ehm.smplx["v_template"],
                                                f_idx, f_bary, mask))
            ev[6].record()
            ev[6].synchronize()
            for i, st in enumerate(stages):
                acc[st] += ev[i].elapsed_time(ev[i + 1]) / n
    return acc


def check_avatar(avatar, where):
    for field, v in avatar._asdict().items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise SystemExit(f"{where}: avatar field {field} is not finite")


def train_setup(scene, cfg, lr):
    """Random-weight models, LPIPS, statics, train state and loss function
    for a training scene at the widths of `cfg` (seed 0)."""
    gen = torch.Generator().manual_seed(0)
    inferer, renderer = make_models(cfg, scene.smplx.num_vertices,
                                    refiner_channel_scale=cfg.channel_scale,
                                    raster_settings=RasterizeSettings(tile=TILE))
    init_params_(inferer, gen, gain=TRAIN_INIT_GAIN)
    init_params_(renderer, gen, gain=TRAIN_INIT_GAIN)
    lpips = init_lpips_(LPIPS("alex"), gen).to(DEV)
    f_idx, f_bary, mask = scene.uv_tables
    statics = PipelineStatics(
        ehm=scene.ehm, faces=scene.faces, uvmap_f_idx=f_idx, uvmap_f_bary=f_bary,
        uvmap_mask=mask, inferer=inferer.to(DEV), renderer=renderer.to(DEV),
        loss_cfg=LossConfig(), image_size=cfg.image_size, invtanfov=cfg.invtanfov)
    model = torch.nn.ModuleDict({"inferer": statics.inferer, "renderer": statics.renderer})
    state = make_train_state(model, learning_rate=lr)
    return statics, lpips, state, make_loss_fn(statics, lpips)


def train_split(statics, lpips, state, batch, n):
    """Mean stage times (ms, CUDA events) of n batch-1 training steps taken
    stage by stage as `forward_pipeline`, `make_loss_fn` and
    `make_train_step` run them, and the instances the step's frame binned."""
    stages = ("creation", "deform+raster", "refiner", "loss", "backward", "optimizer")
    acc = dict.fromkeys(stages, 0.0)
    opt_loss = OptimizationLoss(statics.loss_cfg, lpips)
    src, tgt = batch["source"], batch["target"]
    instances = 0
    for _ in range(n):
        state.optimizer.zero_grad(set_to_none=True)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        ev[0].record()
        body_s, flame_s = _unpack_params(src["params"])
        avatar, _ = build_avatar(
            statics.inferer, statics.ehm, statics.faces, statics.uvmap_f_idx,
            statics.uvmap_f_bary, statics.uvmap_mask, src["image"], src["w2c"], body_s, flame_s,
            image_size=statics.image_size, invtanfov=statics.invtanfov)
        ev[1].record()
        body_t, flame_t = _unpack_params(tgt["params"])
        gs = deform_avatar(avatar, statics.ehm, statics.faces, body_t, flame_t)
        cam = Camera.from_w2c(tgt["w2c"][0], 1.0 / statics.invtanfov, statics.image_size,
                              statics.image_size)
        renderer = statics.renderer
        bg = torch.zeros(32, device=DEV)
        feat, _, _ = rasterize(gs.xyz[0], gs.colors[0], gs.opacity[0], gs.scaling[0],
                               gs.rotation[0], cam, bg, renderer.settings, channels_first=False)
        feat = feat[None]
        ev[2].record()
        renders = renderer.neural_refiner(feat)
        ev[3].record()
        total, _ = opt_loss(renders, feat[..., :3], tgt["image"], tgt["mask"], tgt["boxes"],
                            avatar.uv_local_xyz, avatar.uv_scales, state.iteration)
        ev[4].record()
        total.backward()
        ev[5].record()
        scrub_nan_grads(state.model)
        state.optimizer.step()
        state.scheduler.step()
        state.iteration += 1
        ev[6].record()
        ev[6].synchronize()
        for i, st in enumerate(stages):
            acc[st] += ev[i].elapsed_time(ev[i + 1]) / n
        with torch.no_grad():
            instances = frame_instances(gs, cam, TILE)
    return acc, instances


def profile_window(fn, n):
    """torch.profiler over n calls of fn -> (device busy ms a call, device
    kernels a call, the ten longest device operations as text)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in seen) / 1e3 / n
    top = sorted(seen, key=lambda e: -e.self_device_time_total)[:10]
    text = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / n:.3f} ms x{e.count // n}"
                     for e in top)
    return busy_ms, sum(e.count for e in seen) / n, text


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
        res = res0 = ehm_forward(sc.ehm, sc.base_body, sc.base_flame)
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

        # K4 (the gather's backward) on the same plan: a seeded (16, N) gradient
        seg = dplan.segment_starts
        drows = torch.randn((16, n_tex), generator=torch.Generator().manual_seed(4)).to(DEV)
        got4 = k2.face_gather_bwd(drows, ids, seg, n_faces)
        want4 = k2.face_gather_bwd_plain(drows, ids, n_faces)
        want4_cpu = k2.face_gather_bwd_plain(drows.cpu(), ids.cpu(), n_faces).to(DEV)
        room4 = K4_TOL * k2.face_gather_bwd_plain(drows.abs(), ids, n_faces)
        torch.cuda.synchronize()
        err4 = float((got4 - want4).abs().max())
        if not bool(((got4 - want4).abs() <= room4).all()):
            raise SystemExit(f"K4 disagrees with its plain version: max abs {err4}, beyond "
                             f"{K4_TOL} of a segment's sum of |drows|")
        if not bool(((got4 - want4_cpu).abs() <= room4).all()):
            raise SystemExit("K4 disagrees with its plain version run on the CPU")
        k4_equal_cpu = torch.equal(got4, want4_cpu)
        k4_ms = cuda_ms(lambda: k2.face_gather_bwd(drows, ids, seg, n_faces))
        k4_plain_ms = cuda_ms(lambda: k2.face_gather_bwd_plain(drows, ids, n_faces))
        k4_lib_ms = cuda_ms(lambda: torch.zeros((n_faces, 16), device=DEV).index_add_(
            0, ids.long(), drows.T))
        k4_bytes = 16 * n_tex * 4 + n_tex * 4 + n_faces * 16 * 4
        k4_bound = k4_bytes / HBM_BYTES_PER_S * 1e3
        seg_len = seg[1:] - seg[:-1]
        say(3, f"K4 face gather backward: N={n_tex} Fc={n_faces}, longest segment "
               f"{int(seg_len.max())} texels (the dummy face's {int(seg_len[-1])}); max abs vs "
               f"plain on the card {err4:.3g} (held to {K4_TOL} of a segment's sum of |drows|: "
               f"index_add_ adds atomically in any order), bit-equal to plain on the CPU "
               f"(sequential, ascending texels): {k4_equal_cpu}; kernel {k4_ms:.4f} ms, plain "
               f"{k4_plain_ms:.4f} ms, zeros.index_add_ {k4_lib_ms:.4f} ms, bound "
               f"{k4_bound:.4f} ms ({k4_bytes / 1e6:.2f} MB)")

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

        # K3 (the blend's backward) on the same frame: seeded output gradients at
        # the scale a mean over the image's pixels gives them
        gen3 = torch.Generator().manual_seed(3)
        g_color = (torch.randn((SIZE, SIZE, 32), generator=gen3) / (SIZE * SIZE)).to(DEV)
        g_invd = (torch.randn((SIZE, SIZE, 1), generator=gen3) / (SIZE * SIZE)).to(DEV)
        color1, invd1, final_t1 = got1

        def k3_run():
            return k1.blend_bwd(rows, order, ranges, bg, color1, invd1, final_t1, g_color,
                                g_invd, TILE)

        got3 = k3_run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want3 = k1.blend_bwd_plain(rows, order, ranges, bg, color1, invd1, final_t1, g_color,
                                   g_invd, TILE)
        torch.cuda.synchronize()
        k3_plain_ms = (time.perf_counter() - t0) * 1e3
        col_max = want3.abs().amax(0)
        col_err = (got3 - want3).abs().amax(0)
        used = col_max > 0
        rel3 = float((col_err[used] / col_max[used]).max())
        err3 = float(col_err.max())
        big = want3.abs() > 1e-3 * col_max
        rel3_entry = float(((got3 - want3).abs()[big] / want3.abs()[big]).max())
        if bool(col_err[~used].any()) or not rel3 <= K3_TOL:
            worst = int((col_err / col_max.clamp(min=1e-30)).argmax())
            raise SystemExit(f"K3 disagrees with its plain version: column {worst} is off by "
                             f"{rel3} of its largest gradient (tol {K3_TOL})")
        if not bool(torch.isfinite(got3).all()):
            raise SystemExit("K3 produced a non-finite gradient")
        k3_ms = cuda_ms(k3_run)
        k3_bytes = (2 * P * k1.ROW * 4 + N * 4 + ranges.numel() * 4 + 32 * 4
                    + SIZE * SIZE * (33 + 1 + 33) * 4)
        k3_ops = visited * K3_OPS_VISITED + contrib * K3_OPS_CONTRIB
        k3_bound = max(k3_bytes / HBM_BYTES_PER_S, k3_ops / FP32_FLOPS) * 1e3
        k3_bound_by = "operations" if k3_ops / FP32_FLOPS > k3_bytes / HBM_BYTES_PER_S else "bytes"
        say(3, f"K3 tile blend backward: the same frame ({SIZE}^2, tile {TILE}, instances={N}); "
               f"per row column, max abs vs plain over the column's largest gradient: worst "
               f"{rel3:.3g} (tol {K3_TOL}: atomic adds in any order, and expf against "
               f"torch.exp at the 1/255 and 1e-4 thresholds), max abs {err3:.3g}, max relative "
               f"on entries over 1e-3 of their column's largest {rel3_entry:.3g}; kernel "
               f"{k3_ms:.4f} ms = {k3_ms / k1_ms:.1f} x K1, plain {k3_plain_ms:.2f} ms (one "
               f"call), bound {k3_bound:.4f} ms by {k3_bound_by} ({k3_ops / 1e9:.2f} GFLOP, "
               f"{k3_bytes / 1e6:.1f} MB)")
        del want3, got3, g_color, g_invd

        # K5 on the frame-0 mesh of the bench rig
        verts0 = res.vertices[0].contiguous()
        bins = bin_mesh(verts0, sc.faces, sc.cam, MESH_TILE)
        got5 = k5.mesh_zbuffer(bins.tris, bins.inst_fid, bins.ranges, SIZE, SIZE, MESH_TILE)
        want5 = k5.mesh_zbuffer_plain(bins.tris, bins.inst_fid, bins.ranges, SIZE, SIZE,
                                      MESH_TILE)
        torch.cuda.synchronize()
        hit = want5[0] >= 0
        if not torch.equal(got5[0], want5[0]):
            raise SystemExit(f"K5 best instance differs from its plain version at "
                             f"{int((got5[0] != want5[0]).sum())} pixels")
        if not torch.equal(torch.isinf(got5[1]), ~hit):
            raise SystemExit("K5 depth is not +inf exactly on the empty pixels")
        err5 = float((got5[1][hit] - want5[1][hit]).abs().max())
        if not err5 <= K5_DEPTH_TOL:
            raise SystemExit(f"K5 depth disagrees with its plain version: {err5} > "
                             f"{K5_DEPTH_TOL}")
        face_k = rasterize_mesh(verts0, sc.faces, sc.cam, MESH_TILE).face_idx
        face_p = torch.where(hit, bins.inst_fid[want5[0].clamp(min=0).long()], -1)
        if not torch.equal(face_k, face_p):
            raise SystemExit("K5 face_idx differs from its plain version")
        n_inst = bins.inst_fid.shape[0]
        mesh_counts = bins.ranges[1:] - bins.ranges[:-1]
        k5_ms = cuda_ms(lambda: k5.mesh_zbuffer(bins.tris, bins.inst_fid, bins.ranges, SIZE, SIZE,
                                                MESH_TILE))
        k5_plain_reps = 3   # the plain z-buffer steps through the busiest tile's run
        k5_plain_ms = cuda_ms(lambda: k5.mesh_zbuffer_plain(bins.tris, bins.inst_fid, bins.ranges,
                                                            SIZE, SIZE, MESH_TILE),
                              reps=k5_plain_reps, warmup=1)
        k5_pairs = n_inst * MESH_TILE * MESH_TILE
        k5_bytes = (bins.tris.numel() + n_inst + bins.ranges.numel() + 2 * SIZE * SIZE) * 4
        k5_ops = k5_pairs * K5_OPS_PAIR + n_inst * K5_OPS_INSTANCE
        k5_bound = max(k5_bytes / HBM_BYTES_PER_S, k5_ops / FP32_FLOPS) * 1e3
        k5_bound_by = "operations" if k5_ops / FP32_FLOPS > k5_bytes / HBM_BYTES_PER_S else "bytes"
        say(3, f"K5 mesh z-buffer: F={sc.faces.shape[0]} instances={n_inst} "
               f"busiest tile={int(mesh_counts.max())} max tiles a face="
               f"{int(bins.tiles_per_face.max())} hit pixels={float(hit.float().mean()):.4f}; "
               f"best instance and face_idx equal to plain, depth max abs {err5:.3g} "
               f"(tol {K5_DEPTH_TOL}); kernel {k5_ms:.4f} ms, plain {k5_plain_ms:.2f} ms "
               f"(median of {k5_plain_reps}), bound {k5_bound:.4f} ms by {k5_bound_by} "
               f"({k5_ops / 1e9:.3f} GFLOP over {k5_pairs} pairs, {k5_bytes / 1e6:.2f} MB)")
    del got1, want1, got2, want2, got5, want5, got4, want4, want4_cpu, drows, color1, invd1, final_t1

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
    frames = iter(targets[:n_split])
    busy_ms, launches_per_frame, top_text = profile_window(
        lambda: pipe.render_frame(main_avatar, next(frames)), n_split)
    if busy_ms > 0:
        say(4, f"profiler: device busy {busy_ms:.3f} ms/frame = {busy_ms / seq_ms:.3f} of the "
               f"unprofiled {seq_ms:.2f} ms/frame (idle share {1 - busy_ms / seq_ms:.3f}); "
               f"{launches_per_frame:.0f} device kernels a frame; top: " + top_text)
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

    # ---- 6. the creation path at full width ----
    csc = make_create_scene(SIZE, UV, BODY_SIDE, HEAD_SIDE, feat_size=FEAT, device=DEV)
    cfg = InfererConfig(image_size=SIZE, uvmap_size=UV, invtanfov=INVTANFOV)
    inferer = init_params_(UbodyGaussianInferer(cfg, csc.smplx.num_vertices),
                           torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in inferer.parameters())
    cpipe = FramePipeline(csc.ehm, csc.faces, refiner, inferer=inferer, uv_tables=csc.uv_tables,
                          image_size=SIZE, invtanfov=INVTANFOV,
                          settings=RasterizeSettings(tile=TILE), device=DEV)
    cpipe.infer_avatar(csc.source)                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k2.launches = k5.launches = 0
    create_ms = []
    for _ in range(N_CREATIONS):
        t0 = time.perf_counter()
        created, cextra = cpipe.infer_avatar(csc.source)
        torch.cuda.synchronize()
        create_ms.append((time.perf_counter() - t0) * 1e3)
    create_launches = k5.launches
    if create_launches != N_CREATIONS or k1.launches or k2.launches:
        raise SystemExit(f"{N_CREATIONS} creations launched K5 {create_launches} times, "
                         f"K1 {k1.launches}, K2 {k2.launches}: expected one K5 a creation")
    create_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_avatar(created, "creation")
    n_visible = int(cextra["visible_faces"].sum())
    if n_visible <= 0:
        raise SystemExit("creation: the z-buffer saw no face")
    texel_share = float(cextra["texel_mask"].mean())
    if created.vtx_colors.shape != (1, csc.smplx.num_vertices, 32) \
            or created.uv_colors.shape[1] % 4096 or cpipe.plan is None:
        raise SystemExit(f"creation: unexpected avatar shapes {created.uv_colors.shape}")
    med_create = statistics.median(create_ms)
    say(6, f"{N_CREATIONS} creations (ViT-B/14 {FEAT}^2 source, {UV}^2 chart, {n_params / 1e6:.1f}M "
           f"inferer parameters): median {med_create:.2f} ms/creation "
           f"(all: {', '.join(f'{t:.1f}' for t in create_ms)}; limit {CREATE_LIMIT_MS:.0f}); "
           f"K5 launches {create_launches}; visible faces {n_visible} of {csc.faces.shape[0]}, "
           f"visible texel share {texel_share:.4f}; UV rows kept {created.uv_colors.shape[1]} of "
           f"{UV * UV}; peak mem {create_peak_gb:.2f} GB")
    if not med_create <= CREATE_LIMIT_MS:
        raise SystemExit(f"creation takes {med_create:.1f} ms, over the {CREATE_LIMIT_MS:.0f} ms limit")
    split = creation_split(cpipe, csc.source, 3)
    say(6, "stage split (ms, mean of 3 creations): "
           + ", ".join(f"{st} {ms:.3f}" for st, ms in split.items())
           + f"; sum {sum(split.values()):.2f}")

    # one frame of the created avatar, if random weights left it renderable
    tgt = targets[0]
    body, flame = _unpack_params(_batched_params(tgt["params"], DEV))
    with torch.no_grad():
        cgs = deform_avatar(created, csc.ehm, csc.faces, body, flame, plan=cpipe.plan,
                            compact_faces=cpipe.cfaces)
    n_frame_inst = frame_instances(cgs, sc.cam, TILE)
    k1.launches = k2.launches = 0
    if n_frame_inst <= INSTANCE_BUDGET:
        t0 = time.perf_counter()
        cframe = cpipe.render_frame(created, tgt)
        torch.cuda.synchronize()
        cframe_ms = (time.perf_counter() - t0) * 1e3
        if (k1.launches, k2.launches) != (1, 1):
            raise SystemExit(f"frame of the created avatar: launches K1 {k1.launches} K2 {k2.launches}")
        for k, v in cframe.items():
            if not bool(torch.isfinite(v).all()):
                raise SystemExit(f"frame of the created avatar: {k} not finite")
        say(6, f"a frame of the created avatar bins {n_frame_inst} instances (budget "
               f"{INSTANCE_BUDGET}): rendered at {SIZE}^2 in {cframe_ms:.1f} ms, finite, "
               f"K1 and K2 launched once each")
    else:
        say(6, f"a frame of the created avatar would bin {n_frame_inst} instances, over the "
               f"budget of {INSTANCE_BUDGET} (random decoder weights): not rendered")
    del created, cextra, cgs, inferer, cpipe

    # ---- 7. create then render, small: the GPU path against the CPU path ----
    scfg = InfererConfig(image_size=64, uvmap_size=64, invtanfov=INVTANFOV, dino_out_dim=8,
                         uv_out_dim=16, smplx_fea_dim=16, prj_out_dim=16, global_vertex_dim=32,
                         uv_base_dim=8, style_dim=64, num_mlp=2, channel_scale=8.0, vit_dim=64,
                         vit_depth=5, vit_heads=4, pyramid_dims=(16, 16, 16, 16))
    small = {}
    for key, dev in (("cpu", torch.device("cpu")), ("gpu", DEV)):
        ssc = make_create_scene(64, 64, 21, 7, feat_size=70, device=dev)
        sinf = init_params_(UbodyGaussianInferer(scfg, ssc.smplx.num_vertices),
                            torch.Generator().manual_seed(2))
        sref = init_params_(NeuralRefiner(64, style_dim=64, num_mlp=2, channel_scale=4.0),
                            torch.Generator().manual_seed(1))
        spipe = FramePipeline(ssc.ehm, ssc.faces, sref, inferer=sinf, uv_tables=ssc.uv_tables,
                              image_size=64, invtanfov=INVTANFOV,
                              settings=RasterizeSettings(tile=16), device=dev)
        full, sextra = spipe.infer_avatar(ssc.source, prune=False)
        scam = Camera.from_w2c(torch.as_tensor(ssc.source["w2c"], device=dev), 1.0 / INVTANFOV,
                               64, 64)
        face_idx = rasterize_mesh(sextra["ehm_result"].vertices[0], ssc.faces, scam).face_idx
        pruned, _ = spipe.infer_avatar(ssc.source)
        frame = spipe.render_frame(pruned, targets[3])
        small[key] = {"avatar": {k: v.cpu() for k, v in full._asdict().items()},
                      "face_idx": face_idx.cpu(), "n_uv": pruned.uv_colors.shape[1],
                      "frame": {k: v.cpu() for k, v in frame.items()}}
    if not torch.equal(small["cpu"]["face_idx"], small["gpu"]["face_idx"]):
        raise SystemExit("64^2 creation: face_idx on the GPU differs from the CPU's")
    if int((small["gpu"]["face_idx"] >= 0).sum()) == 0:
        raise SystemExit("64^2 creation: the z-buffer hit nothing")
    field_err = {}
    for k, c in small["cpu"]["avatar"].items():
        g = small["gpu"]["avatar"][k]
        if not c.is_floating_point():
            if not torch.equal(c, g):
                raise SystemExit(f"64^2 creation: {k} differs")
        elif k == "uv_scales":     # exp of the decoder's output: held relatively
            field_err[k] = float(((g - c).abs() / c.abs().clamp(min=1e-12)).max())
        else:
            field_err[k] = float((g - c).abs().max())
    worst = max(field_err, key=field_err.get)
    if not field_err[worst] <= SMALL_CREATE_TOL:
        raise SystemExit(f"64^2 creation: {worst} GPU vs CPU {field_err[worst]} > {SMALL_CREATE_TOL}")
    if small["cpu"]["n_uv"] != small["gpu"]["n_uv"]:
        raise SystemExit("64^2 creation: pruned UV counts differ")
    cframe_err = max(float((small["cpu"]["frame"][k] - small["gpu"]["frame"][k]).abs().max())
                     for k in small["cpu"]["frame"])
    if not cframe_err <= SMALL_CREATE_TOL:
        raise SystemExit(f"64^2 create->render: GPU vs CPU max abs {cframe_err} > {SMALL_CREATE_TOL}")
    say(7, f"64^2 create -> render on the GPU vs the CPU (plain kernels): face_idx equal "
           f"({int((small['gpu']['face_idx'] >= 0).sum())} hit pixels), avatar fields worst "
           f"{worst} {field_err[worst]:.3g} (uv_scales relative), frame max abs {cframe_err:.3g} "
           f"(tol {SMALL_CREATE_TOL})")


    # ---- 8. the training step at full width ----
    tcfg = InfererConfig(image_size=SIZE, uvmap_size=UV, invtanfov=INVTANFOV)
    tsc = make_train_scene(SIZE, UV, BODY_SIDE, HEAD_SIDE, feat_size=FEAT, batch_size=1,
                           device=DEV)
    statics, lpips, state, loss_fn = train_setup(tsc, tcfg, TRAIN_LR)
    n_train = sum(p.numel() for p in state.model.parameters() if p.requires_grad)
    n_all = sum(p.numel() for p in state.model.parameters())
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_steps = N_WARMUP_STEPS + N_TIMED_STEPS
    stamps, losses, scrubbed, k3_seen = [time.perf_counter()], [], [], [0]
    train_log = []

    def on_step(it, loss, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(loss))
        scrubbed.append(int(metrics["scrubbed_grads"]))
        k3_seen.append(k1.bwd_launches)

    k1.launches = k1.bwd_launches = k2.launches = k2.bwd_launches = k5.launches = 0
    with tempfile.TemporaryDirectory() as run_dir:
        run_training(state, loss_fn, statics, [tsc.batch], n_steps, run_dir,
                     valid_batches=[tsc.batch], check_interval=10 ** 9, log_every=n_steps,
                     count_scrubbed=True, on_step=on_step, log=train_log.append)
        torch.cuda.synchronize()
        t_saved = time.perf_counter()
        train_launches = {"K1": k1.launches, "K3": k1.bwd_launches, "K5": k5.launches}
        ckpts = CheckpointManager(run_dir)
        saved = sorted(f for f in os.listdir(ckpts.dir))
        o_inferer, o_renderer = make_models(tcfg, tsc.smplx.num_vertices)   # on the CPU
        other = make_train_state(
            torch.nn.ModuleDict({"inferer": o_inferer, "renderer": o_renderer}),
            learning_rate=TRAIN_LR)
        _, restored_it = ckpts.restore(other, os.path.join(ckpts.dir, "latest.pt"))
        same = all(torch.equal(p.detach().cpu(), q.detach())
                   for p, q in zip(state.model.parameters(), other.model.parameters()))
        del other, o_inferer, o_renderer
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
    timed_ms = step_ms[N_WARMUP_STEPS:]
    med_step = statistics.median(timed_ms)
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"training: a loss is not finite: {losses}")
    k3_per_step = [b - a for a, b in zip(k3_seen[:-1], k3_seen[1:])]
    if k3_per_step != [1] * n_steps:
        raise SystemExit(f"training: K3 launches a step {k3_per_step}, expected 1 (the batch size)")
    # a step launches K1 and K5 once an item; the closing validation adds one of each
    if train_launches != {"K1": n_steps + 1, "K3": n_steps, "K5": n_steps + 1}:
        raise SystemExit(f"training: launches {train_launches} over {n_steps} steps and one "
                         f"validation")
    moved = {n: float((p.detach() - before[n]).abs().max())
             for n, p in state.model.named_parameters() if p.requires_grad}
    n_moved = sum(v > 0 for v in moved.values())
    if n_moved == 0:
        raise SystemExit("training: no parameter changed")
    frozen_moved = [n for n, p in state.model.named_parameters()
                    if not p.requires_grad and not torch.equal(p.detach(), before[n])]
    if frozen_moved:
        raise SystemExit(f"training: frozen parameters changed: {frozen_moved[:3]}")
    if restored_it != n_steps or not same or "latest.pt" not in saved:
        raise SystemExit(f"training: checkpoint {saved} restored at iteration {restored_it}, "
                         f"parameters equal: {same}")
    del before
    say(8, f"{n_steps} training steps of batch 1 at full width through run_training "
           f"({n_all / 1e6:.1f}M parameters, {n_train / 1e6:.1f}M trained, LPIPS alex, f32, lr "
           f"{TRAIN_LR}): median {med_step:.1f} ms/step over the last {N_TIMED_STEPS} (all: "
           f"{', '.join(f'{t:.0f}' for t in step_ms)}); losses "
           f"{', '.join(f'{v:.4f}' for v in losses)}; non-finite gradient entries zeroed a step "
           f"{scrubbed}; launches {train_launches} (one validation included), K3 a step "
           f"{k3_per_step[0]}; {n_moved} of {len(moved)} trained tensors moved; checkpoints "
           f"{saved} written and latest restored at iteration {restored_it} in "
           f"{time.perf_counter() - t_saved:.1f} s; peak mem {train_peak_gb:.2f} GB")
    say(8, f"  {train_log[-1]}")

    split, n_train_inst = train_split(statics, lpips, state, tsc.batch, 3)
    say(8, "stage split (ms, mean of 3 steps): "
           + ", ".join(f"{st} {ms:.2f}" for st, ms in split.items())
           + f"; sum {sum(split.values()):.1f}; the step's frame bins {n_train_inst} instances")
    step1 = make_train_step(loss_fn, state)
    busy_ms, n_dev_kernels, top_text = profile_window(lambda: step1(tsc.batch), 1)
    if busy_ms > 0:
        say(8, f"profiler over one step: device busy {busy_ms:.1f} ms = {busy_ms / med_step:.3f} "
               f"of the unprofiled {med_step:.1f} ms/step (idle share "
               f"{1 - busy_ms / med_step:.3f}); {n_dev_kernels:.0f} device kernels a step; top: "
               + top_text)
    else:
        say(8, "profiler recorded no device time: busy share not measured")

    # one accumulated step of batch 2
    tsc2 = make_train_scene(SIZE, UV, BODY_SIDE, HEAD_SIDE, feat_size=FEAT, batch_size=2,
                            seed=1, device=DEV)
    k1.launches = k1.bwd_launches = k5.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss2, metrics2 = make_sample_scan_step(loss_fn, state, count_scrubbed=True)(tsc2.batch)
    torch.cuda.synchronize()
    accum_ms = (time.perf_counter() - t0) * 1e3
    accum_launches = {"K1": k1.launches, "K3": k1.bwd_launches, "K5": k5.launches}
    if accum_launches != {"K1": 2, "K3": 2, "K5": 2} or not math.isfinite(float(loss2)):
        raise SystemExit(f"accumulated step of batch 2: launches {accum_launches}, loss "
                         f"{float(loss2)}")
    say(8, f"one accumulated step of batch 2: {accum_ms:.1f} ms, loss {float(loss2):.4f}, "
           f"launches {accum_launches}, non-finite gradient entries zeroed "
           f"{int(metrics2['scrubbed_grads'])}")
    del statics, lpips, state, loss_fn, step1, tsc, tsc2

    # ---- 9. a 32^2 training step: the GPU path against the CPU path ----
    micro = {}
    for key, dev in (("cpu", torch.device("cpu")), ("gpu", DEV)):
        mp = make_micro_pipeline(batch_size=2, device=dev)
        mmodel = torch.nn.ModuleDict({"inferer": mp.statics.inferer,
                                      "renderer": mp.statics.renderer})
        k1.bwd_launches = 0
        mloss, _ = make_loss_fn(mp.statics, None)(mp.batch, 0)
        mloss.backward()
        micro[key] = (float(mloss.detach()),
                      {n: p.grad.detach().cpu() for n, p in mmodel.named_parameters()
                       if p.grad is not None}, k1.bwd_launches)
    (closs, cgrads, _), (gloss, ggrads, micro_k3) = micro["cpu"], micro["gpu"]
    if micro_k3 != 2 or sorted(cgrads) != sorted(ggrads):
        raise SystemExit(f"32^2 step: K3 launched {micro_k3} times for a batch of 2")
    if not abs(gloss - closs) <= MICRO_LOSS_RTOL * abs(closs):
        raise SystemExit(f"32^2 step: loss {gloss} on the GPU, {closs} on the CPU")
    worst_name, worst_excess, worst_rel = None, -1.0, 0.0
    for n, c in cgrads.items():
        g = ggrads[n]
        if not bool(torch.isfinite(g).all()):
            raise SystemExit(f"32^2 step: gradient of {n} not finite on the GPU")
        scale = float(c.abs().max())
        excess = float(((g - c).abs() - MICRO_GRAD_RTOL * c.abs()).max()) / max(scale, 1e-30)
        if excess > worst_excess:
            worst_name, worst_excess = n, excess
            worst_rel = float((g - c).abs().max()) / max(scale, 1e-30)
    if not worst_excess <= MICRO_GRAD_ATOL:
        raise SystemExit(f"32^2 step: gradient of {worst_name} differs by {worst_rel} of its "
                         f"largest entry (rtol {MICRO_GRAD_RTOL}, atol {MICRO_GRAD_ATOL} of it)")
    say(9, f"32^2 training step of batch 2 on the GPU vs the CPU (plain kernels): loss {gloss:.6f} "
           f"vs {closs:.6f} (rtol {MICRO_LOSS_RTOL}); {len(cgrads)} parameter gradients within "
           f"rtol {MICRO_GRAD_RTOL} + {MICRO_GRAD_ATOL} of each one's largest entry, worst "
           f"{worst_name} at {worst_rel:.3g} of its largest; K3 launched {micro_k3} times")

    # ---- 10. the planned deform path's gradient (K2 forward, K4 backward) ----
    valid_w = avatar.uv_valid.float()[None, :, None]
    n_vtx = sc.smplx.num_vertices
    gen10 = torch.Generator().manual_seed(10)
    w_xyz = torch.randn((1, n_vtx + n_tex, 3), generator=gen10).to(DEV)
    w_scale = torch.randn((1, n_vtx + n_tex, 3), generator=gen10).to(DEV)
    w_rot = torch.randn((1, n_vtx + n_tex, 4), generator=gen10).to(DEV)
    for w in (w_xyz, w_scale, w_rot):      # invalid texels bind another face in each path
        w[:, n_vtx:] *= valid_w
    k2.launches = k2.bwd_launches = 0
    vgrads = {}
    for path in ("rows", "planned"):
        verts = res0.vertices.detach().clone().requires_grad_(True)
        kw = dict(plan=dplan, compact_faces=cfaces) if path == "planned" else {}
        dgs = deform_with_vertices(avatar, verts, res0.vertex_transforms, sc.faces, **kw)
        ((dgs.xyz * w_xyz).sum() + (dgs.scaling * w_scale).sum()
         + (dgs.rotation * w_rot).sum()).backward()
        vgrads[path] = verts.grad
    planned_launches = {"K2": k2.launches, "K4": k2.bwd_launches}
    if planned_launches != {"K2": 1, "K4": 1}:
        raise SystemExit(f"planned-path gradient: launches {planned_launches}")
    vscale = float(vgrads["rows"].abs().max())
    verr = float((vgrads["planned"] - vgrads["rows"]).abs().max()) / vscale
    if not (math.isfinite(verr) and vscale > 0 and verr <= PLANNED_GRAD_TOL):
        raise SystemExit(f"planned-path gradient differs from the row-gather path's by {verr} "
                         f"of its largest entry (tol {PLANNED_GRAD_TOL})")
    say(10, f"gradient of a scalar of the planned deform w.r.t. the {n_vtx} posed vertices at "
            f"the bench avatar (K2 forward, K4 backward, launches {planned_launches}) vs the "
            f"row-gather path's: max abs difference {verr:.3g} of the largest entry (tol "
            f"{PLANNED_GRAD_TOL})")

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
        {"name": "K3 tile blend backward", "route": "cuda",
         "source": "guava_renderer_tpu_torch/csrc/blend_bwd.cu",
         "replaces": "guava_renderer_tpu/ops/gsplat.py:1457", "launches": train_launches["K3"],
         "max_abs_err": err3, "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_bound_by, "library_ms": None},
        {"name": "K4 face gather backward", "route": "cuda",
         "source": "guava_renderer_tpu_torch/csrc/facegather_bwd.cu",
         "replaces": "guava_renderer_tpu/ops/facegather.py:143",
         "launches": planned_launches["K4"], "max_abs_err": err4, "ms": k4_ms,
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": "bytes",
         "library_ms": k4_lib_ms},
        {"name": "K5 mesh z-buffer", "route": "cuda",
         "source": "guava_renderer_tpu_torch/csrc/meshraster.cu",
         "replaces": "guava_renderer_tpu/ops/meshraster.py:39", "launches": create_launches,
         "max_abs_err": err5, "ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound,
         "bound_by": k5_bound_by, "library_ms": None},
    ]
    if not all(math.isfinite(k[f]) for k in kernels for f in ("ms", "plain_ms", "bound_ms")):
        raise SystemExit(f"non-finite timing in {kernels}")
    say("done", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
