"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (one line each, then a JSON line of the kernels, then a last line
{"ok": true, "device": {...}}); any failure exits non-zero before that line:
  1. the device, and `nvidia-smi`'s name and power limit;
  2. build the CUDA kernels from `guava_renderer_tpu_torch/csrc`;
  3. each kernel against its plain PyTorch version at the shapes of the
     full-scale bench scene's frame 0, with times (CUDA events, medians);
  4. the frame path at full width: FramePipeline with StyleUNet-small 512
     renders 20 frames through render_frame and through render_frames,
     with launch counts, fps and a per-stage split;
  5. the same pipeline on a small scene, on the GPU against the CPU;
  6. the creation path at full width: FramePipeline.infer_avatar with the
     full InfererConfig (ViT-B/14, 518^2 source, 512^2 chart) creates an
     avatar 5 times, with launch counts, ms/creation, a per-stage split
     and one frame rendered from the created avatar;
  7. create then render at 64^2 and narrow widths, on the GPU against the
     CPU.
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
from guava_renderer_tpu_torch.avatar.inferer import (  # noqa: E402
    InfererConfig, UbodyGaussianInferer, assemble_avatar, texel_visibility)
from guava_renderer_tpu_torch.avatar.renderer import NeuralRefiner  # noqa: E402
from guava_renderer_tpu_torch.benchscene import (  # noqa: E402
    INVTANFOV, make_bench_scene, make_create_scene)
from guava_renderer_tpu_torch.bodymodel.ehm import ehm_forward  # noqa: E402
from guava_renderer_tpu_torch.cli.inference import (  # noqa: E402
    FramePipeline, _batched_params, _unpack_params)
from guava_renderer_tpu_torch.core.cameras import Camera  # noqa: E402
from guava_renderer_tpu_torch.kernels import blend as k1  # noqa: E402
from guava_renderer_tpu_torch.kernels import build  # noqa: E402
from guava_renderer_tpu_torch.kernels import facegather as k2  # noqa: E402
from guava_renderer_tpu_torch.kernels import meshraster as k5  # noqa: E402
from guava_renderer_tpu_torch.models.layers import harmonic_embedding  # noqa: E402
from guava_renderer_tpu_torch.models.styleunet import init_params_  # noqa: E402
from guava_renderer_tpu_torch.ops.facegather import build_face_sort_plan, compact_faces  # noqa: E402
from guava_renderer_tpu_torch.ops.gsplat import RasterizeSettings, bin_gaussians, pack_rows  # noqa: E402
from guava_renderer_tpu_torch.ops.gsplat_project import project_gaussians, tile_rect  # noqa: E402
from guava_renderer_tpu_torch.ops.meshraster import bin_mesh, rasterize_mesh  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12             # H100 SXM, FP32 outside the tensor cores
# K1 operation counts per (instance, pixel) pair, from csrc/blend.cu: a
# visited pair evaluates the offset, the conic quadratic, an exp and the two
# tests (~16 FP32 ops); a contributing pair adds the alpha clamp, the
# transmittance update and 33 FMAs into the accumulators (~71 more)
K1_OPS_VISITED = 16
K1_OPS_CONTRIB = 71
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
    del got1, want1, got2, want2, got5, want5

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
