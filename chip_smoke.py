"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (one line each, then a JSON line of the kernels, then a last line
{"ok": true, "device": {...}}); any failure exits non-zero before that line:
  1. the device, and `nvidia-smi`'s name and power limit;
  2. build the CUDA kernels from `guava_renderer_tpu_torch/csrc`;
  3. each of the five kernels against its plain PyTorch version at the
     shapes of the full-scale bench scene's frame 0, with times (CUDA
     events, medians); K2 in turns with table[ids].T and the launch floor,
     and on small edge cases (odd N, unaligned ids, one face, a face a
     texel); K5 bit-equal to its plain version and to its split model,
     and on the z-buffer edge scenes of testing.zbuffer_scenes at tiles 8,
     16 and 32, one of them with slack around its runs;
     K1 also on a tile-16 binning of the same frame
     against its plain version there, with the cull's kept rows at both
     tiles; the registers and shared memory ptxas gave K1, K3, K7, K6, K8
     and K1p's two stages and their resident CTAs an SM; K4 bit-equal to a
     second launch and to its
     windowed plain model, its windows and the faces that cross them, K4
     and zeros.index_add_ in turns, and K4 at a few small edge cases
     (partial last window, empty segments, Fc = 1, one face on every texel);
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
     backward kernels) against the row-gather path's at the bench avatar;
 11. the raster variants (bf16 rows: K6; size classes with a resident
     table: K7, built by K9; streaming: K8): each kernel against its plain
     version and against K1 at frame 0; K9 in turns with index_select and
     the launch floor at three table sizes, behind the ranking that feeds
     it against the ranking alone, and on small edge cases; the committed
     golden render through K1 and through K7 with K9; the four forward blends in turns
     (one kernel with four row sources), 20 frames through
     render_frame under each setting (the vmem frame's device operations
     against the default frame's, by name), a 64^2 frame GPU vs CPU, the frame's
     gradient against the default path's, a 32^2 bf16 training step GPU vs
     CPU and two full-width training steps under each setting;
 12. the probe tools at their defaults (K1p in tools/ee_probe.py, T2
     tools/dma_bench.py over every variant, T3 and the payload sorts
     tools/sort_payload_bench.py, the seven T1 copy probes
     tools/mosaic_probe.py, each in a subprocess of its own, one after
     another, aligned, then off alignment those whose route that changes
     (idx32 and idx1024 to async4), so both routes run), with launch
     counts; then
     K1p against its plain version at six (chunk, exit_every) and bit-equal
     to K1, K1 and K1p at (128, 1) and (256, 1) timed in turns, K1p at
     (128, 1) and (256, 1) on a tile-8 binning (64-thread CTAs, rounds
     longer than the CTA) against its plain counts and K1's image there,
     every T2 variant against its plain version and its staged rows against index_select (T2 timed as the
     copies alone and with its in-order sum), T2's rows variant on two
     yardstick id sets (a permutation of the table; ids over the 16.8 MB
     that the contig variants read) and each variant's rate against its
     yardstick's, T3 against table.sum(0) and
     the float64 sum; each T1 probe in turns with one PyTorch call that
     writes the same values and the launch floor (one near-empty kernel),
     with the bytes each must move.
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
    INVTANFOV, UBODY_LADDER, make_bench_scene, make_create_scene, make_train_scene)
from guava_renderer_tpu_torch.bodymodel.ehm import ehm_forward  # noqa: E402
from guava_renderer_tpu_torch.cli.inference import (  # noqa: E402
    FramePipeline, _batched_params, _unpack_params)
from guava_renderer_tpu_torch.cli.trainer_loop import run_training  # noqa: E402
from guava_renderer_tpu_torch.core.cameras import Camera  # noqa: E402
from guava_renderer_tpu_torch.kernels import blend as k1  # noqa: E402
from guava_renderer_tpu_torch.kernels import build  # noqa: E402
from guava_renderer_tpu_torch.kernels import copy_probe as kt1  # noqa: E402
from guava_renderer_tpu_torch.kernels import rowcopy as kt2  # noqa: E402
from guava_renderer_tpu_torch.kernels import stream_sum as kt3  # noqa: E402
from guava_renderer_tpu_torch.kernels import facegather as k2  # noqa: E402
from guava_renderer_tpu_torch.kernels import gather_rows as k9  # noqa: E402
from guava_renderer_tpu_torch.kernels import meshraster as k5  # noqa: E402
from guava_renderer_tpu_torch.models.layers import harmonic_embedding  # noqa: E402
from guava_renderer_tpu_torch.models.styleunet import init_params_  # noqa: E402
from guava_renderer_tpu_torch.ops.facegather import (  # noqa: E402
    build_face_sort_plan, compact_faces, segment_starts)
from guava_renderer_tpu_torch.ops.gsplat import (  # noqa: E402
    MAX_RESIDENT_ROWS, RasterizeSettings, bin_gaussians, pack_rows, rasterize, remap_resident,
    resident_count, resident_ids, resident_keys, round_colors_bf16, stream_rows)
from guava_renderer_tpu_torch.ops.gsplat_project import project_gaussians, tile_rect  # noqa: E402
from guava_renderer_tpu_torch.ops.meshraster import (  # noqa: E402
    bin_mesh, bin_triangles, rasterize_mesh)
from guava_renderer_tpu_torch.testing import (  # noqa: E402
    make_micro_pipeline, pad_instances, zbuffer_scenes)
from guava_renderer_tpu_torch.tools import (  # noqa: E402
    device_ms, dma_bench, ee_probe, mosaic_probe, sort_payload_bench)
from guava_renderer_tpu_torch.tools.dma_bench import HOT_ROWS  # noqa: E402
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
# K4's edge cases on the card, (N, Fc) of seeded sorted ids: a last window
# only partly filled (N no multiple of k2.WINDOW), an empty segment between
# bound faces (Fc >= 3), faces spanning many windows, Fc = 1, and one face
# holding every texel with the last (dummy) face empty (Fc = 2)
K4_EDGE_CASES = ((5000, 600), (4000, 9), (6148, 20), (4096, 1), (3072, 2))
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
# the same step with bf16 rows: a color whose f32 value differs between the devices by an
# ulp near a bf16 rounding boundary rounds to neighbouring bf16 values, 2^-8 apart, so the
# step's gradients agree to rtol MICRO_GRAD_RTOL + this share of each leaf's largest entry
# (2.0e-3 measured on an H100)
MICRO_BF16_GRAD_ATOL = 1e-2
PLANNED_GRAD_TOL = 1e-4        # planned against row-gather vertex gradient, share of its max
K5_DEPTH_TOL = 1e-6
# K5's edge cases (testing.zbuffer_scenes at SIZE^2), each at these tiles
K5_EDGE_TILES = (8, 16, 32)
# K2's edge cases on the card, (N, Fc, ids): seeded sorted ids ("sorted"), one face on
# every texel, a new face at every texel ("each texel"), and sorted ids starting 4 bytes
# past a 16-byte boundary ("off 16 bytes"); N % 4 != 0 and unaligned ids take the
# kernel's one-float path
K2_EDGE_CASES = ((5000, 600, "sorted"), (4097, 600, "sorted"), (256, 20, "sorted"),
                 (4096, 1, "one face"), (4099, 2, "sorted"), (4096, 4096, "each texel"),
                 (4101, 37, "each texel"), (4096, 600, "off 16 bytes"))
# K9 alone beside the bench's resident table (L = 1,065): seeded distinct ids, up to the
# largest table the settings accept (MAX_RESIDENT_ROWS = 16,384 rows, 5.83 MB)
K9_SIZES = (4096, MAX_RESIDENT_ROWS)
# the committed golden render (tests/golden/raster_scene_v1.npz) at the tolerances of
# tests/test_golden_regression.py; its resident path keeps the first two classes of this
# ladder, 48 of the scene's 96 Gaussians (tests/test_torch_golden_raster.py)
GOLDEN = ROOT / "tests" / "golden" / "raster_scene_v1.npz"
GOLDEN_ATOL = 2e-5
GOLDEN_LADDER = ((16, 16), (32, 16), (48, 16))
SMALL_CREATE_TOL = 1e-3        # GPU vs CPU through ~40 float32 layers and the blend
# a frame of an avatar created with random weights is rendered only if it
# bins at most this many (Gaussian, tile) instances
INSTANCE_BUDGET = 64_000_000
CREATE_LIMIT_MS = 1000.0       # the reference's "sub-second" creation
# phase 12: K1p's (chunk, exit_every) held against its plain version; every T2 variant
# (name:banks); T2's scalar against its plain version (the same f32 adds in the same
# order: equal, held to this relative tolerance) and T3 against table.sum(0) (other
# summation orders over 809,984 rows) and against the float64 sum (the kernel's f32 order,
# run sums of ~6,144 rows then 132 partials, emulated in numpy on such a table: 6.0e-7;
# a row of the table dropped or added moves a column by up to 2.5e-6)
K1P_SETTINGS = ((32, 1), (32, 4), (32, 0), (64, 1), (128, 1), (256, 1))
# K1p also at tile 8, whose sub-tile CTAs have 64 threads: there a round of 128 or 256 rows
# is longer than the CTA, and each thread issues several of its copies
K1P_WIDE_TILE = 8
K1P_WIDE_SETTINGS = ((128, 1), (256, 1))
T2_VARIANTS = "contig:1,rows:1,rows:4,rows_pipe:1,contig_pipe:1,rows_pipe_bf16:1,rows_pipe_2rows:1"
# T1 off alignment: the probes whose route that changes (idx32 and idx1024 to async4); the
# others take the bulk route again one element or row away
T1_OFF_ROUTE = ",".join(n for n, at in mosaic_probe.OFFSETS.items()
                        if kt1.route(n, at + 1) != kt1.route(n, at))
T2_RTOL = 1e-6
T3_RTOL = 1e-5
T3_F64_RTOL = 2e-6


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    """Median device time of fn() over reps runs (CUDA events), each queued
    behind a device spin so that the host's time to reach the launch is not
    counted (`tools.device_ms`)."""
    return device_ms(fn, DEV, reps, warmup)


def ptxas_usage(*mangled):
    """The line ptxas printed for the kernel whose mangled name holds every
    piece of `mangled` (registers, shared memory, spills), from this run's
    build."""
    lines = build.build_log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and all(m in ln for m in mangled):
            spills = ""
            for nxt in lines[i + 1:i + 6]:
                if "spill" in nxt:
                    spills = "; " + nxt.strip()
                if "registers" in nxt:
                    return nxt.split(":", 1)[-1].strip() + spills
    return "not in this run's build log"


def k4_edge_cases():
    """Phase 3: K4 on K4_EDGE_CASES, bit-equal to its windowed plain model,
    within K4_TOL of index_add_, and zeros on the empty segments."""
    g = np.random.default_rng(7)
    for n, n_faces in K4_EDGE_CASES:
        ids = np.sort(g.integers(0, n_faces, n)) if n_faces > 2 else np.zeros(n, np.int64)
        if n_faces >= 3:
            ids[ids == n_faces // 2] = n_faces // 2 + 1
        seg = torch.as_tensor(segment_starts(ids, n_faces), device=DEV)
        it = torch.as_tensor(ids, dtype=torch.int32, device=DEV)
        drows = torch.as_tensor(g.normal(size=(16, n)).astype(np.float32), device=DEV)
        got = k2.face_gather_bwd(drows, it, seg, n_faces)
        want = k2.face_gather_bwd_plain(drows, it, n_faces)
        room = K4_TOL * k2.face_gather_bwd_plain(drows.abs(), it, n_faces)
        empty = (seg[1:] == seg[:-1]).nonzero().flatten()
        if not torch.equal(got, k2.face_gather_bwd_windowed_plain(drows, it, seg, n_faces)):
            raise SystemExit(f"K4 differs from its windowed plain model at N={n} Fc={n_faces}")
        if not bool(((got - want).abs() <= room).all()):
            raise SystemExit(f"K4 disagrees with index_add_ at N={n} Fc={n_faces}: max abs "
                             f"{float((got - want).abs().max())}")
        if not bool((got[empty] == 0).all()):
            raise SystemExit(f"K4 gives an empty segment a nonzero sum at N={n} Fc={n_faces}")
        lengths = (seg[1:] - seg[:-1]).cpu()
        say(3, f"K4 edge case N={n} Fc={n_faces}: {-(-n // k2.WINDOW)} windows (the last holds "
               f"{n - (n - 1) // k2.WINDOW * k2.WINDOW} texels), {int(empty.numel())} empty "
               f"segments, longest {int(lengths.max())} texels; bit-equal to the windowed "
               f"plain model, max abs vs index_add_ {float((got - want).abs().max()):.3g}")


def k2_edge_cases():
    """Phase 3: K2 on K2_EDGE_CASES, each equal to face_gather_plain."""
    g = np.random.default_rng(2)
    for n, n_faces, kind in K2_EDGE_CASES:
        table = torch.as_tensor(g.normal(size=(n_faces, 16)).astype(np.float32), device=DEV)
        if kind == "one face":
            ids = np.zeros(n, np.int64)
        elif kind == "each texel":
            ids = np.arange(n) % n_faces
        else:
            ids = np.sort(g.integers(0, n_faces, n))
        it = torch.as_tensor(ids, dtype=torch.int32, device=DEV)
        if kind == "off 16 bytes":
            it = torch.cat([it[:1], it])[1:]
        if not torch.equal(k2.face_gather(table, it), k2.face_gather_plain(table, it)):
            raise SystemExit(f"K2 differs from its plain version at N={n} Fc={n_faces} ({kind})")
    say(3, "K2 edge cases (N, Fc, ids): " + ", ".join(f"({n}, {f}, {k})"
                                                    for n, f, k in K2_EDGE_CASES)
        + ": each equal to its plain version")


def k9_alone(rows, keys, id_bits):
    """Phase 11: K9 alone, in turns with index_select and the launch floor
    (in order then back, twice; medians), at the bench's resident table
    (`keys` of the ranking) and at K9_SIZES of seeded distinct ids, each
    equal to its plain version. -> {L: times and bound}."""
    g = np.random.default_rng(9)
    P = rows.shape[0]
    cases = {keys.shape[0]: keys}
    for n in K9_SIZES:
        ids = torch.as_tensor(g.choice(P, n, replace=False), device=DEV)
        cases[n] = (torch.arange(n, device=DEV) << id_bits) | ids
    out = {}
    for n, kk in cases.items():
        ids64 = kk & ((1 << id_bits) - 1)
        got, lids = k9.gather_resident(rows, kk, id_bits)
        want, want_lids = k9.gather_resident_plain(rows, kk, id_bits)
        if not (torch.equal(got, want) and torch.equal(lids, want_lids)
                and torch.equal(k9.gather_rows(rows, lids), want)):
            raise SystemExit(f"K9 differs from its plain version at L={n}")
        t = turn_times({"K9": lambda: k9.gather_resident(rows, kk, id_bits),
                        "index_select": lambda: torch.index_select(rows, 0, ids64),
                        "launch floor": mosaic_probe.launch_floor})
        n_bytes = n * k1.ROW * 4 * 2 + n * 4
        out[n] = {"ms": statistics.median(t["K9"]), "ms_spread": least_most(t["K9"]),
                  "index_select_ms": statistics.median(t["index_select"]),
                  "floor_ms": statistics.median(t["launch floor"]),
                  "floor_spread": least_most(t["launch floor"]),
                  "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bytes": n_bytes}
    return out


def k9_edge_cases(rows):
    """Phase 11: both K9 entries on small cases, each equal to its plain
    version; an empty table launches nothing."""
    P = rows.shape[0]
    g = np.random.default_rng(19)
    cases = {"L=0": [], "L=1": [P // 2], "repeated ids": g.integers(0, 5, 300),
             "ids 0 and P-1": [0, P - 1, 0, P - 1, P - 1]}
    for name, ids in cases.items():
        it = torch.as_tensor(np.asarray(ids, np.int32), device=DEV)
        keys = (torch.arange(it.numel(), device=DEV) << 31) | it.long()
        before = k9.launches
        got = k9.gather_rows(rows, it)
        table, lids = k9.gather_resident(rows, keys, 31)
        want = k9.gather_rows_plain(rows, it)
        if not (torch.equal(got, want) and torch.equal(table, want) and torch.equal(lids, it)):
            raise SystemExit(f"K9 edge case {name}: differs from its plain version")
        if k9.launches - before != (0 if name == "L=0" else 2):
            raise SystemExit(f"K9 edge case {name}: {k9.launches - before} launches")
    say(11, "K9 edge cases (" + ", ".join(cases) + "): both entries equal to their plain "
            "versions; L=0 launched nothing")


def golden_on_card():
    """Phase 11: the committed golden render through K1 and through K7 with
    K9 on the card: radii equal, color and invdepth within GOLDEN_ATOL."""
    s = np.load(GOLDEN)
    tf = torch.tensor(float(s["tanfov"]), dtype=torch.float32, device=DEV)
    n = int(s["size"])
    cam = Camera(R=torch.eye(3, device=DEV), t=torch.zeros(3, device=DEV), tanfovx=tf,
                 tanfovy=tf, width=n, height=n)
    args = [torch.as_tensor(s[k], device=DEV)
            for k in ("means", "colors", "opacity", "scales", "quats", "bg")]
    errs = {}
    for name, st in (("K1", RasterizeSettings(tile=16)),
                     ("K7 + K9", RasterizeSettings(tile=16, size_classes=GOLDEN_LADDER,
                                                   vmem_classes=2))):
        k1.launches = k1.resident_launches = k9.launches = 0
        with torch.no_grad():
            color, radii, invd = rasterize(*args[:5], cam, args[5], st)
        counts = (k1.launches, k1.resident_launches, k9.launches)
        if counts != ((1, 0, 0) if name == "K1" else (0, 1, 1)):
            raise SystemExit(f"golden render by {name}: launches (K1, K7, K9) {counts}")
        if not np.array_equal(radii.cpu().numpy(), s["radii"]):
            raise SystemExit(f"golden render by {name}: radii differ")
        errs[name] = (float(np.abs(color.cpu().numpy() - s["color"]).max()),
                      float(np.abs(invd.cpu().numpy() - s["invdepth"]).max()))
        if not max(errs[name]) <= GOLDEN_ATOL:
            raise SystemExit(f"golden render by {name}: max abs (color, invdepth) "
                             f"{errs[name]} > {GOLDEN_ATOL}")
    say(11, f"golden render ({GOLDEN.name}, tile 16): radii equal; max abs (color, invdepth) "
            + ", ".join(f"{k} {c:.3g}, {i:.3g}" for k, (c, i) in errs.items())
            + f" (tol {GOLDEN_ATOL})")


def k5_edge_cases():
    """Phase 3: K5 on testing.zbuffer_scenes at SIZE^2 and K5_EDGE_TILES: the
    best instance equal to mesh_zbuffer_plain's and to the split model's,
    depth within K5_DEPTH_TOL, +inf exactly on the empty pixels. The
    tie_segments scene runs again with tile 0's run as slack before the
    first run and after the last (`+slack`), which no tile may read."""
    lines = []
    cases = []
    for name, (tri, tri_z) in zbuffer_scenes(SIZE, k5.SEGMENT, seed=5).items():
        for tile in K5_EDGE_TILES:
            b = bin_triangles(torch.as_tensor(tri, device=DEV), torch.as_tensor(tri_z, device=DEV),
                              SIZE, SIZE, tile)
            cases.append((name, tile, b, b.inst_fid, b.ranges))
            if name == "tie_segments":
                run0 = b.inst_fid[int(b.ranges[0]):int(b.ranges[1])]
                cases.append((name + "+slack", tile, b,
                              *pad_instances(b.inst_fid, b.ranges, run0, run0)))
    for name, tile, b, inst_fid, ranges in cases:
        args = (b.tris, inst_fid, ranges, SIZE, SIZE, tile)
        got = k5.mesh_zbuffer(*args)
        want = k5.mesh_zbuffer_plain(*args)
        model = k5.mesh_zbuffer_split_plain(*args)
        where = f"K5 edge case {name} at tile {tile}"
        if not torch.equal(got[0], want[0]):
            raise SystemExit(f"{where}: best differs from the plain version at "
                             f"{int((got[0] != want[0]).sum())} pixels")
        if not torch.equal(got[0], model[0]):
            raise SystemExit(f"{where}: best differs from the split model")
        hit = want[0] >= 0
        if not torch.equal(torch.isinf(got[1]), ~hit):
            raise SystemExit(f"{where}: depth is not +inf exactly on the empty pixels")
        err = float((got[1][hit] - want[1][hit]).abs().max()) if bool(hit.any()) else 0.0
        if not err <= K5_DEPTH_TOL:
            raise SystemExit(f"{where}: depth off by {err} > {K5_DEPTH_TOL}")
        runs = ranges[1:] - ranges[:-1]
        lines.append(f"{name}/{tile}: {inst_fid.numel()} instances, busiest tile "
                     f"{int(runs.max())}, {int((runs == 0).sum())} empty tiles, {int(hit.sum())} "
                     f"hit pixels, depth {'bit-equal' if torch.equal(got[1], want[1]) else err}")
    say(3, f"K5 edge cases at {SIZE}^2 (segment {k5.SEGMENT}), best equal to the plain version "
           f"and the split model, +inf on every empty pixel: " + "; ".join(lines))


def turn_times(runs, cycles=2):
    """Device ms of each callable timed in turns, in order then in reverse
    ((a, b, b, a) for two), `cycles` times (`cuda_ms`, 10 launches each),
    so that drift favours none -> {name: [ms of each turn]}."""
    seq = list(runs.items())
    times = {k: [] for k in runs}
    for _ in range(cycles):
        for k, fn in seq + seq[::-1]:
            times[k].append(cuda_ms(fn))
    return times


def in_turns(runs, cycles=2):
    """Median device ms of each callable timed in `turn_times`."""
    return {k: statistics.median(v) for k, v in turn_times(runs, cycles).items()}


def least_most(ms):
    """[least, most] of a list of ms."""
    return [min(ms), max(ms)]


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


def train_setup(scene, cfg, lr, raster=RasterizeSettings(tile=TILE)):
    """Random-weight models, LPIPS, statics, train state and loss function
    for a training scene at the widths of `cfg` (seed 0)."""
    gen = torch.Generator().manual_seed(0)
    inferer, renderer = make_models(cfg, scene.smplx.num_vertices,
                                    refiner_channel_scale=cfg.channel_scale,
                                    raster_settings=raster)
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


def profile_by_name(fn, n):
    """torch.profiler over n calls of fn -> {device operation: (device ms a
    call, launches a call)}."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3 / n, e.count / n) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def profile_window(fn, n):
    """torch.profiler over n calls of fn -> (device busy ms a call, device
    kernels a call, the ten longest device operations as text)."""
    ops = profile_by_name(fn, n)
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:10]
    text = "; ".join(f"{k[:60]} {ms:.3f} ms x{count:.0f}" for k, (ms, count) in top)
    return sum(ms for ms, _ in ops.values()), sum(c for _, c in ops.values()), text


# the vmem frame's device operations over the default frame's, by kernel name
VMEM_GROUPS = (("the ranking's topk", ("mbtopk", "radixSort", "gatherTopK")),
               ("the forward blend (K7 for K1)", ("blend_fwd_kernel",)),
               ("K9", ("gather_rows_kernel",)))


def vmem_breakdown(default_ops, vmem_ops):
    """-> ({group: [ms, launches] a frame more under vmem}, [(ms, launches,
    name)] of the ungrouped operations that differ, largest first)."""
    groups = {g: [0.0, 0.0] for g, _ in VMEM_GROUPS} | {"the rest": [0.0, 0.0]}
    rest = []
    for k in set(default_ops) | set(vmem_ops):
        a, b = default_ops.get(k, (0.0, 0.0)), vmem_ops.get(k, (0.0, 0.0))
        dm, dn = b[0] - a[0], b[1] - a[1]
        g = next((g for g, pats in VMEM_GROUPS if any(p in k for p in pats)), "the rest")
        groups[g][0] += dm
        groups[g][1] += dn
        if g == "the rest" and (abs(dn) > 0.01 or abs(dm) > 0.002):
            rest.append((dm, dn, k))
    return groups, sorted(rest, key=lambda r: -abs(r[0]))


def micro_step_vs_cpu(raster=None, grad_atol=MICRO_GRAD_ATOL):
    """One 32^2 training step of batch 2 (`make_micro_pipeline`, the
    multi-scale L2 loss) on the CPU (plain kernels) and on the GPU, with
    `raster` in place of the pipeline's RasterizeSettings when given; exits
    unless the loss and every parameter gradient agree (MICRO_*
    tolerances; `grad_atol` of each leaf's largest entry). -> (GPU loss,
    CPU loss, gradients compared, worst
    parameter, its difference over its largest entry, the GPU step's
    launches of K1, K3 and K6)."""
    micro = {}
    for key, dev in (("cpu", torch.device("cpu")), ("gpu", DEV)):
        mp = make_micro_pipeline(batch_size=2, device=dev)
        if raster is not None:
            mp.statics.renderer.settings = raster
        mmodel = torch.nn.ModuleDict({"inferer": mp.statics.inferer,
                                      "renderer": mp.statics.renderer})
        k1.launches = k1.bwd_launches = k1.bf16_launches = 0
        mloss, _ = make_loss_fn(mp.statics, None)(mp.batch, 0)
        mloss.backward()
        micro[key] = (float(mloss.detach()),
                      {n: p.grad.detach().cpu() for n, p in mmodel.named_parameters()
                       if p.grad is not None},
                      {"K1": k1.launches, "K3": k1.bwd_launches, "K6": k1.bf16_launches})
    (closs, cgrads, _), (gloss, ggrads, launches) = micro["cpu"], micro["gpu"]
    if sorted(cgrads) != sorted(ggrads):
        raise SystemExit("32^2 step: the GPU and the CPU step have other parameter gradients")
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
    if not worst_excess <= grad_atol:
        raise SystemExit(f"32^2 step: gradient of {worst_name} differs by {worst_rel} of its "
                         f"largest entry (rtol {MICRO_GRAD_RTOL}, atol {grad_atol} of it)")
    return gloss, closs, len(cgrads), worst_name, worst_rel, launches


def variant_grads(gs, cam, settings):
    """Gradients of sum(color^2) + sum(invdepth^2) of one frame's
    rasterization with respect to (means, colors, opacities, scales,
    quats), the loss of the JAX package's bf16 gradient gate."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (gs.xyz[0], gs.colors[0], gs.opacity[0], gs.scaling[0], gs.rotation[0])]
    color, _, invd = rasterize(*leaves, cam, torch.zeros(32, device=DEV), settings,
                               channels_first=False)
    (color.square().sum() + invd.square().sum()).backward()
    return [leaf.grad for leaf in leaves]


def timed_once(fn):
    """(fn(), ms of that one call on the host clock, synchronized)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def blend_bound(rows_bytes, n_order, visited, contrib, tile=TILE):
    """K1's bound for a forward blend of the bench frame that reads
    `rows_bytes` of rows and n_order ids: (ms, what bounds it)."""
    n_bytes = (rows_bytes + n_order * 4 + ((SIZE // tile) ** 2 + 1) * 4 + 32 * 4
               + SIZE * SIZE * 34 * 4)
    ops = visited * K1_OPS_VISITED + contrib * K1_OPS_CONTRIB
    by = "operations" if ops / FP32_FLOPS > n_bytes / HBM_BYTES_PER_S else "bytes"
    return max(n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOPS) * 1e3, by, n_bytes


def raster_variants(sc, avatar, dplan, cfaces, refiner, targets, default_frames, occ):
    """Phase 11 (see the module docstring). -> the kernels-line entries of
    K6, K7, K8 and K9 (`occ`: the blends' occupancy from phase 3)."""
    variants = {"bf16": RasterizeSettings(tile=TILE, bf16_rows=True),
                "vmem": RasterizeSettings(tile=TILE, size_classes=UBODY_LADDER, vmem_classes=2),
                "stream": RasterizeSettings(tile=TILE, streaming=True)}
    bg = torch.zeros(32, device=DEV)
    img = (SIZE, SIZE, TILE)

    # 11.1 the kernels at frame 0 of the bench scene, against their plain versions and K1
    with torch.no_grad():
        gs = deform_avatar(avatar, sc.ehm, sc.faces, sc.base_body, sc.base_flame, plan=dplan,
                           compact_faces=cfaces)
        proj = project_gaussians(gs.xyz[0], gs.scaling[0], gs.rotation[0], gs.opacity[0], sc.cam)
        ranges, order = bin_gaussians(proj, SIZE, SIZE, TILE)
        rows = pack_rows(proj, gs.colors[0])
        P, N = rows.shape[0], order.shape[0]
        ref1 = k1.blend(rows, order, ranges, bg, *img)
        visited, contrib = k1_pairs(rows, order, ranges, TILE)

        L = resident_count(variants["vmem"], P)
        keys, id_bits = resident_keys(proj, SIZE, SIZE, TILE, L)
        ltable, lids = k9.gather_resident(rows, keys, id_bits)
        if not torch.equal(lids, resident_ids(proj, SIZE, SIZE, TILE, L)) or not torch.equal(
                ltable, k9.gather_rows_plain(rows, lids)):
            raise SystemExit("K9 differs from its plain version (the ranking's ids, index_select)")
        k9_plain_ms = cuda_ms(lambda: k9.gather_resident_plain(rows, keys, id_bits), reps=50)
        k9_at = k9_alone(rows, keys, id_bits)
        k9_ms, k9_lib_ms, k9_floor_ms = (k9_at[L][k] for k in ("ms", "index_select_ms",
                                                               "floor_ms"))
        k9_bytes = L * k1.ROW * 4 * 2 + L * 4
        k9_bound = k9_bytes / HBM_BYTES_PER_S * 1e3
        # where K9 runs: behind the ranking (resident_keys, whose last kernel is topk's);
        # the ranking with the ids decoded (resident_ids) and K9's int32 entry beside it
        seq_turns = turn_times({
            "ranking": lambda: resident_keys(proj, SIZE, SIZE, TILE, L),
            "ranking + K9": lambda: k9.gather_resident(
                rows, *resident_keys(proj, SIZE, SIZE, TILE, L)),
            "resident_ids": lambda: resident_ids(proj, SIZE, SIZE, TILE, L),
            "resident_ids + gather_rows": lambda: k9.gather_rows(
                rows, resident_ids(proj, SIZE, SIZE, TILE, L))}, cycles=3)
        k9_seq = {k: statistics.median(v) for k, v in seq_turns.items()}
        k9_seq_ms = k9_seq["ranking + K9"] - k9_seq["ranking"]
        # K9's added time in each turn: the ranking's and ranking + K9's i-th times
        k9_seq_adds = [a - b for a, b in zip(seq_turns["ranking + K9"], seq_turns["ranking"])]
        k9_seq_spread = {"adds_median": statistics.median(k9_seq_adds),
                         "adds_spread": least_most(k9_seq_adds),
                         **{k + " spread": least_most(v) for k, v in seq_turns.items()}}
        k9_occ = {**k9.occupancy(), "ptxas": ptxas_usage("18gather_rows_kernelILb1E")}
        say(11, f"K9 row gather: L={L} of P={P} (the first two classes of the ubody ladder), "
                f"equal to its plain version; alone, in turns with index_select and the launch "
                f"floor (medians): " + "; ".join(
                    f"L={n} kernel {v['ms']:.4f} ms ({v['ms_spread'][0]:.4f}-"
                    f"{v['ms_spread'][1]:.4f}), index_select {v['index_select_ms']:.4f}, "
                    f"floor {v['floor_ms']:.4f} ({v['floor_spread'][0]:.4f}-"
                    f"{v['floor_spread'][1]:.4f}), bound {v['bound_ms']:.5f} ({v['bytes']} B)"
                    for n, v in k9_at.items())
                + f"; plain {k9_plain_ms:.4f} ms; {k9_occ['ctas_per_sm']} CTAs an SM, ptxas: "
                  f"{k9_occ['ptxas']}")
        say(11, f"K9 in sequence (in turns, medians of 3 rounds, least-most of the 6 turns): "
                + ", ".join(f"{k} {v:.4f} ms ({min(seq_turns[k]):.4f}-{max(seq_turns[k]):.4f})"
                            for k, v in k9_seq.items())
                + f"; K9 adds {k9_seq_ms:.4f} ms behind the ranking (turn by turn: median "
                  f"{k9_seq_spread['adds_median']:.4f}, {k9_seq_spread['adds_spread'][0]:.4f}-"
                  f"{k9_seq_spread['adds_spread'][1]:.4f}); the decoded-ids path "
                  f"adds {k9_seq['resident_ids + gather_rows'] - k9_seq['ranking']:.4f} ms "
                  f"over the ranking")
        k9_edge_cases(rows)
        golden_on_card()

        order_r = remap_resident(order, lids, P)
        n_resident_inst = int((order_r >= P).sum())
        got7 = k1.forward_resident(rows, ltable, order_r, ranges, bg, *img)
        if not all(torch.equal(g, w) for g, w in zip(got7, ref1)):
            raise SystemExit("K7 differs from K1 on the same rows")
        want7, k7_plain_ms = timed_once(
            lambda: k1.blend_resident_plain(rows, ltable, order_r, ranges, bg, *img))
        err7 = max(float((g - w).abs().max()) for g, w in zip(got7, want7))
        if not err7 <= K1_TOL:
            raise SystemExit(f"K7 disagrees with its plain version: max abs {err7} > {K1_TOL}")
        k7_bound, k7_by, k7_bytes = blend_bound((P + L) * k1.ROW * 4, N, visited, contrib)
        say(11, f"K7 resident-table blend: {n_resident_inst} of {N} instances read the "
                f"{L}-row table; bit-equal to K1 on the same rows, max abs vs plain {err7:.3g} "
                f"(tol {K1_TOL}); plain {k7_plain_ms:.1f} ms (one call), bound "
                f"{k7_bound:.4f} ms by {k7_by} ({k7_bytes / 1e6:.1f} MB)")
        del want7, got7

        packed = k1.pack_rows_bf16(rows)
        unpacked = k1.unpack_rows_bf16(packed)
        got6 = k1.forward_bf16(packed, order, ranges, bg, *img)
        if not all(torch.equal(g, w) for g, w in zip(got6, k1.blend(unpacked, order, ranges, bg,
                                                                    *img))):
            raise SystemExit("K6 differs from K1 on the unpacked rows")
        want6, k6_plain_ms = timed_once(
            lambda: k1.blend_bf16_plain(packed, order, ranges, bg, *img))
        err6 = max(float((g - w).abs().max()) for g, w in zip(got6, want6))
        if not err6 <= K1_TOL:
            raise SystemExit(f"K6 disagrees with its plain version: max abs {err6} > {K1_TOL}")
        k6_vs_f32 = float((got6[0] - ref1[0]).abs().max())
        v6, c6 = k1_pairs(unpacked, order, ranges, TILE)
        k6_bound, k6_by, k6_bytes = blend_bound(P * k1.ROW_BF16 * 2, N, v6, c6)
        say(11, f"K6 bf16-row blend: rows of {k1.ROW_BF16 * 2} B; bit-equal to K1 on the unpacked "
                f"rows, max abs vs plain {err6:.3g} (tol {K1_TOL}), vs the f32 image {k6_vs_f32:.3g}; "
                f"visited pairs {v6} (f32 rows: {visited}); plain {k6_plain_ms:.1f} ms (one "
                f"call), bound {k6_bound:.4f} ms by {k6_by} ({k6_bytes / 1e6:.1f} MB)")
        del want6, got6, unpacked

        stream = stream_rows(rows, order)
        got8 = k1.forward_stream(stream, ranges, bg, *img)
        if not all(torch.equal(g, w) for g, w in zip(
                got8, k1.blend(round_colors_bf16(rows), order, ranges, bg, *img))):
            raise SystemExit("K8 differs from K1 on the rows with bf16-rounded colors")
        want8, k8_plain_ms = timed_once(lambda: k1.blend_stream_plain(stream, ranges, bg, *img))
        err8 = max(float((g - w).abs().max()) for g, w in zip(got8, want8))
        if not err8 <= K1_TOL:
            raise SystemExit(f"K8 disagrees with its plain version: max abs {err8} > {K1_TOL}")
        k8_bound, k8_by, k8_bytes = blend_bound(N * k1.ROW * 4, 0, visited, contrib)
        say(11, f"K8 stream blend: stream of {N} rows ({N * k1.ROW * 4 / 1e6:.1f} MB); bit-equal "
                f"to K1 on the rows with bf16 colors, max abs vs plain {err8:.3g} (tol {K1_TOL}); "
                f"plain {k8_plain_ms:.1f} ms (one call), bound {k8_bound:.4f} ms by {k8_by} "
                f"({k8_bytes / 1e6:.1f} MB)")
        del want8, got8, ref1

        # the four forward blends timed in turns, so that clock drift favours none
        runs = {"K1": lambda: k1.blend(rows, order, ranges, bg, *img),
                "K6": lambda: k1.forward_bf16(packed, order, ranges, bg, *img),
                "K7": lambda: k1.forward_resident(rows, ltable, order_r, ranges, bg, *img),
                "K8": lambda: k1.forward_stream(stream, ranges, bg, *img)}
        turns = {k: [] for k in runs}
        for _ in range(3):
            for k, fn in runs.items():
                turns[k].append(cuda_ms(fn))
        blend_ms = {k: statistics.median(v) for k, v in turns.items()}
        k6_ms, k7_ms, k8_ms = blend_ms["K6"], blend_ms["K7"], blend_ms["K8"]
        say(11, "forward blends at frame 0, in turns (median of 3 rounds of 10 launches): "
                + ", ".join(f"{k} {v:.4f} ms ({v / blend_ms['K1']:.3f} x K1)"
                            for k, v in blend_ms.items()))

        del packed, stream

    # 11.2 the main path under each setting: 20 frames through render_frame; the default
    # path's device operations first, which the vmem frame's are held against
    dpipe = FramePipeline(sc.ehm, sc.faces, refiner, image_size=SIZE, invtanfov=INVTANFOV,
                          settings=RasterizeSettings(tile=TILE), opacity_threshold=0.0, device=DEV)
    dav = dpipe.prepare_avatar(sc.avatar)
    dpipe.render_frame(dav, targets[0])
    frames_iter = iter(targets[:5])
    default_ops = profile_by_name(lambda: dpipe.render_frame(dav, next(frames_iter)), 5)
    del dpipe, dav
    frame_launches, frame_ms = {}, {}
    for name, st in variants.items():
        vpipe = FramePipeline(sc.ehm, sc.faces, refiner, image_size=SIZE, invtanfov=INVTANFOV,
                              settings=st, opacity_threshold=0.0, device=DEV)
        vav = vpipe.prepare_avatar(sc.avatar)
        vpipe.render_frame(vav, targets[0])          # warm-up
        torch.cuda.synchronize()
        k1.launches = k1.bf16_launches = k1.resident_launches = k1.stream_launches = 0
        k2.launches = k9.launches = 0
        t0 = time.perf_counter()
        frames = [vpipe.render_frame(vav, t) for t in targets]
        torch.cuda.synchronize()
        frame_ms[name] = (time.perf_counter() - t0) * 1e3 / N_FRAMES
        counts = {"K1": k1.launches, "K2": k2.launches, "K6": k1.bf16_launches,
                  "K7": k1.resident_launches, "K8": k1.stream_launches, "K9": k9.launches}
        kernel = {"bf16": ("K6",), "vmem": ("K7", "K9"), "stream": ("K8",)}[name]
        want = {k: (N_FRAMES if k in kernel + ("K2",) else 0) for k in counts}
        if counts != want:
            raise SystemExit(f"{name} frames: launches {counts}, expected {want}")
        frame_launches[name] = counts
        frames_iter = iter(targets[:5])
        ops = profile_by_name(lambda: vpipe.render_frame(vav, next(frames_iter)), 5)
        busy_ms, n_dev = sum(v[0] for v in ops.values()), sum(v[1] for v in ops.values())
        for out in frames:
            for k in ("render", "raw"):
                v = out[k]
                if v.shape != (SIZE, SIZE, 3) or not bool(torch.isfinite(v).all()) \
                        or float(v.min()) < 0.0 or float(v.max()) > 1.0:
                    raise SystemExit(f"{name} frames: bad {k} image {tuple(v.shape)}")
            if not bool(torch.isfinite(out["invdepth"]).all()):
                raise SystemExit(f"{name} frames: invdepth not finite")
        diff = {k: max(float((f[k] - d[k]).abs().max()) for f, d in zip(frames, default_frames))
                for k in ("render", "raw", "invdepth")}
        if name == "vmem" and (diff["raw"] or diff["invdepth"] or diff["render"] > 1e-5):
            raise SystemExit(f"vmem frames differ from the default path's: {diff}")
        busy = (f"device busy {busy_ms:.3f} ms/frame (idle share "
                f"{1 - busy_ms / frame_ms[name]:.3f}), {n_dev:.0f} device kernels a frame"
                if busy_ms > 0 else "profiler recorded no device time")
        say(11, f"{name}: {N_FRAMES} frames {SIZE}^2 through render_frame {frame_ms[name]:.2f} "
                f"ms/frame ({1e3 / frame_ms[name]:.2f} fps), {busy}; launches {counts}; max abs vs the "
                f"default path's frames: render {diff['render']:.3g}, raw {diff['raw']:.3g}, "
                f"invdepth {diff['invdepth']:.3g}")
        if name == "vmem":
            groups, rest = vmem_breakdown(default_ops, ops)
            say(11, f"vmem over the default frame (device operations by name, 5 frames each): "
                    f"{sum(v[0] for v in groups.values()):+.4f} ms, "
                    f"{sum(v[1] for v in groups.values()):+.1f} kernels a frame; "
                    + ", ".join(f"{g} {m:+.4f} ms {n:+.1f}" for g, (m, n) in groups.items())
                    + "; the rest's largest: " + "; ".join(
                        f"{k[:70]} {m:+.4f} ms {n:+.1f}" for m, n, k in rest[:10]))
            vmem_extra = {g: {"ms": m, "launches": n} for g, (m, n) in groups.items()}
        del frames, vpipe, vav

    # 11.3 a 64^2 frame under each setting, the GPU against the CPU
    small = {}
    for key, dev in (("cpu", torch.device("cpu")), ("gpu", DEV)):
        ssc = make_bench_scene(64, 64, 21, 7, device=dev)
        sref = init_params_(NeuralRefiner(64, style_dim=64, num_mlp=2, channel_scale=4.0),
                            torch.Generator().manual_seed(1))
        for name, st in variants.items():
            spipe = FramePipeline(ssc.ehm, ssc.faces, sref, image_size=64, invtanfov=INVTANFOV,
                                  settings=st._replace(tile=16), device=dev)
            small[key, name] = {k: v.cpu() for k, v in
                                spipe.render_frame(spipe.prepare_avatar(ssc.avatar),
                                                   targets[3]).items()}
    small_err = {name: max(float((small["cpu", name][k] - small["gpu", name][k]).abs().max())
                           for k in small["cpu", name]) for name in variants}
    if not max(small_err.values()) <= 1e-4:
        raise SystemExit(f"64^2 frames: GPU vs CPU max abs {small_err} > 1e-4")
    say(11, "64^2 frame on the GPU vs the CPU (plain kernels), max abs: "
            + ", ".join(f"{n} {e:.3g}" for n, e in small_err.items()) + " (tol 1e-4)")

    # 11.4 the bench frame's gradient under each setting against the default path's
    g_def = variant_grads(gs, sc.cam, RasterizeSettings(tile=TILE))
    names = ("means", "colors", "opacities", "scales", "quats")
    for name, st in variants.items():
        g_var = variant_grads(gs, sc.cam, st)
        if not all(bool(torch.isfinite(g).all()) for g in g_var):
            raise SystemExit(f"{name}: a frame gradient is not finite")
        if name == "vmem":
            worst = 0.0
            for a, b in zip(g_def, g_var):
                col_max = a.abs().amax(0)
                worst = max(worst, float(((b - a).abs().amax(0)
                                          / col_max.clamp(min=1e-30)).max()))
            if not worst <= K3_TOL:
                raise SystemExit(f"vmem frame gradient differs from the default path's by "
                                 f"{worst} of a column's largest (tol {K3_TOL})")
            say(11, f"vmem: the frame's gradient vs the default path's, worst column "
                    f"{worst:.3g} of its largest (tol {K3_TOL})")
            continue
        # the JAX package's own gates: bf16 rows tests/test_gsplat.py:740-769 (means, colors,
        # opacities), streaming :555-576 (all five, against the largest entry). The stream's
        # backward replays on the f32 rows against the image of the bf16 colors, as the JAX
        # package's does, so a small gradient may differ by more than its own size there
        stats = []
        for leaf, a, b in zip(names, g_def, g_var):
            cos = float((a * b).sum() / (a.norm() * b.norm() + 1e-30))
            rel = ((a - b).abs() / a.abs().clamp(min=1e-2)).flatten()
            p99 = float(torch.quantile(rel[:2 ** 24], 0.99))
            of_max = float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))
            stats.append(f"{leaf} cos {cos:.7f} p99 {p99:.3g} max {of_max:.3g} of its largest")
            if name == "bf16" and leaf in names[:3]:
                ok = cos > 0.9999 and p99 < 0.15
            else:
                ok = cos > 0.9999 and of_max <= 2e-2
            if not ok:
                raise SystemExit(f"{name}: frame gradient of {leaf}: cosine {cos}, 99th "
                                 f"percentile relative difference {p99}, max difference "
                                 f"{of_max} of the largest entry")
        gate = ("cosine > 0.9999 and 99th-percentile relative < 0.15 on means, colors, opacities"
                if name == "bf16" else "cosine > 0.9999 and max within 2e-2 of the largest entry")
        say(11, f"{name}: the frame's gradient vs the default path's ({gate}): "
                + "; ".join(stats))

    # 11.5 a 32^2 training step with bf16 rows, the GPU against the CPU
    gloss, closs, n_grads, worst_name, worst_rel, mlaunch = micro_step_vs_cpu(
        RasterizeSettings(tile=16, bf16_rows=True), MICRO_BF16_GRAD_ATOL)
    if (mlaunch["K6"], mlaunch["K3"], mlaunch["K1"]) != (2, 2, 0):
        raise SystemExit(f"32^2 bf16 step: launches {mlaunch}, expected K6 and K3 twice")
    say(11, f"32^2 training step of batch 2 with bf16 rows, GPU vs CPU: loss {gloss:.6f} vs "
            f"{closs:.6f} (rtol {MICRO_LOSS_RTOL}); {n_grads} gradients within rtol "
            f"{MICRO_GRAD_RTOL} + {MICRO_BF16_GRAD_ATOL} of each one's largest entry, worst "
            f"{worst_name} at {worst_rel:.3g} of its largest; launches {mlaunch}")

    # 11.6 two full-width training steps under each setting, each from the same weights
    tcfg = InfererConfig(image_size=SIZE, uvmap_size=UV, invtanfov=INVTANFOV)
    tsc = make_train_scene(SIZE, UV, BODY_SIDE, HEAD_SIDE, feat_size=FEAT, batch_size=1,
                           device=DEV)
    statics, lpips, state, loss_fn = train_setup(tsc, tcfg, TRAIN_LR)
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    first_loss = {}
    for name, st in variants.items():
        statics.renderer.settings = st
        state.model.load_state_dict(init)
        state = make_train_state(state.model, learning_rate=TRAIN_LR)
        step = make_train_step(loss_fn, state, count_scrubbed=True)
        k1.launches = k1.bwd_launches = k1.bf16_launches = k1.resident_launches = 0
        k1.stream_launches = k9.launches = 0
        losses, ms = [], []
        for _ in range(2):
            (loss, metrics), t = timed_once(lambda: step(tsc.batch))
            losses.append(float(loss))
            ms.append(t)
        counts = {"K1": k1.launches, "K3": k1.bwd_launches, "K6": k1.bf16_launches,
                  "K7": k1.resident_launches, "K8": k1.stream_launches, "K9": k9.launches}
        kernel = {"bf16": ("K6",), "vmem": ("K7", "K9"), "stream": ("K8",)}[name]
        want = {k: (2 if k in kernel + ("K3",) else 0) for k in counts}
        if counts != want or not all(math.isfinite(v) for v in losses):
            raise SystemExit(f"{name} training steps: launches {counts} (expected {want}), "
                             f"losses {losses}")
        first_loss[name] = losses[0]
        say(11, f"{name}: 2 training steps at full width, batch 1: {ms[0]:.1f}, {ms[1]:.1f} ms, "
                f"losses {losses[0]:.6f}, {losses[1]:.6f}, non-finite gradient entries zeroed "
                f"{int(metrics['scrubbed_grads'])}; launches {counts}")
    # the first step's loss is taken on the same weights under every setting
    spread = max(first_loss.values()) / min(first_loss.values()) - 1
    if not spread <= 1e-2:
        raise SystemExit(f"first-step losses under the three settings differ by {spread}: "
                         f"{first_loss}")
    del statics, lpips, state, loss_fn, tsc, init

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound, by, lib):
        return {"name": name, "route": "cuda", "source": f"guava_renderer_tpu_torch/csrc/{source}",
                "replaces": f"guava_renderer_tpu/ops/gsplat.py:{replaces}", "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": by, "library_ms": lib}

    return [
        {**entry("K6 tile blend, bf16 rows", "blend_bf16.cu", 1093, frame_launches["bf16"]["K6"],
                 err6, k6_ms, k6_plain_ms, k6_bound, k6_by, None),
         **occ["K6"], "over_k1_in_turns": k6_ms / blend_ms["K1"]},
        {**entry("K7 tile blend, resident table", "blend_resident.cu", 1227,
                 frame_launches["vmem"]["K7"], err7, k7_ms, k7_plain_ms, k7_bound, k7_by, None),
         **occ["K7"], "over_k1_in_turns": k7_ms / blend_ms["K1"]},
        {**entry("K8 tile blend, stream", "blend_stream.cu", 1350,
                 frame_launches["stream"]["K8"], err8, k8_ms, k8_plain_ms, k8_bound, k8_by, None),
         **occ["K8"], "over_k1_in_turns": k8_ms / blend_ms["K1"]},
        {**entry("K9 row gather", "gather_rows.cu", 874, frame_launches["vmem"]["K9"], 0.0,
                 k9_ms, k9_plain_ms, k9_bound, "bytes", k9_lib_ms),
         "floor_ms": k9_floor_ms, "in_sequence_ms": k9_seq_ms, "in_sequence": k9_seq,
         "in_sequence_spread": k9_seq_spread,
         "sizes": k9_at, **k9_occ, "vmem_frame_extra": vmem_extra},
    ]


def t1_bytes(name):
    """(bytes a T1 probe must move: what it copies and what it writes; whether
    it copies just the bytes it writes, as its library call moves them)."""
    at = (torch.zeros(kt1.LOOP_ROWS, dtype=torch.int32) if name == "row1_loop"
          else mosaic_probe.OFFSETS[name])
    c = kt1.plan(name, at)
    copied, written = c.n_seg * c.seg_bytes, math.prod(c.out_shape) * 4
    return copied + written, copied == written


def probe_tools(n_instances, visited, contrib, occ, frame_wide):
    """Phase 12 (see the module docstring); (visited, contrib) are the bench
    frame's pairs from phase 3, whose instance count the tools' frame must
    match, `occ` the blends' occupancy from phase 3 and `frame_wide` its
    (rows, order, ranges) binned at K1P_WIDE_TILE. -> the kernels-line
    entries of K1p, T1, T2 and T3."""
    # 12.1 the main path: the four tools, with every count at 0 just before them
    k1.probe_launches = kt1.launches = kt2.launches = kt3.launches = 0
    t0 = time.perf_counter()
    ee = ee_probe.main(["--iters", "20", "--stages"])
    dma = dma_bench.main(["--variants", T2_VARIANTS, "--iters", "20"])
    sp = sort_payload_bench.main(["--iters", "10"])
    t1 = mosaic_probe.main(["--iters", "20"])
    t1_off = mosaic_probe.main(["--iters", "20", "--unaligned", "--exp", T1_OFF_ROUTE])
    launches = {"K1p": k1.probe_launches, "T1": sum(r.get("launches", 0) for r in t1),
                "T2": kt2.launches, "T3": kt3.launches}
    tools_s = time.perf_counter() - t0
    if not all(launches.values()):
        raise SystemExit(f"probe tools: a kernel was not launched: {launches}")
    failed = [r for r in t1 + t1_off if not r["ok"]]
    if failed:
        raise SystemExit(f"T1 probes failed: {failed}")
    if not all(sp["sorted"].values()):
        raise SystemExit(f"payload sorts not sorted: {sp['sorted']}")
    say(12, f"the four tools at their defaults in {tools_s:.1f} s; launches {launches}")

    # 12.2 K1p against its plain version (one call: the last deaths give every count) and K1
    prep = ee["prep"]
    rows, order, ranges = prep.rows, prep.order, prep.ranges
    if order.shape[0] != n_instances:
        raise SystemExit(f"ee_probe's frame bins {order.shape[0]} instances, phase 3's "
                         f"{n_instances}")
    bg = torch.zeros(32, device=DEV)
    img = (SIZE, SIZE, TILE)
    with torch.no_grad():
        ref1 = k1.blend(rows, order, ranges, bg, *img)
        (*want_img, last), p_ms = timed_once(
            lambda: k1.blend_probe_plain(rows, order, ranges, bg, *img))
        errp, lines = 0.0, []
        for ch, ee_ in K1P_SETTINGS:
            *got, cnt = k1.blend_probe(rows, order, ranges, bg, *img, ch, ee_)
            want_cnt = k1.chunks_run(last, ranges, ch, ee_)
            if not torch.equal(cnt, want_cnt):
                raise SystemExit(f"K1p (chunk {ch}, exit_every {ee_}) counts differ from its "
                                 f"plain version's on {int((cnt != want_cnt).sum())} tiles")
            if not all(torch.equal(g, w) for g, w in zip(got, ref1)):
                raise SystemExit(f"K1p (chunk {ch}, exit_every {ee_}) image differs from K1's")
            errp = max(errp, *(float((g - w).abs().max()) for g, w in zip(got, want_img)))
            lines.append(f"({ch}, {ee_}) {int(cnt.sum())} of "
                         f"{int(k1.chunks_run(last, ranges, ch, 0).sum())}")
        if not errp <= K1_TOL:
            raise SystemExit(f"K1p disagrees with its plain version: max abs {errp} > {K1_TOL}")
        # K1 and K1p at (128, 1), K1's stage, and at (256, 1), the 256-row stage, in turns
        runs = {"K1": lambda: k1.blend(rows, order, ranges, bg, *img),
                "K1p/128": lambda: k1.blend_probe(rows, order, ranges, bg, *img, 128, 1),
                "K1p/256": lambda: k1.blend_probe(rows, order, ranges, bg, *img, 256, 1)}
        turns = {k: [] for k in runs}
        for _ in range(3):
            for k, fn in runs.items():
                turns[k].append(cuda_ms(fn))
        k1_ms, kp_ms, kp256_ms = (statistics.median(turns[k]) for k in runs)
        kp_bound, kp_by, kp_bytes = blend_bound(rows.shape[0] * k1.ROW * 4, order.shape[0],
                                                visited, contrib)
        n_tiles_exit = int((k1.chunks_run(last, ranges, 32, 1)
                            < k1.chunks_run(last, ranges, 32, 0)).sum())
        say(12, f"K1p: counts equal to the plain version's and the image bit-equal to K1's at "
                f"every (chunk, exit_every); rounds run of total: {', '.join(lines)}; tiles that "
                f"exit early at (32, 1): {n_tiles_exit} of {ranges.numel() - 1}; max abs vs plain "
                f"{errp:.3g} (tol {K1_TOL}); in turns (median of 3 rounds of 10) K1 {k1_ms:.4f} "
                f"ms, K1p (128, 1) {kp_ms:.4f} ms ({kp_ms / k1_ms:.3f} x K1), K1p (256, 1) "
                f"{kp256_ms:.4f} ms ({kp256_ms / k1_ms:.3f} x K1); plain {p_ms:.1f} ms (one "
                f"call), bound {kp_bound:.4f} ms by {kp_by}")
        del ref1, want_img, got

        # K1p at tile 8, the rounds longer than the CTA: counts and image as at tile 32
        rows_w, order_w, ranges_w = frame_wide
        img_w = (SIZE, SIZE, K1P_WIDE_TILE)
        ref_w = k1.blend(rows_w, order_w, ranges_w, bg, *img_w)
        *_, last_w = k1.blend_probe_plain(rows_w, order_w, ranges_w, bg, *img_w)
        for ch, ee_ in K1P_WIDE_SETTINGS:
            *got, cnt = k1.blend_probe(rows_w, order_w, ranges_w, bg, *img_w, ch, ee_)
            want_cnt = k1.chunks_run(last_w, ranges_w, ch, ee_)
            if not torch.equal(cnt, want_cnt):
                raise SystemExit(f"K1p at tile {K1P_WIDE_TILE} (chunk {ch}, exit_every {ee_}) "
                                 f"counts differ from its plain version's on "
                                 f"{int((cnt != want_cnt).sum())} tiles")
            if not all(torch.equal(g, w) for g, w in zip(got, ref_w)):
                raise SystemExit(f"K1p at tile {K1P_WIDE_TILE} (chunk {ch}, exit_every {ee_}) "
                                 f"image differs from K1's")
        say(12, f"K1p at tile {K1P_WIDE_TILE} ({order_w.numel()} instances, "
                f"{k1.subtile_geometry(SIZE, SIZE, K1P_WIDE_TILE).threads} threads a CTA) at "
                f"{', '.join(map(str, K1P_WIDE_SETTINGS))}: counts equal to the plain version's "
                f"on all {ranges_w.numel() - 1} tiles and the image bit-equal to K1's")
        del ref_w, last_w, got

    # 12.3 T2: every variant against its plain version, its staged rows against index_select
    table, idx2d = dma_bench.build(dma[0]["rows"], dma[0]["p_rows"], DEV)
    idx = idx2d.reshape(-1)
    t2 = []
    for res in dma:
        name, banks, n = res["name"], res["banks"], res["rows"]
        t = kt2.variant_table(table, name)
        want, _ = kt2.row_copy_plain(t, idx, name, n)
        got = res["value"]
        rel = abs(got - float(want)) / abs(float(want))
        if not rel <= T2_RTOL:
            raise SystemExit(f"T2 {name}:{banks} gives {got}, its plain version {float(want)}")
        _, staged = kt2.row_copy(t, idx, name, banks, n, check=True)
        ids = kt2.staged_ids(name, idx, n)
        if not torch.equal(staged, torch.index_select(t, 0, ids)):
            raise SystemExit(f"T2 {name}:{banks}: staged rows differ from index_select's")
        plain_ms = cuda_ms(lambda: kt2.row_copy_plain(t, idx, name, n), reps=3, warmup=0)
        lib_ms = cuda_ms(lambda: torch.index_select(t, 0, ids), reps=20)
        summed_ms = cuda_ms(lambda: kt2.row_copy(t, idx, name, banks, n), reps=20)
        # a row the ids name twice need be read once: contig reads 32,768 distinct rows,
        # the random ids ~63% of the table
        distinct = int(torch.unique(ids).numel())
        bound = distinct * res["row_bytes"] / HBM_BYTES_PER_S * 1e3
        t2.append({"name": name, "banks": banks, "rows": n, "row_bytes": res["row_bytes"],
                   "distinct_rows": distinct, "ms": res["ms"], "ns_row": res["ns_row"],
                   "gbps": res["gbps"],
                   "with_sum_ms": summed_ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "library_ms": lib_ms, "max_abs_err": abs(got - float(want))})
        del staged
    # the yardsticks: the rows variant on a permutation of the table (each row from memory
    # once) and on ids over its first HOT_ROWS rows (L2 hits after the first read), each
    # checked as the variants are, then timed in turns with the rows variant on the tool's ids
    n_rows, p_rows = dma[0]["rows"], dma[0]["p_rows"]
    t = kt2.variant_table(table, "rows")
    yard_ids = dma_bench.yardstick_ids(n_rows, p_rows, DEV)
    for key, yid in yard_ids.items():
        want, _ = kt2.row_copy_plain(t, yid, "rows", n_rows)
        got, staged = kt2.row_copy(t, yid, "rows", 1, n_rows, check=True)
        if not abs(float(got) - float(want)) <= T2_RTOL * abs(float(want)):
            raise SystemExit(f"T2 rows:1 on {key} gives {float(got)}, its plain version "
                             f"{float(want)}")
        if not torch.equal(staged, torch.index_select(t, 0, yid.long())):
            raise SystemExit(f"T2 rows:1 on {key}: staged rows differ from index_select's")
        del staged
    yard_ms = in_turns({"rows": lambda: kt2.row_copy(t, idx, "rows", 1, n_rows, total=False),
                        **{key: (lambda yid=yid: kt2.row_copy(t, yid, "rows", 1, n_rows,
                                                              total=False))
                           for key, yid in yard_ids.items()}})
    staged_bytes = n_rows * t.element_size() * 128
    yard_tbps = {k: staged_bytes / v / 1e9 for k, v in yard_ms.items()}
    # a linear model of the random ids' time: each distinct row a read from memory at the
    # perm rate, each repeat an L2 hit with probability h at the hot rate (hot's own first
    # reads taken out): h = (perm - rows) / (repeats / n (perm - hits))
    repeats = n_rows - t2[[v["name"] for v in t2].index("rows")]["distinct_rows"]
    hot_first = int(torch.unique(yard_ids["hot"]).numel()) / n_rows
    hits_ms = (yard_ms["hot"] - hot_first * yard_ms["perm"]) / (1 - hot_first)
    l2_share = (yard_ms["perm"] - yard_ms["rows"]) / (repeats / n_rows
                                                      * (yard_ms["perm"] - hits_ms))
    for v in t2:
        v["yardstick"] = "hot" if v["name"].startswith("contig") else "perm"
        v["staged_tbps"] = v["rows"] * v["row_bytes"] / v["ms"] / 1e9
        v["of_bound"] = v["bound_ms"] / v["ms"]
        v["of_yardstick"] = v["staged_tbps"] / yard_tbps[v["yardstick"]]
    t2_occ = {"ptxas": ptxas_usage("15row_copy_kernel"),
              "ctas_per_sm": {"pipelined": kt2.occupancy(True)["ctas_per_sm"],
                              "one slot": kt2.occupancy(False)["ctas_per_sm"]}}
    yardsticks = {k: {"ms": yard_ms[k], "staged_tbps": yard_tbps[k]} for k in yard_ms}
    say(12, f"T2 yardsticks (rows:1, measured, in turns; medians): " + ", ".join(
            f"{k} {yard_ms[k]:.4f} ms ({yard_tbps[k]:.2f} TB/s staged)" for k in yard_ms)
            + f"; perm reads every row once (bound {staged_bytes / HBM_BYTES_PER_S * 1e3:.4f} "
              f"ms), hot {HOT_ROWS} rows; the random ids repeat {repeats} reads, of which the "
              f"linear model puts {l2_share:.2f} in L2; each variant's staged rate over its "
              f"yardstick's and its share of its bound: " + ", ".join(
                f"{v['name']}:{v['banks']} {v['staged_tbps']:.2f} TB/s, {v['of_yardstick']:.3f} "
                f"of {v['yardstick']}, {v['of_bound']:.3f} of its bound" for v in t2)
            + f"; {t2_occ['ctas_per_sm']} CTAs an SM, ptxas: {t2_occ['ptxas']}")
    say(12, f"T2 row gather, {dma[0]['rows']} rows, each equal to its plain version (rtol "
            f"{T2_RTOL}) with its staged rows equal to index_select's; the copies alone, then "
            f"with the in-order sum: "
            + "; ".join(f"{v['name']}:{v['banks']} {v['ms']:.4f} ms {v['ns_row']:.4f} ns/row "
                        f"{v['gbps']:.0f} GB/s, {v['with_sum_ms']:.4f} ms (bound "
                        f"{v['bound_ms']:.4f} by {v['distinct_rows']} distinct rows, "
                        f"index_select {v['library_ms']:.4f}, plain "
                        f"{v['plain_ms']:.1f})" for v in t2))
    del table, idx2d, idx, t, yard_ids

    # 12.4 T3 against table.sum(0)
    st = sp["stream"]
    tab, out3 = st["table"], st["out"]
    lib3 = tab.sum(0, keepdim=True)
    rel3 = float(((out3 - lib3).abs() / lib3.abs()).max())
    if not rel3 <= T3_RTOL:
        raise SystemExit(f"T3 disagrees with table.sum(0): relative {rel3} > {T3_RTOL}")
    ref64 = tab.double().sum(0, keepdim=True)
    rel64 = float(((out3.double() - ref64).abs() / ref64.abs()).max())
    del ref64
    if not rel64 <= T3_F64_RTOL:
        raise SystemExit(f"T3 disagrees with the float64 sum: relative {rel64} > {T3_F64_RTOL}")
    t3_plain_ms = cuda_ms(lambda: kt3.stream_sum_plain(tab))
    t3_lib_ms = cuda_ms(lambda: tab.sum(0, keepdim=True))
    t3_bound = st["bytes"] / HBM_BYTES_PER_S * 1e3
    d = sp["decision"]
    say(12, f"T3 block stream: {tab.shape[0]} rows ({st['bytes'] / 1e6:.1f} MB), relative "
            f"{rel3:.3g} of table.sum(0) (tol {T3_RTOL}), {rel64:.3g} of the float64 sum (tol "
            f"{T3_F64_RTOL}); kernel {st['ms']:.4f} ms "
            f"({st['bytes'] / st['ms'] / 1e9:.2f} TB/s), plain {t3_plain_ms:.4f} ms, "
            f"table.sum(0) {t3_lib_ms:.4f} ms, bound {t3_bound:.4f} ms; sorts "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in sp["sorts"].items())
            + f"; decision: payload {d['payload_ms']:.4f} ms vs gather {d['gather_ms']:.4f} ms "
              f"at {d['gather_ns_row']:.4f} ns/row")
    err3 = float((out3 - lib3).abs().max())
    t3_ms = st["ms"]
    del tab, out3, lib3, st, sp["stream"]

    # T1: the probes' own lines carry their numbers (each probe and its library call in turns)
    probes = []
    for r in t1 + t1_off:
        bound_bytes, same_data = t1_bytes(r["name"])
        probes.append({"name": r["name"], "route": r["route"], "launches": r["launches"],
                       "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                       "library_ms": r["library_ms"], "over_library": r["ms"] / r["library_ms"],
                       "floor_ms": r["floor_ms"],
                       "bytes": r["bytes"], "library_bytes": r["library_bytes"],
                       "same_data_bytes": same_data,
                       "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3})
    say(12, f"T1 copy probes, aligned then {T1_OFF_ROUTE} off alignment, one at a time, each "
            "equal to its plain version; each in turns with its library call and the launch "
            "floor (probe, library, floor, floor, library, probe, twice; medians): "
            + "; ".join(f"{p['name']} {p['route']} {p['ms']:.4f} ms, library {p['library_ms']:.4f} "
                        f"({p['over_library']:.3f} x; moves {p['bytes']} B against "
                        f"{p['library_bytes']} B{', the same data' if p['same_data_bytes'] else ''}"
                        f"), floor {p['floor_ms']:.4f}, plain {p['plain_ms']:.4f}"
                        for p in probes))

    def entry(name, source, replaces, key, err, ms, plain_ms, bound, by, lib, **extra):
        return {"name": name, "route": "cuda", "source": f"guava_renderer_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[key], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": lib,
                **extra}

    main_probes = probes[:len(t1)]
    return [
        entry("K1p tile blend with round counts (128, 1)", "blend_probe.cu",
              "guava_renderer_tpu/ops/gsplat.py:1714", "K1p", errp, kp_ms, p_ms, kp_bound, kp_by,
              None, over_k1_in_turns=kp_ms / k1_ms, ms_256=kp256_ms,
              over_k1_in_turns_256=kp256_ms / k1_ms,
              occupancy={k: occ[k] for k in ("K1p/128", "K1p/256")},
              ee_variants=ee["variants"]),
        entry("T1 copy probes (sum of the seven)", "copy_probe.cu", "tools/mosaic_probe.py:44",
              "T1", max(p["max_abs_err"] for p in probes),
              sum(p["ms"] for p in main_probes), sum(p["plain_ms"] for p in main_probes),
              sum(p["bound_ms"] for p in main_probes), "bytes",
              sum(p["library_ms"] for p in main_probes), probes=probes),
        entry("T2 row-gather bench (sum of the variants)", "dma_bench.cu",
              "tools/dma_bench.py:128", "T2", max(v["max_abs_err"] for v in t2),
              sum(v["ms"] for v in t2), sum(v["plain_ms"] for v in t2),
              sum(v["bound_ms"] for v in t2), "bytes", sum(v["library_ms"] for v in t2),
              variants=t2, yardsticks=yardsticks, l2_share_of_repeats=l2_share, **t2_occ),
        entry("T3 block stream", "stream_sum.cu", "tools/sort_payload_bench.py:133", "T3", err3,
              t3_ms, t3_plain_ms, t3_bound, "bytes", t3_lib_ms, sorts_ms=sp["sorts"], decision=d),
    ]


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
        k2_turns = in_turns({
            "K2": lambda: k2.face_gather(table, ids),
            "table[ids].T": lambda: table[ids].T.contiguous(),
            "launch floor": mosaic_probe.launch_floor}, cycles=3)
        k2_ms, k2_lib_ms, k2_floor_ms = (k2_turns[k] for k in k2_turns)
        k2_plain_ms = cuda_ms(lambda: k2.face_gather_plain(table, ids))
        n_tex, n_faces = ids.shape[0], table.shape[0]
        k2_bytes = 16 * n_tex * 4 + n_tex * 4 + n_faces * 16 * 4
        k2_bound = k2_bytes / HBM_BYTES_PER_S * 1e3
        k2_occ = {**k2.occupancy(), "ptxas": ptxas_usage("18face_gather_kernelILb1E")}
        ids_cpu = ids.cpu()
        run_ids = ids_cpu[: n_tex // 4 * 4].reshape(-1, 4)
        distinct = 1 + int((run_ids[:, 1:] != run_ids[:, :-1]).sum()) / run_ids.shape[0]
        say(3, f"K2 face gather: N={n_tex} Fc={n_faces}, {distinct:.3f} distinct ids a thread's "
               f"4 texels; equal to plain (max abs {err2}); in turns (K2, table[ids].T, launch "
               f"floor, then back, three times; medians) kernel {k2_ms:.4f} ms, table[ids].T "
               f"{k2_lib_ms:.4f} ms, launch floor {k2_floor_ms:.4f} ms; plain "
               f"{k2_plain_ms:.4f} ms; bound {k2_bound:.4f} ms ({k2_bytes / 1e6:.2f} MB), "
               f"{k2_bound / k2_ms:.3f} of it reached; {k2_occ['ctas_per_sm']} CTAs an SM, "
               f"ptxas: {k2_occ['ptxas']}")
        k2_edge_cases()

        # K4 (the gather's backward) on the same plan: a seeded (16, N) gradient
        seg = dplan.segment_starts
        drows = torch.randn((16, n_tex), generator=torch.Generator().manual_seed(4)).to(DEV)
        got4 = k2.face_gather_bwd(drows, ids, seg, n_faces)
        again4 = k2.face_gather_bwd(drows, ids, seg, n_faces)
        model4 = k2.face_gather_bwd_windowed_plain(drows, ids, seg, n_faces)
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
        if not torch.equal(got4, again4):
            raise SystemExit("K4 gives other bits on a second launch")
        if not torch.equal(got4, model4):
            raise SystemExit(f"K4 differs from its windowed plain model: max abs "
                             f"{float((got4 - model4).abs().max())}")
        del again4, model4
        k4_plain_ms = cuda_ms(lambda: k2.face_gather_bwd_plain(drows, ids, n_faces))
        ids64 = ids.long()
        k4_turns = in_turns({
            "K4": lambda: k2.face_gather_bwd(drows, ids, seg, n_faces),
            "index_add_": lambda: torch.zeros((n_faces, 16), device=DEV).index_add_(0, ids64,
                                                                                    drows.T)},
            cycles=3)
        k4_ms, k4_lib_ms = k4_turns["K4"], k4_turns["index_add_"]
        k4_bytes = 16 * n_tex * 4 + n_tex * 4 + n_faces * 16 * 4
        k4_bound = k4_bytes / HBM_BYTES_PER_S * 1e3
        seg_len = (seg[1:] - seg[:-1]).cpu()
        ids_cpu = ids.cpu()
        k4_windows = -(-n_tex // k2.WINDOW)
        edges = torch.arange(k2.WINDOW, n_tex, k2.WINDOW)
        crossing = ids_cpu[edges][ids_cpu[edges] == ids_cpu[edges - 1]]
        k4_carry_faces = int(torch.unique(crossing).numel())
        dummy_windows = int((seg[-1] - 1) // k2.WINDOW - seg[-2] // k2.WINDOW + 1)
        say(3, f"K4 face gather backward: N={n_tex} Fc={n_faces}, segments of mean "
               f"{float(seg_len[:-1].float().mean()):.2f} texels, median "
               f"{int(seg_len[:-1].median())}, longest real {int(seg_len[:-1].max())}, the "
               f"dummy face's {int(seg_len[-1])} over {dummy_windows} windows; {k4_windows} "
               f"windows of {k2.WINDOW} texels, {k4_carry_faces} faces cross a window edge "
               f"(the second launch sums them); {k2.BWD_LAUNCHES} launches a call; max abs vs "
               f"plain on the card {err4:.3g} (held to {K4_TOL} of a segment's sum of |drows|: "
               f"index_add_ adds atomically in any order; the same against plain on the CPU), "
               f"bit-equal to a second launch and to the windowed plain model; in turns (K4, "
               f"index_add_, index_add_, K4, three times; medians) kernel {k4_ms:.4f} ms, "
               f"zeros.index_add_ {k4_lib_ms:.4f} ms "
               f"({k4_ms / k4_lib_ms:.3f} x), plain {k4_plain_ms:.4f} ms, bound "
               f"{k4_bound:.4f} ms ({k4_bytes / 1e6:.2f} MB)")
        k4_edge_cases()

        gs = deform_avatar(avatar, sc.ehm, sc.faces, sc.base_body, sc.base_flame,
                           plan=dplan, compact_faces=cfaces)
        proj = project_gaussians(gs.xyz[0], gs.scaling[0], gs.rotation[0], gs.opacity[0], sc.cam)
        ranges, order = bin_gaussians(proj, SIZE, SIZE, TILE)
        rows = pack_rows(proj, gs.colors[0])
        frame_wide = (rows, *reversed(bin_gaussians(proj, SIZE, SIZE, K1P_WIDE_TILE)))
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

        # K1 at tile 32 and on a tile-16 binning of the same frame, each within K1_TOL of
        # blend_plain at its tile; the cull's counts from its plain version, per sub-tile and
        # per warp (the kernels'); the forward blends' and K3's registers and occupancy
        geo = k1.subtile_geometry(SIZE, SIZE, TILE)
        occ = k1.occupancy(TILE)
        ptxas = {"K1": ptxas_usage("16blend_fwd_kernel", "9PlainRows", "10EveryRound"),
                 "K3": ptxas_usage("16blend_bwd_kernel"),
                 "K7": ptxas_usage("16blend_fwd_kernel", "12ResidentRows"),
                 "K6": ptxas_usage("16blend_fwd_kernel", "14PackedBf16Rows"),
                 "K8": ptxas_usage("16blend_fwd_kernel", "10StreamRows"),
                 "K1p/128": ptxas_usage("16blend_fwd_kernel", "9PlainRows", "11ProbeRounds"),
                 "K1p/256": ptxas_usage("16blend_fwd_kernel", "12PlainRows256")}
        say(3, f"forward blends and K3 on sub-tile CTAs at tile {TILE}: {geo.n_ctas} CTAs of "
               f"{geo.threads} threads ({geo.side}^2 pixels, {geo.per_tile} a bin tile); dynamic "
               f"shared memory a CTA: " + ", ".join(f"{k} {occ[k]['smem_bytes']} B" for k in ptxas)
               + "; resident CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor): "
               + ", ".join(f"{k} {occ[k]['ctas_per_sm']}" for k in ptxas) + "; ptxas: "
               + "; ".join(f"{k} {v}" for k, v in ptxas.items()))
        at_tiles = {}
        for tile_w in (TILE, 16):
            if tile_w == TILE:
                r_w, o_w, v_w, c_w, err_w, ms_w = ranges, order, visited, contrib, err1, k1_ms
            else:
                r_w, o_w = bin_gaussians(proj, SIZE, SIZE, tile_w)
                v_w, c_w = k1_pairs(rows, o_w, r_w, tile_w)
                got_w = k1.blend(rows, o_w, r_w, bg, SIZE, SIZE, tile_w)
                want_w = k1.blend_plain(rows, o_w, r_w, bg, SIZE, SIZE, tile_w)
                err_w = max(float((g - w).abs().max()) for g, w in zip(got_w, want_w))
                if not err_w <= K1_TOL:
                    raise SystemExit(f"tile {tile_w}: K1 disagrees with its plain version: max "
                                     f"abs {err_w} > {K1_TOL}")
                del got_w, want_w
                ms_w = cuda_ms(lambda: k1.blend(rows, o_w, r_w, bg, SIZE, SIZE, tile_w))
            keep = k1.cull_keep_plain(rows, o_w, r_w, SIZE, SIZE, tile_w, level="subtile")
            keep_w = k1.cull_keep_plain(rows, o_w, r_w, SIZE, SIZE, tile_w)
            w_bound, w_by, _ = blend_bound(P * k1.ROW * 4, o_w.numel(), v_w, c_w, tile_w)
            at_tiles[tile_w] = {"ms": ms_w, "max_abs_err": err_w, "bound_ms": w_bound,
                                "instances": o_w.numel(), "staged": keep.numel(),
                                "kept": int(keep.sum()), "warp_pairs": keep_w.numel(),
                                "warp_pairs_kept": int(keep_w.sum())}
            say(3, f"K1 at tile {tile_w} ({o_w.numel()} instances, visited pairs {v_w}, "
                   f"contributing {c_w}): max abs vs plain {err_w:.3g} (tol {K1_TOL}); kernel "
                   f"{ms_w:.4f} ms, bound {w_bound:.4f} ms by {w_by}; cull over the full ranges "
                   f"(before any sub-tile stops): of {keep.numel()} rows the sub-tiles stage, "
                   f"{int(keep.sum())} reach their sub-tile "
                   f"({int(keep.sum()) / max(keep.numel(), 1):.4f}); of {keep_w.numel()} (row, "
                   f"warp) pairs, the warps walk {int(keep_w.sum())} "
                   f"({int(keep_w.sum()) / max(keep_w.numel(), 1):.4f})")
            del keep, keep_w

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
        args5 = (bins.tris, bins.inst_fid, bins.ranges, SIZE, SIZE, MESH_TILE)
        got5 = k5.mesh_zbuffer(*args5)
        want5 = k5.mesh_zbuffer_plain(*args5)
        cull5 = {}
        model5 = k5.mesh_zbuffer_split_plain(*args5, stats=cull5)
        torch.cuda.synchronize()
        hit = want5[0] >= 0
        if not (torch.equal(model5[0], want5[0]) and torch.equal(model5[1], want5[1])):
            raise SystemExit("the split model of K5 differs from mesh_zbuffer_plain")
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
        k5_ms = cuda_ms(lambda: k5.mesh_zbuffer(*args5), reps=20)
        n_inst = bins.inst_fid.shape[0]
        mesh_counts = (bins.ranges[1:] - bins.ranges[:-1]).cpu()
        starts = bins.ranges[:-1].cpu()
        split_tiles = int(((mesh_counts > 0)
                           & ((starts + mesh_counts - 1) // k5.SEGMENT > starts // k5.SEGMENT)).sum())
        k5_plain_reps = 3   # the plain z-buffer steps through the busiest tile's run
        k5_plain_ms = cuda_ms(lambda: k5.mesh_zbuffer_plain(*args5), reps=k5_plain_reps, warmup=1)
        k5_pairs = n_inst * MESH_TILE * MESH_TILE
        k5_bytes = (bins.tris.numel() + n_inst + bins.ranges.numel() + 2 * SIZE * SIZE) * 4
        k5_ops = k5_pairs * K5_OPS_PAIR + n_inst * K5_OPS_INSTANCE
        k5_bound = max(k5_bytes / HBM_BYTES_PER_S, k5_ops / FP32_FLOPS) * 1e3
        k5_bound_by = "operations" if k5_ops / FP32_FLOPS > k5_bytes / HBM_BYTES_PER_S else "bytes"
        k5_occ = {**k5.occupancy(MESH_TILE),
                  "ptxas": ptxas_usage("19mesh_zbuffer_kernelILi256E"),
                  "ptxas_merge": ptxas_usage("25mesh_zbuffer_merge_kernel")}
        say(3, f"K5 mesh z-buffer: F={sc.faces.shape[0]} instances={n_inst} "
               f"busiest tile={int(mesh_counts.max())} max tiles a face="
               f"{int(bins.tiles_per_face.max())} hit pixels={float(hit.float().mean()):.4f}; "
               f"best instance and face_idx equal to plain and to the split model, depth max abs "
               f"{err5:.3g} (tol {K5_DEPTH_TOL}); segments of "
               f"{k5.SEGMENT}: {int((mesh_counts > 0).sum())} non-empty tiles, {split_tiles} split; "
               f"{k5.LAUNCHES} launches a call; cull (split model): of {cull5['warp_pairs']} "
               f"(instance, warp) pairs the warps walk {cull5['warp_pairs_walked']} "
               f"({cull5['warp_pairs_walked'] / max(cull5['warp_pairs'], 1):.4f}), of their "
               f"{cull5['pairs_walked']} (instance, pixel) pairs {cull5['pairs_divided']} divide "
               f"({cull5['pairs_divided'] / max(k5_pairs, 1):.4f} of the {k5_pairs} tile-run pairs)"
               f"; kernel {k5_ms:.4f} ms (median of 20), plain {k5_plain_ms:.2f} ms (median of {k5_plain_reps}), bound "
               f"{k5_bound:.4f} ms by {k5_bound_by} ({k5_ops / 1e9:.3f} GFLOP over {k5_pairs} "
               f"pairs, {k5_bytes / 1e6:.2f} MB); {k5_occ['ctas_per_sm']} CTAs an SM, "
               f"{k5_occ['smem_bytes']} B shared; ptxas: {k5_occ['ptxas']}; merge: "
               f"{k5_occ['ptxas_merge']}")
        k5_edge_cases()
    del got1, want1, got2, want2, got5, want5, model5, got4, want4, want4_cpu, drows, color1, invd1, final_t1

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
    if create_launches != N_CREATIONS * k5.LAUNCHES or k1.launches or k2.launches:
        raise SystemExit(f"{N_CREATIONS} creations launched K5 {create_launches} times, "
                         f"K1 {k1.launches}, K2 {k2.launches}: expected one K5 call "
                         f"({k5.LAUNCHES} launches) a creation")
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
    # a step calls K1 and K5 once an item; the closing validation adds one of each
    if train_launches != {"K1": n_steps + 1, "K3": n_steps,
                          "K5": (n_steps + 1) * k5.LAUNCHES}:
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
    if accum_launches != {"K1": 2, "K3": 2, "K5": 2 * k5.LAUNCHES} \
            or not math.isfinite(float(loss2)):
        raise SystemExit(f"accumulated step of batch 2: launches {accum_launches}, loss "
                         f"{float(loss2)}")
    say(8, f"one accumulated step of batch 2: {accum_ms:.1f} ms, loss {float(loss2):.4f}, "
           f"launches {accum_launches}, non-finite gradient entries zeroed "
           f"{int(metrics2['scrubbed_grads'])}")
    del statics, lpips, state, loss_fn, step1, tsc, tsc2

    # ---- 9. a 32^2 training step: the GPU path against the CPU path ----
    gloss, closs, n_grads, worst_name, worst_rel, micro_launches = micro_step_vs_cpu()
    micro_k3 = micro_launches["K3"]
    if micro_k3 != 2:
        raise SystemExit(f"32^2 step: K3 launched {micro_k3} times for a batch of 2")
    say(9, f"32^2 training step of batch 2 on the GPU vs the CPU (plain kernels): loss {gloss:.6f} "
           f"vs {closs:.6f} (rtol {MICRO_LOSS_RTOL}); {n_grads} parameter gradients within "
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
    if planned_launches != {"K2": 1, "K4": k2.BWD_LAUNCHES}:
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

    # ---- 11. the raster variants ----
    variant_kernels = raster_variants(sc, avatar, dplan, cfaces, refiner, targets, seq, occ)

    # ---- 12. the probe tools ----
    t12 = time.perf_counter()
    probe_kernels = probe_tools(N, visited, contrib, occ, frame_wide)
    say(12, f"phase 12 in {time.perf_counter() - t12:.1f} s")

    kernels = [
        {"name": "K1 tile blend", "route": "cuda",
         "source": "guava_renderer_tpu_torch/csrc/blend.cu",
         "replaces": "guava_renderer_tpu/ops/gsplat.py:1018", "launches": launches["K1"],
         "max_abs_err": err1, "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_bound_by, "library_ms": None, **occ["K1"], "at_tiles": at_tiles},
        {"name": "K2 face gather", "route": "cuda",
         "source": "guava_renderer_tpu_torch/csrc/facegather.cu",
         "replaces": "guava_renderer_tpu/ops/facegather.py:125", "launches": launches["K2"],
         "max_abs_err": err2, "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": k2_lib_ms, "floor_ms": k2_floor_ms, **k2_occ},
        {"name": "K3 tile blend backward", "route": "cuda",
         "source": "guava_renderer_tpu_torch/csrc/blend_bwd.cu",
         "replaces": "guava_renderer_tpu/ops/gsplat.py:1457", "launches": train_launches["K3"],
         "max_abs_err": err3, "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_bound_by, "library_ms": None, **occ["K3"]},
        {"name": "K4 face gather backward", "route": "cuda",
         "source": "guava_renderer_tpu_torch/csrc/facegather_bwd.cu",
         "replaces": "guava_renderer_tpu/ops/facegather.py:143",
         "launches": planned_launches["K4"], "max_abs_err": err4, "ms": k4_ms,
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": "bytes",
         "library_ms": k4_lib_ms},
        {"name": "K5 mesh z-buffer", "route": "cuda",
         "source": "guava_renderer_tpu_torch/csrc/meshraster.cu",
         "replaces": "guava_renderer_tpu/ops/meshraster.py:39",
         "launches": create_launches + train_launches["K5"] + accum_launches["K5"],
         "max_abs_err": err5, "ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound,
         "bound_by": k5_bound_by, "library_ms": None, "model_cull": cull5,
         **k5_occ},
        *variant_kernels,
        *probe_kernels,
    ]
    if not all(math.isfinite(k[f]) for k in kernels for f in ("ms", "plain_ms", "bound_ms")):
        raise SystemExit(f"non-finite timing in {kernels}")
    # the card again, beside the numbers that follow (the head of a long log may be cut)
    say("done", f"{time.perf_counter() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
