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
     CPU (the raster's outputs, then the float32 frame through a refiner at
     gain P7_REFINER_GAIN, held to P7_FRAME_TOL, with a third pass under
     TF32 that the hold must see);
  8. the training step at full width: 3 warm-up and 5 timed steps of batch 1
     through `train_on_batches` (creation, deform, 32-channel rasterization
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
     with the bytes each must move;
 13. the config-driven runtime at the widths of configs/train/ubody_512.yaml
     (build_runtime with synthetic assets, init_params seed 0,
     FramePipeline.from_runtime): one creation from a seeded 518^2 image,
     then 20 frames under each of four refiner settings (the config as it
     stands, bf16_refiner, refiner_type simpleunet, image_size 720 refined
     at 512), with launch counts and ms/frame on the host clock and device
     busy; the bf16 render against the f32 one; each setting at micro
     widths on the GPU against the CPU; then `python3 bench_torch.py
     --frames 20 --repeats 3` in a subprocess, whose JSON line is printed;
 14. the data layer and the config-driven trainer: the record store and the
     image codec built with g++ (the store's native backend; the codec's
     files and decodes byte-equal to the CPU build's); `run_training` on
     micro_synthetic.yaml for 2 iterations on the card and on the CPU from
     one port checkpoint at the config's learning rate (loader batches
     bit-equal, losses and validation PSNR within MICRO_LOSS_RTOL, SSIM within
     MICRO_SSIM_RTOL), and on the card with TF32 forced on, which they must see;
     the teacher tool at teacher512_synthetic.yaml
     (2 videos x 8 frames at 512^2); two steps of one sample from the
     flax-scale init; then `python -m guava_renderer_tpu_torch.cli.train`
     in a subprocess at those widths (batch 6 by per-sample accumulation,
     remat) from a port checkpoint of a gain-0.5 init: 1 warm-up, 1
     profiled (a torch.profiler window) and 3 timed iterations, validation,
     checkpoints and a visual grid; then a resume from `latest`; then a
     witness for the run's local_xyz regulariser: the run's iterations but
     its last replayed in this process from the basemodel, the term on each
     of the run's batches (in the loader's order) from the basemodel's, the
     replay's and `latest`'s weights on the card, and the largest
     recomputed from the CPU's inputs by the CPU's inferer in float32 and
     float64 and by the card's (within WITNESS_FACTOR of the CPU's float32
     error from float64). It prints ms/step, the loader's wait a step, the
     loader's ms a batch alone, the H2D ms of a pinned batch, device busy
     and the idle share, and the K1, K3 and K5 launches a step;
 15. the inference drivers and their entry points at those widths, on phase 14's
     teacher512 dataset and run directory (its checkpoints and config snapshot):
     `python -m guava_renderer_tpu_torch.cli.test` in a subprocess (the timed
     self-reenactment: PNGs, avatar.ply, the side-by-side MP4 read back,
     speed_info.json under the creation limit, K5 twice a creation and K1 and K2
     once a frame), then in this process through their `main`: cross-reenactment
     and 120 static novel views, convert_motion and resample_motion on an
     EMAGE-style track, create_avatar, render_motion at 512^2 and 1024^2 (the
     refiner at 512^2), metrics on the self-reenactment's dumps, one generation
     through the app service polled every 50 ms (the video only with its job
     done), and cli.test on micro_synthetic.yaml on the card against the CPU
     from one seed-0 checkpoint (PNGs within SMALL_CREATE_TOL x 255 + 1 levels).
     It prints ms/creation and fps beside phases 6 and 4;
 16. the real-schema runtime: SMPL-X and FLAME files written in the published
     schema at the published counts (testing.write_schema_assets: 10,475 and
     5,023 vertices, 20,908 and 9,976 faces, 400 shape components), then
     build_runtime on configs/train/ubody_512.yaml pointed at them (the loaders'
     host time split into the files' read and the UV fill), init_params seed 0,
     one warm-up and three timed creations (the UV rows kept, the visible-texel
     share, and the rows that init_params seeds 1 and 2 keep) and 20 frames,
     with launch counts, ms/creation and its split, ms/frame on the host clock
     and device busy; K5 on
     the creation's z-buffer inputs, K2 on frame 0's face table and K1 on frame
     0 against their plain versions; then the same files at micro widths on the
     card against the CPU (UV terms where the texel masks agree);
 17. the multi-device paths on one card (`parallel/`, the parallel train
     steps): (a) an NCCL world of one in this process: make_parallel_train_step
     for 3 steps at phase 8's widths bit-equal to make_train_step when fed its
     gradients, then timed on the real loss beside it and held, on step 1's
     gradients and the parameters after it, to 10 times the gap between two
     make_train_step runs, the parallel eval step,
     the frames-DP render of 8 bench frames bit-equal to phase 4's frames, and
     the row-band wrapper bit-equal to rasterize; (b) in this process, the 4
     bands of 128 x 512 of bench frame 0 by render_band (four K1; four K6 and
     no K1 under bf16_rows, which must move the bands off the f32 ones)
     against the full frame, the frame shards of 2 ranks against
     the sequential frames, and the four band K1 times beside one full-frame
     K1; (c) 2 gloo ranks spawned on cuda:0: a micro-width data-parallel step
     of batch 2, the ranks' parameters bit-equal, loss and gradient against
     one process's; then knn_mean_sq_dist on frame 0's Gaussians, card
     against CPU. A second card is not needed and NCCL between cards is not
     run;
 18. the banded resize R1 (csrc/resize.cu): every resize_bilinear caller's
     ratio in float32, bfloat16 and float16, NCHW and an NHWC view, forward
     and adjoint tables, bit-equal to its plain version; the frame's two
     resizes timed in turns with the same resize as two launches and with
     F.interpolate(antialias=True) as a yardstick, beside their bytes
     bound; the training step's largest resizes forward and backward.
Needs a CUDA device; run from the repository root.
"""

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
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
    _face_table, canonical_gaussians, deform_avatar, deform_with_vertices, sort_avatar_by_plan)
from guava_renderer_tpu_torch.avatar.inferer import (  # noqa: E402
    InfererConfig, UbodyGaussianInferer, assemble_avatar, build_avatar, texel_visibility)
from guava_renderer_tpu_torch.avatar.renderer import NeuralRefiner  # noqa: E402
from guava_renderer_tpu_torch.benchscene import (  # noqa: E402
    INVTANFOV, UBODY_LADDER, make_bench_scene, make_create_scene, make_train_scene)
from guava_renderer_tpu_torch.bodymodel import data as bmdata  # noqa: E402
from guava_renderer_tpu_torch.bodymodel.ehm import ehm_forward  # noqa: E402
from guava_renderer_tpu_torch.cli import context as ctx_module  # noqa: E402
from guava_renderer_tpu_torch.cli.context import (  # noqa: E402
    build_runtime, init_params, load_model_params)
from guava_renderer_tpu_torch.cli.inference import (  # noqa: E402
    FramePipeline, _batched_params, _save_png, _unpack_params)
from guava_renderer_tpu_torch.cli import (  # noqa: E402
    app, convert_motion, create_avatar, metrics, render_motion, resample_motion, trainer_loop)
from guava_renderer_tpu_torch.cli import test as test_cli  # noqa: E402
from guava_renderer_tpu_torch.cli.trainer_loop import train_on_batches  # noqa: E402
from guava_renderer_tpu_torch.core.cameras import Camera  # noqa: E402
from guava_renderer_tpu_torch.data import codec  # noqa: E402
from guava_renderer_tpu_torch.data.loader import PrefetchLoader, endless, to_device  # noqa: E402
from guava_renderer_tpu_torch.data.store import RecordStore, RecordStoreWriter  # noqa: E402
from guava_renderer_tpu_torch.data.synthetic import write_synthetic_dataset  # noqa: E402
from guava_renderer_tpu_torch.data.tracked import TrackedVideoDataset, build_dataset  # noqa: E402
from guava_renderer_tpu_torch.device import resolve_device  # noqa: E402
from guava_renderer_tpu_torch.kernels import blend as k1  # noqa: E402
from guava_renderer_tpu_torch.kernels import build  # noqa: E402
from guava_renderer_tpu_torch.kernels import copy_probe as kt1  # noqa: E402
from guava_renderer_tpu_torch.kernels import rowcopy as kt2  # noqa: E402
from guava_renderer_tpu_torch.kernels import stream_sum as kt3  # noqa: E402
from guava_renderer_tpu_torch.kernels import facegather as k2  # noqa: E402
from guava_renderer_tpu_torch.kernels import gather_rows as k9  # noqa: E402
from guava_renderer_tpu_torch.kernels import meshraster as k5  # noqa: E402
from guava_renderer_tpu_torch.kernels import resize as kresize  # noqa: E402
from guava_renderer_tpu_torch.models import layers  # noqa: E402
from guava_renderer_tpu_torch.models.layers import harmonic_embedding  # noqa: E402
from guava_renderer_tpu_torch.models.styleunet import init_params_  # noqa: E402
from guava_renderer_tpu_torch.ops.facegather import (  # noqa: E402
    build_face_sort_plan, compact_faces, segment_starts)
from guava_renderer_tpu_torch.ops.gsplat import (  # noqa: E402
    MAX_RESIDENT_ROWS, RasterizeSettings, bin_gaussians, pack_rows, rasterize, remap_resident,
    resident_count, resident_ids, resident_keys, round_colors_bf16, stream_rows)
from guava_renderer_tpu_torch.ops.gsplat_project import project_gaussians, tile_rect  # noqa: E402
from guava_renderer_tpu_torch.ops import meshraster as opsmesh  # noqa: E402
from guava_renderer_tpu_torch.ops.knn import knn_mean_sq_dist  # noqa: E402
from guava_renderer_tpu_torch.ops.meshraster import (  # noqa: E402
    bin_mesh, bin_triangles, rasterize_mesh)
from guava_renderer_tpu_torch.testing import (  # noqa: E402
    SCHEMA_COUNTS, make_micro_pipeline, pad_instances, write_schema_assets, zbuffer_scenes)
from guava_renderer_tpu_torch.tools import (  # noqa: E402
    device_ms, dma_bench, ee_probe, mosaic_probe, profile_by_name, profile_window,
    sort_payload_bench)
from guava_renderer_tpu_torch.native import lib_path  # noqa: E402
from guava_renderer_tpu_torch.tools.dma_bench import HOT_ROWS  # noqa: E402
from guava_renderer_tpu_torch.tools.make_teacher_dataset import make_teacher_dataset  # noqa: E402
from guava_renderer_tpu_torch.train.checkpoints import CheckpointManager  # noqa: E402
from guava_renderer_tpu_torch.train.losses import LossConfig, OptimizationLoss  # noqa: E402
from guava_renderer_tpu_torch.train.lpips import LPIPS, init_lpips_  # noqa: E402
from guava_renderer_tpu_torch.train.pipeline import (  # noqa: E402
    PipelineStatics, make_loss_fn, make_models)
from guava_renderer_tpu_torch.train.trainstep import (  # noqa: E402
    make_parallel_eval_step, make_parallel_train_step, make_sample_scan_step, make_train_state,
    make_train_step, scrub_nan_grads, split_batch)
from guava_renderer_tpu_torch.parallel import mesh  # noqa: E402
from guava_renderer_tpu_torch.parallel.batch_render import make_batch_frame_renderer  # noqa: E402
from guava_renderer_tpu_torch.parallel.sharded_render import (  # noqa: E402
    band_prep, rasterize_row_sharded, render_band)
from guava_renderer_tpu_torch.utils.config import load_config  # noqa: E402
from guava_renderer_tpu_torch.utils.logging_utils import TRACE_FILE  # noqa: E402
from guava_renderer_tpu_torch.utils.video import read_video, to_uint8  # noqa: E402

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
# R1 launches of the main path at these sizes: a creation resizes 14 times (DPT's RGB
# pyramid 4, its fusion path 4, the path and the image to 512, the low-level path 3;
# the source image 518 -> 512; the ViT grid is 37 already); a training step's backward
# adds the adjoints of the 7 whose input carries a gradient (the fusion path's 4, the path
# to 512, the low-level path after its first conv 2). The frame at the refiner's size
# resizes nothing.
R1_CREATION = 14
R1_STEP_BACKWARD = 7
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
# the micro run's validation SSIM, relative: its random renders score ~1.3e-4, the card and
# the CPU lie ~2.2e-3 apart relatively, and TF32 on the card moves it ~3x
MICRO_SSIM_RTOL = 1e-2
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
# phase 7's frames, GPU vs CPU, with the refiner at init_params_'s training gain: at the
# flax gain (1) its first activations reach 1.5e6 on that scene, and its float32 output lies
# ~1.6e-3 from float64 on either device; at 0.5 the two devices' frames lie ~7e-7 apart, and
# TF32 moves the card's ~9e-5
P7_REFINER_GAIN = 0.5
P7_FRAME_TOL = 1e-5
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
# phase 13: the config-driven runtime at the widths of configs/train/ubody_512.yaml under
# four refiner settings, each a config override; the micro config under the same four
# (image_size 48 refined at 32 standing for 720 at 512) on the card against the CPU
TRAIN_CONFIG = ROOT / "configs" / "train" / "ubody_512.yaml"
MICRO_CONFIG = ROOT / "configs" / "train" / "micro_synthetic.yaml"
REFINER_OPTIONS = (("f32 StyleUNet-small", {}, {}),
                   ("bf16_refiner", {"bf16_refiner": True}, {"bf16_refiner": True}),
                   ("simpleunet", {"refiner_type": "simpleunet"}, {"refiner_type": "simpleunet"}),
                   # 720 is no multiple of the config's tile 32, which both packages refuse
                   # (the JAX rasterize asserts it): tile 16 there
                   ("raster 720, refine 512", {"image_size": 720, "raster": {"tile": 16}},
                    {"image_size": 48}))
# the bf16 refiner against the f32 one at full width, and bf16 on the card against the
# CPU at micro widths: the tolerances of tests/test_torch_refiner_options.py (BF16_ATOL at
# narrow widths; at full width, where random weights saturate the refiner, the mean
# difference and the share of outputs over BF16_ATOL)
BF16_ATOL = 0.03
FULL_BF16_MEAN, FULL_BF16_SHARE = 0.012, 0.13
# an avatar created with random weights has large Gaussians: its frames bin 16.9M
# instances at 512^2 and tile 32, 132.8M at 720^2 and tile 16 (on an H100 80GB HBM3), where
# the bench scene bins 533,091; keys, order and sort scratch take ~4 GB at this bound
CONFIG_INSTANCE_BUDGET = 256_000_000
BENCH_TIMEOUT_S = 600
# phase 14: the data layer and the config-driven trainer. The codec's files and pixels
# on a fixed image (`codec_image`), as the CPU build gives them (SHA-256; the JPEG files
# are the bytes OpenCV writes there): the card machine's g++ build must give the same
CODEC_SHA = {
    "jpeg q95": "3a482e2da98f996e0081fc0d4ad921eb0b5b8be6ba0c1c516c7662ca1d28d43b",
    "jpeg q95 decoded": "7d6f602e7b2157f538c61b59c159a51d8e7dc1df79e6c702c2cf6df433c4d04c",
    "jpeg q98 gray": "f7e89da9e8519516859299da5a492a46d8aad73a5e5ddf6c1dcee6cc9c57dbd3",
    "jpeg q98 gray decoded": "96f269634a1a49f747f23b12a4060339d102aa6451065d3f21c711b055b4adc8",
}
TEACHER_CONFIG = ROOT / "configs" / "train" / "teacher512_synthetic.yaml"
TEACHER_VIDEOS, TEACHER_FRAMES = 2, 8      # 12 train and 4 validation frames
TEACHER_SEED = 7
P14_ITERS = 5                  # 1 warm-up, 1 profiled and 3 timed iterations of 6 samples
P14_WARMUP = 1                 # the profiled iteration is the next (train_on_batches)
# the witness's local_xyz term in float32 on the card and on the CPU, each against the
# CPU's float64 inferer: the card's error at most this many times the CPU's (floored at
# float32's unit roundoff of the term). TF32's roundoff is 2^13 times float32's.
WITNESS_FACTOR = 100
TRAIN_TIMEOUT_S = 600
# runs `python -m guava_renderer_tpu_torch.cli.train` with its arguments, and prints the
# process's K1, K3 and K5 launches at exit
TRAIN_WRAPPER = (
    "import atexit, json, runpy\n"
    "from guava_renderer_tpu_torch.kernels import blend as k1, meshraster as k5\n"
    "atexit.register(lambda: print('LAUNCHES ' + json.dumps({'K1': k1.launches, "
    "'K3': k1.bwd_launches, 'K5': k5.launches}), flush=True))\n"
    "runpy.run_module('guava_renderer_tpu_torch.cli.train', run_name='__main__', "
    "alter_sys=True)\n")
# phase 15: the inference drivers and their entry points at teacher512 widths, on phase 14's
# teacher512 dataset (2 videos x 8 frames, no testing split: 16 test frames) and run directory
P15_FRAMES = 8                 # --max_frames of the self-reenactment: every frame of a video
P15_VIEWS = 120                # render_novel_views' default num_keyframes
P15_MOTION_T, P15_MOTION_FPS = 30, 25      # the EMAGE-style track, resampled to 30 fps
P15_MOTION_FRAMES = 4          # render_motion --max_frames
P15_MOTION_SIZES = (512, 1024)
# an MP4 frame (a JPEG at quality 95) against its PNGs, mean abs in levels
VIDEO_MEAN_LEVELS = 2.0
APP_POLL_S, APP_TIMEOUT_S = 0.05, 120
TEST_TIMEOUT_S = 600
# runs `python -m guava_renderer_tpu_torch.cli.test` with its arguments, and prints the
# process's K1, K2 and K5 launches at exit
TEST_WRAPPER = (
    "import atexit, json, runpy\n"
    "from guava_renderer_tpu_torch.kernels import blend as k1, facegather as k2, "
    "meshraster as k5\n"
    "atexit.register(lambda: print('LAUNCHES ' + json.dumps({'K1': k1.launches, "
    "'K2': k2.launches, 'K5': k5.launches}), flush=True))\n"
    "runpy.run_module('guava_renderer_tpu_torch.cli.test', run_name='__main__', "
    "alter_sys=True)\n")


# phase 16: the real-schema runtime (SMPL-X/FLAME files in the published schema at the
# published counts, testing.write_schema_assets) under TRAIN_CONFIG
P16_SEED = 16
P16_CREATIONS = 3              # timed, after one warm-up
P16_FRAMES = 20
# phase 17: the multi-device paths on one card
P17_BACKEND = "nccl"           # (a)'s world of one
P17_STEPS = 3                  # training steps of each run of (a), from one start
P17_FRAMES = 8                 # bench frames of the frames-DP render
P17_BANDS = 4                  # (b): 128-row bands of the 512^2 frame
P17_RANKS = 2                  # (c): gloo ranks on cuda:0
P17_BAND_TOL = 2e-5            # f32 bands vs the full frame, of each value floored at 1
P17_BF16_FACTOR = 2.0          # bf16 bands vs the bf16 frame, in units of that frame's distance
                               # from the f32 frame (K6's hi + lo means round with the band shift)
P17_BF16_MOVES = 1e-4          # bf16 bands vs the f32 bands, at least (of each value floored at
                               # 1): a band blended by K1 instead of K6 reads 0
P17_DRIFT_FACTOR = 10.0        # (a): the parallel run on the real loss vs a make_train_step run,
                               # in units of the gap between two make_train_step runs (K3 adds
                               # by float atomics), on step 1's gradients and the parameters
                               # after it (later steps: Adam can flip whole blocks by ~lr)
P17_LOSS_RTOL = 1e-5           # (c): the DP loss vs the one-process batch-2 step's
P17_GRAD_TOL = 1e-4            # (c): the DP gradient vs the one-process mean of the two samples'
                               # gradients, of each tensor's largest entry (K3 adds by atomics)
P17_KNN_RTOL = 1e-5            # knn_mean_sq_dist card vs CPU, of the largest value
# phase 18: (n_in, n_out, align_corners, antialias) of every resize_bilinear caller
R1_RATIOS = {
    "frame down": (2048, 512, False, True), "frame up": (512, 2048, False, True),
    "refine 720": (720, 512, False, True), "source 518": (518, 512, False, True),
    "rgb pyramid 148": (518, 148, False, True), "rgb pyramid 74": (518, 74, False, True),
    "rgb pyramid 37": (518, 37, False, True), "rgb pyramid 19": (518, 19, False, True),
    "fusion 19": (19, 37, False, False), "fusion 37": (37, 74, False, False),
    "fusion 74": (74, 148, False, False), "fusion 148": (148, 296, False, False),
    "dpt path": (296, 512, False, False), "dpt image": (518, 512, False, False),
    "low x2": (37, 74, True, True), "low x4": (74, 296, True, True),
    "vit grid down": (37, 16, False, True), "vit grid up": (16, 37, False, True),
    "styleunet up": (256, 512, False, True), "multiscale /4": (512, 128, False, True),
    "lpips floor": (16, 32, False, True), "ac 1 to 2": (1, 2, True, True),
}
R1_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
R1_BATCH = 6                   # the training step's batch (configs/train/ubody_512.yaml)
R1_PATH_CHANNELS = 256         # DPT's fusion path (DinoDPTEncoder's hidden)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


@contextlib.contextmanager
def tf32_forced():
    """TF32 on for cuDNN and cuBLAS, and kept on through every call of the port's
    resolve_device (which turns it off) meanwhile: a control a card-vs-CPU hold must see."""
    real = resolve_device

    def forced(device="cuda"):
        dev = real(device)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        return dev

    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("guava_renderer_tpu_torch") and getattr(m, "resolve_device", None) is real]
    for m in mods:
        m.resolve_device = forced
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        for m in mods:
            m.resolve_device = real
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False


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


def pose_params(n_shape, n_exp, body=0.0):
    """A target record's params: zero shape and face, body pose `body` on every joint."""
    return {"shape": np.zeros(n_shape, np.float32),
            "body_pose": np.full((21, 3), body, np.float32),
            "flame_shape": np.zeros(n_shape, np.float32), "flame_exp": np.zeros(n_exp, np.float32),
            "flame_jaw": np.zeros(3, np.float32)}


def config_runtime():
    """Phase 13: build_runtime -> init_params -> FramePipeline.from_runtime at the
    widths of the training config; one creation (K5), then 20 frames (K1, K2)
    under each refiner setting; each setting at micro widths on the card against
    the CPU; then bench_torch.py in a subprocess."""
    t13 = time.perf_counter()
    cfg = load_config(str(TRAIN_CONFIG))
    rt = init_params(build_runtime(cfg, synthetic_assets=True, device=DEV), seed=0)
    pipe = FramePipeline.from_runtime(rt)
    n_shape, n_exp = rt.smplx.n_shape, rt.smplx.n_exp
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 30.0
    source = {"image": np.random.default_rng(0).uniform(0, 1, (FEAT, FEAT, 3)).astype(np.float32),
              "w2c": w2c, "params": pose_params(n_shape, n_exp)}
    targets = [{"params": pose_params(n_shape, n_exp, 0.01 * i), "w2c": w2c}
               for i in range(N_FRAMES)]
    k1.launches = k2.launches = k5.launches = 0
    raw, _ = pipe.infer_avatar(source, prune=False)
    torch.cuda.synchronize()
    if k5.launches != k5.LAUNCHES:
        raise SystemExit(f"[13] creation launched K5 {k5.launches} times, expected {k5.LAUNCHES}")
    check_avatar(raw, "[13] creation")
    say(13, f"runtime of {TRAIN_CONFIG.name} (synthetic rig of {rt.num_vertices} vertices, "
            f"ignored raster knobs {rt.ignored_raster}), init_params seed 0, one creation from a "
            f"seeded {FEAT}^2 image: K5 launches {k5.launches}")

    renders, refiners = {}, {}
    for name, over, _ in REFINER_OPTIONS:
        ort = rt if not over else init_params(
            build_runtime(cfg.merge({"MODEL": over}), synthetic_assets=True, device=DEV), seed=0)
        opipe = FramePipeline.from_runtime(ort)
        avatar = opipe.prepare_avatar(raw)
        if opipe.plan is None:
            raise SystemExit(f"[13] {name}: the frames do not take the planned face gather")
        size = opipe.image_size
        with torch.no_grad():
            body, flame = _unpack_params(_batched_params(targets[0]["params"], DEV))
            gs = deform_avatar(avatar, ort.ehm, opipe.faces, body, flame, plan=opipe.plan,
                               compact_faces=opipe.cfaces)
            cam = Camera.from_w2c(torch.as_tensor(w2c, device=DEV), opipe.tanfov, size, size)
            n_inst = frame_instances(gs, cam, ort.renderer.settings.tile)
        if n_inst > CONFIG_INSTANCE_BUDGET:
            raise SystemExit(f"[13] {name}: frame 0 bins {n_inst} instances, over "
                             f"{CONFIG_INSTANCE_BUDGET}")
        opipe.render_frame(avatar, targets[0])                     # warm-up
        torch.cuda.synchronize()
        k1.launches = k2.launches = 0
        t0 = time.perf_counter()
        outs = opipe.render_frames(avatar, targets, group=4)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / N_FRAMES
        if (k1.launches, k2.launches) != (N_FRAMES, N_FRAMES):
            raise SystemExit(f"[13] {name}: launches K1 {k1.launches}, K2 {k2.launches} for "
                             f"{N_FRAMES} frames")
        for out in outs:
            v = out["render"]
            if v.shape != (size, size, 3) or not bool(torch.isfinite(v).all()) \
                    or float(v.min()) < 0.0 or float(v.max()) > 1.0:
                raise SystemExit(f"[13] {name}: bad render {tuple(v.shape)}")
        frames = iter(targets[:5])
        busy, kernels_a_frame, _ = profile_window(
            lambda: opipe.render_frame(avatar, next(frames)), 5)
        renders[name] = torch.stack([o["render"] for o in outs])
        refiners[name] = opipe.renderer.refine
        say(13, f"{name}: {size}^2 frames, refiner at {ort.renderer.refiner_size}^2 "
                f"({ort.renderer.neural_refiner.refiner_type}, dtype "
                f"{ort.renderer.refiner_dtype or torch.float32}), frame 0 bins {n_inst} "
                f"instances; {host_ms:.3f} ms/frame host clock, {busy:.3f} ms/frame device busy, "
                f"{kernels_a_frame:.0f} device kernels a frame; launches K1 {N_FRAMES}, "
                f"K2 {N_FRAMES}")
        del ort, opipe, outs
    # the bf16 refiner against the f32 one at full width on the CPU test's inputs (uniform
    # [0, 1] features), and their frames: the random weights give the created avatar
    # colours of ~1e4, its refined pixels saturate, and one near the sigmoid's edge may
    # flip between 0 and 1 under bf16, so the largest difference is reported, not held
    rsize = int(cfg.MODEL.styleunet.out_size)
    feats = torch.rand((1, rsize, rsize, 32), generator=torch.Generator().manual_seed(3)).to(DEV)
    with torch.no_grad():
        diff = (refiners["bf16_refiner"](feats) - refiners["f32 StyleUNet-small"](feats)).abs()
    fdiff = (renders["bf16_refiner"] - renders["f32 StyleUNet-small"]).abs()
    stats = {what: (float(d.max()), float(d.mean()), float((d > BF16_ATOL).float().mean()))
             for what, d in (("uniform features", diff), ("frames", fdiff))}
    for what, (dmax, dmean, share) in stats.items():
        if not (dmean <= FULL_BF16_MEAN and share <= FULL_BF16_SHARE):
            raise SystemExit(f"[13] bf16 refiner vs f32 on the {what}: mean abs {dmean}, share "
                             f"over {BF16_ATOL} {share} (tolerance {FULL_BF16_MEAN}, "
                             f"{FULL_BF16_SHARE})")
        say(13, f"bf16 refiner vs f32 on the {what} ({rsize}^2 refiner): mean abs {dmean:.6f}, "
                f"share over {BF16_ATOL} {share:.6f} (tolerance {FULL_BF16_MEAN}, "
                f"{FULL_BF16_SHARE}); max abs {dmax:.4f}")
    del renders, refiners, rt, pipe, raw

    # each setting at micro widths: the card against the CPU
    micro = load_config(str(MICRO_CONFIG))
    mw2c = np.array(w2c)
    mw2c[2, 3] = 6.0
    mimage = np.random.default_rng(1).uniform(0, 1, (28, 28, 3)).astype(np.float32)
    for name, _, over in REFINER_OPTIONS:
        got = {}
        for key, dev in (("cpu", torch.device("cpu")), ("gpu", DEV)):
            mrt = init_params(build_runtime(micro.merge({"MODEL": over}), synthetic_assets=True,
                                            device=dev), seed=0)
            mpipe = FramePipeline.from_runtime(mrt)
            ns, ne = mrt.smplx.n_shape, mrt.smplx.n_exp
            mav, _ = mpipe.infer_avatar({"image": mimage, "w2c": mw2c,
                                         "params": pose_params(ns, ne)})
            out = mpipe.render_frame(mav, {"params": pose_params(ns, ne, 0.03), "w2c": mw2c})
            got[key] = {k: v.cpu() for k, v in out.items()}
        err = max(float((got["cpu"][k] - got["gpu"][k]).abs().max()) for k in got["cpu"])
        tol = BF16_ATOL if over.get("bf16_refiner") else SMALL_CREATE_TOL
        if not err <= tol:
            raise SystemExit(f"[13] micro {name}: GPU vs CPU max abs {err} > {tol}")
        say(13, f"micro {name} ({mpipe.image_size}^2, refiner at "
                f"{mpipe.renderer.refiner_size}^2): create + frame on the GPU vs the CPU: "
                f"max abs {err:.3g} (tol {tol})")

    # the bench script, as a user runs it
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"), "--frames", "20",
                           "--repeats", "3"], cwd=ROOT, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise SystemExit(f"[13] bench_torch.py: rc {proc.returncode}, {len(lines)} stdout lines; "
                         f"stderr tail: {proc.stderr[-3000:]}")
    rec = json.loads(lines[0])
    if not rec["value"] > 0:
        raise SystemExit(f"[13] bench_torch.py measured {rec['value']} fps")
    say(13, f"bench_torch.py --frames 20 --repeats 3: rc 0 in {time.perf_counter() - t0:.1f} s, "
            f"{rec['value']:.3f} fps; its line follows")
    print(lines[0], flush=True)
    return time.perf_counter() - t13


def codec_image():
    """A fixed (97, 131, 3) uint8 image from a formula (no random draws, so every
    numpy gives it): gradients with a fine checker and a ramp of stripes."""
    y, x = np.mgrid[0:97, 0:131]
    img = np.stack([(x + 2 * y) % 256, (x * y // 40) % 256,
                    200 - x + ((x // 3 + y // 3) % 2) * 12], axis=-1)
    return img.astype(np.uint8)


def codec_digests():
    """{name: SHA-256} of the codec's files and decodes of `codec_image`."""
    import hashlib

    img = codec_image()
    j95 = codec.encode_jpeg(img, 95)
    j98g = codec.encode_jpeg(img[..., 1], 98)
    parts = {"jpeg q95": j95, "jpeg q95 decoded": codec.decode_jpeg(j95).tobytes(),
             "jpeg q98 gray": j98g, "jpeg q98 gray decoded": codec.decode_jpeg(j98g).tobytes()}
    return {k: hashlib.sha256(v).hexdigest() for k, v in parts.items()}


def cfg_size(path):
    return int(load_config(str(path)).MODEL.image_size)


def trace_busy(path):
    """A torch.profiler Chrome trace -> (device busy ms: the union of its kernel,
    memcpy and memset intervals; the window in ms from its first to its last event)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -math.inf
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    return busy / 1e3, (hi - lo) / 1e3


def run_train_cli(args, env, timeout=TRAIN_TIMEOUT_S):
    """`python -m guava_renderer_tpu_torch.cli.train ARGS` (through TRAIN_WRAPPER) ->
    (its log lines, its K1/K3/K5 launches); exits on a non-zero return code."""
    proc = subprocess.run([sys.executable, "-c", TRAIN_WRAPPER, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    out = proc.stdout.splitlines() + proc.stderr.splitlines()
    if proc.returncode != 0:
        raise SystemExit(f"[14] cli.train {' '.join(args)}: rc {proc.returncode}; tail:\n"
                         + "\n".join(out[-40:]))
    launches = [json.loads(ln[len("LAUNCHES "):]) for ln in proc.stdout.splitlines()
                if ln.startswith("LAUNCHES ")]
    return out, launches[-1]


ITER_LINE = re.compile(r"iter (\d+): (.*) \(([\d.]+) it/s; step ([\d.]+) ms, batch wait ([\d.]+) ms\)")
VAL_LINE = re.compile(r"validation @(\d+): psnr=(\S+) ssim=(\S+)")


def parse_train_log(lines):
    """-> ({iteration: (metrics, step ms, wait ms)}, [(iteration, psnr, ssim)])."""
    iters, vals = {}, []
    for ln in lines:
        m = ITER_LINE.search(ln)
        if m:
            metrics = {k: float(v) for k, v in (kv.split("=") for kv in m.group(2).split())}
            iters[int(m.group(1))] = (metrics, float(m.group(4)), float(m.group(5)))
        m = VAL_LINE.search(ln)
        if m:
            vals.append((int(m.group(1)), float(m.group(2)), float(m.group(3))))
    return iters, vals


def micro_trainer_gpu_vs_cpu(work):
    """2 iterations of the config-driven run_training on micro_synthetic.yaml, on the
    card, on the CPU and on the card with TF32 forced on, from one port checkpoint ->
    {"gpu", "cpu", "tf32"}: each run's losses, loader batches (on the CPU), validations
    and (the card's) launches."""
    data = str(work / "micro_ds")
    if not os.path.isdir(data):
        write_synthetic_dataset(data, n_videos=1, n_frames=4, image_size=48, n_shape=8, n_exp=4)
    cfg = load_config(str(MICRO_CONFIG), {"DATASET": {"data_path": data},
                                          "TRAIN": {"check_interval": 2}})
    rt = init_params(build_runtime(cfg, synthetic_assets=True, device="cpu"), seed=0)
    base = CheckpointManager(str(work / "micro_base")).save_named(
        "init", make_train_state(rt.model, learning_rate=float(cfg.OPTIMIZE.learning_rate)), 0)
    del rt
    seen = {}
    real_loss_fn, real_validation = trainer_loop.make_loss_fn, trainer_loop.run_validation
    for key, dev in (("cpu", torch.device("cpu")), ("gpu", DEV), ("tf32", DEV)):
        rec = seen[key] = {"losses": [], "batches": [], "val": []}

        def recording_loss_fn(*a, rec=rec, **kw):
            fn = real_loss_fn(*a, **kw)

            def wrapped(batch, iteration):
                loss, metrics = fn(batch, iteration)
                rec["losses"].append(float(loss.detach()))
                rec["batches"].append({k: v.cpu() for k, v in flat_tree(batch).items()})
                return loss, metrics
            return wrapped

        def recording_validation(eval_fn, batches, rec=rec):
            rec["val"].append(real_validation(eval_fn, batches))
            return rec["val"][-1]

        trainer_loop.make_loss_fn = recording_loss_fn
        trainer_loop.run_validation = recording_validation
        try:
            k1.launches = k1.bwd_launches = k5.launches = 0
            with tf32_forced() if key == "tf32" else contextlib.nullcontext():
                rt = build_runtime(cfg, synthetic_assets=True, device=dev)
                trainer_loop.run_training(rt, build_dataset(cfg, "train"),
                                          build_dataset(cfg, "valid"),
                                          str(work / f"micro_{key}"), basemodel=base,
                                          max_iters=2)
            if key == "gpu":
                torch.cuda.synchronize()
                rec["launches"] = {"K1": k1.launches, "K3": k1.bwd_launches, "K5": k5.launches}
        finally:
            trainer_loop.make_loss_fn, trainer_loop.run_validation = real_loss_fn, real_validation
        del rt
    return seen


def micro_terms(seen, key):
    """The relative differences of run `key`'s losses, validation PSNR and validation SSIM
    from the CPU run's, and whether they lie within MICRO_LOSS_RTOL (losses, PSNR) and
    MICRO_SSIM_RTOL (SSIM)."""
    g, c = seen[key], seen["cpu"]
    if not all(math.isfinite(v) for v in g["losses"] + c["losses"]):
        raise SystemExit(f"[14] micro: losses {g['losses']} / {c['losses']}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], c["losses"]))
    psnr_err, ssim_err = (abs(g["val"][-1][k] - c["val"][-1][k]) / abs(c["val"][-1][k])
                          for k in ("psnr", "ssim"))
    within = max(loss_err, psnr_err) <= MICRO_LOSS_RTOL and ssim_err <= MICRO_SSIM_RTOL
    return loss_err, psnr_err, ssim_err, within


def micro_check(seen):
    """Phase 14's micro comparison: the loader batches bit-equal, the losses and the
    validation PSNR within MICRO_LOSS_RTOL and the SSIM within MICRO_SSIM_RTOL, the card's
    launches; the run with TF32 forced on outside those limits. -> the worst relative
    differences of the losses, the PSNR and the SSIM, then the TF32 run's."""
    g, c = seen["gpu"], seen["cpu"]
    same_batches = len(g["batches"]) == len(c["batches"]) == 2 and all(
        a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        for a, b in zip(g["batches"], c["batches"]))
    if not same_batches:
        raise SystemExit("[14] micro: the card's loader batches differ from the CPU's")
    *errs, within = micro_terms(seen, "gpu")
    if not within:
        raise SystemExit(f"[14] micro GPU vs CPU: losses {g['losses']} vs {c['losses']}, "
                         f"validation {g['val'][-1]} vs {c['val'][-1]}")
    *tf32_errs, tf32_within = micro_terms(seen, "tf32")
    if tf32_within:
        raise SystemExit(f"[14] micro with TF32 forced on within the limits {tf32_errs}: the "
                         f"hold cannot see TF32")
    # a step of batch 2: two K1 and two K3 launches (one an item), one K1 a validation item
    want = {"K1": 2 * 2 + 2, "K3": 2 * 2, "K5": (2 * 2 + 2) * k5.LAUNCHES}
    if g["launches"] != want:
        raise SystemExit(f"[14] micro on the card: launches {g['launches']}, expected {want}")
    return (*errs, *tf32_errs)


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def phase14(work):
    """Phase 14: the native store and codec built on the card's host; the
    config-driven trainer at micro widths on the card against the CPU; the teacher
    tool and `python -m guava_renderer_tpu_torch.cli.train` at the widths of
    teacher512_synthetic.yaml, then a resume. Its dataset and run directory stay in
    `work` for phase 15. -> (seconds, K1/K3/K5 launches)."""
    t14 = time.perf_counter()
    launches = {"K1": 0, "K3": 0, "K5": 0}

    # -- 1. the host libraries: built here, held to the CPU build's bytes
    libs = [Path(lib_path(n)).name for n in ("recordstore", "imagecodec")]
    store_path = str(work / "probe.grv")
    with RecordStoreWriter(store_path) as w:
        w.put("a", b"x" * 5)
        w.put("big", bytes(range(256)) * 8192)
    st = RecordStore(store_path)
    if st.backend != "native" or st.get("a") != b"x" * 5 or len(st.get("big")) != 2 ** 21:
        raise SystemExit(f"[14] record store: backend {st.backend}")
    st.close()
    digests = codec_digests()
    if digests != CODEC_SHA:
        raise SystemExit(f"[14] codec bytes differ from the CPU build's: {digests}")
    img = codec_image()
    png_ok = all(np.array_equal(codec.decode_png(codec.encode_png(a)), a)
                 for a in (img, img[..., 0], np.concatenate([img, img[..., :1]], axis=-1)))
    jpeg_err = float(np.abs(codec.decode_jpeg(codec.encode_jpeg(img, 95)).astype(int)
                            - img).mean())
    if not png_ok or not jpeg_err < 10:
        raise SystemExit(f"[14] codec round trip: PNG exact {png_ok}, JPEG mean abs {jpeg_err}")
    say(14, f"host libraries built with g++ ({', '.join(libs)}); record store backend "
            f"{st.backend}; JPEG q95, q98 gray and their decodes byte-equal to the CPU "
            f"build's (SHA-256); PNG round trips exact; JPEG q95 round trip mean abs "
            f"{jpeg_err:.3f} levels")

    # -- 2. micro: the config-driven run_training on the card against the CPU
    seen = micro_trainer_gpu_vs_cpu(work)
    loss_err, psnr_err, ssim_err, *tf32_errs = micro_check(seen)
    g, c = seen["gpu"], seen["cpu"]
    for k in launches:
        launches[k] += g["launches"][k]
    lr = float(load_config(str(MICRO_CONFIG)).OPTIMIZE.learning_rate)
    say(14, f"micro run_training, 2 iterations of batch 2 on the card vs the CPU from one "
            f"port checkpoint at the config's learning rate {lr}: loader batches bit-equal; "
            f"losses {', '.join(f'{a:.7f}/{b:.7f}' for a, b in zip(g['losses'], c['losses']))} "
            f"(worst rel {loss_err:.2e}); validation psnr "
            f"{g['val'][-1]['psnr']:.6f}/{c['val'][-1]['psnr']:.6f} (rel {psnr_err:.2e}), "
            f"ssim {g['val'][-1]['ssim']:.8f}/{c['val'][-1]['ssim']:.8f} (rel "
            f"{ssim_err:.2e}); rtol {MICRO_LOSS_RTOL}, SSIM's {MICRO_SSIM_RTOL}; launches on "
            f"the card {g['launches']}; the control with TF32 forced on: losses, psnr, ssim rel "
            + ", ".join(f"{e:.2e}" for e in tf32_errs) + ", outside the limits as it must be")

    # -- 3. teacher512: the teacher tool, then the entry point in a subprocess
    t0 = time.perf_counter()
    data = str(work / "teacher512")
    k1.launches = k1.bwd_launches = k5.launches = 0
    cov = make_teacher_dataset(data, str(TEACHER_CONFIG), videos=TEACHER_VIDEOS,
                               frames=TEACHER_FRAMES, seed=TEACHER_SEED, device=DEV,
                               log=lambda s: None)
    torch.cuda.synchronize()
    teacher_launches = {"K1": k1.launches, "K5": k5.launches}
    n_frames = TEACHER_VIDEOS * TEACHER_FRAMES
    if teacher_launches != {"K1": n_frames, "K5": TEACHER_VIDEOS * k5.LAUNCHES} \
            or not all(0 < v <= 1 for v in cov.values()):
        raise SystemExit(f"[14] teacher tool: launches {teacher_launches}, coverage {cov}")
    launches["K1"] += teacher_launches["K1"]
    launches["K5"] += teacher_launches["K5"]
    say(14, f"teacher tool at {TEACHER_CONFIG.name}: {TEACHER_VIDEOS} videos x "
            f"{TEACHER_FRAMES} frames at {cfg_size(TEACHER_CONFIG)}^2 in {time.perf_counter() - t0:.1f} s, coverage "
            f"{min(cov.values()):.3f}-{max(cov.values()):.3f}, launches {teacher_launches}")

    cfg = load_config(str(TEACHER_CONFIG), {
        "DATASET": {"data_path": data},
        "TRAIN": {"check_interval": P14_ITERS, "visual_interval": P14_ITERS}})
    cfg_path = work / "teacher512.yaml"
    cfg._dump(str(cfg_path))
    bs = int(cfg.TRAIN.batch_size)
    train_ds = build_dataset(cfg, "train")
    n_train, n_valid = len(train_ds), len(build_dataset(cfg, "valid"))
    size = int(cfg.MODEL.image_size)
    # per-sample accumulation: the grid shows the first sample, validation is by 1
    accum = bool(cfg.TRAIN.get("host_accum", False)) and bs > 1

    # the flax-scale start (init_params, as run_training starts) for two steps of one
    # sample, then the basemodel: the same runtime at gain 0.5, as a port checkpoint
    t0 = time.perf_counter()
    rt = init_params(build_runtime(cfg, synthetic_assets=True, device=DEV), seed=0)
    loader = PrefetchLoader(train_ds, bs, shuffle=False, pin_memory=True)
    host_batch = loader.load_batch(range(bs))
    state = make_train_state(rt.model, learning_rate=float(cfg.OPTIMIZE.learning_rate))
    flax_step = make_train_step(make_loss_fn(rt.statics, rt.lpips, remat=True), state,
                                count_scrubbed=True)
    one = split_batch(to_device(host_batch, DEV), 0)
    flax_losses = []
    for _ in range(2):
        loss, metrics = flax_step(one)
        flax_losses.append((float(loss), int(metrics["scrubbed_grads"])))
    flax_finite = all(bool(torch.isfinite(p).all()) for p in rt.model.parameters())
    say(14, f"teacher512 from the flax-scale init (init_params seed 0), two steps of one "
            f"sample: (loss, non-finite gradient entries zeroed) {flax_losses}; parameters "
            f"finite after them: {flax_finite}")
    del state, flax_step, one
    gen = torch.Generator().manual_seed(0)
    init_params_(rt.inferer, gen, gain=TRAIN_INIT_GAIN)
    init_params_(rt.renderer, gen, gain=TRAIN_INIT_GAIN)
    base = CheckpointManager(str(work / "base")).save_named(
        "init_gain05", make_train_state(rt.model, learning_rate=float(cfg.OPTIMIZE.learning_rate)),
        0)

    # the loader alone (6 targets, 6 sources: decode, resize, collate) and the copy
    batch_ms = []
    for i in range(3):
        t1 = time.perf_counter()
        loader.load_batch(range(i, i + bs))
        batch_ms.append((time.perf_counter() - t1) * 1e3)
    pinned = loader.load_batch(range(bs))
    h2d = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        to_device(pinned, DEV)
        end.record()
        end.synchronize()
        h2d.append(start.elapsed_time(end))
    n_bytes = sum(v.numel() * v.element_size() for v in flat_tree(pinned).values())
    del rt, loader, pinned, host_batch
    torch.cuda.empty_cache()
    say(14, f"loader alone: {statistics.median(batch_ms):.1f} ms a batch of {bs} (decode 2 x "
            f"{bs} JPEG + PNG, resize, collate; median of 3, host clock); H2D of a pinned batch "
            f"({n_bytes / 1e6:.1f} MB): {statistics.median(h2d):.3f} ms (CUDA events, median "
            f"of 5); runtime and basemodel in {time.perf_counter() - t0:.1f} s")

    out_root = work / "out"
    env = dict(os.environ, GUAVA_OUTPUT_DIR=str(out_root),
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    prof = work / "prof"
    t0 = time.perf_counter()
    lines, run_launches = run_train_cli(
        ["-c", str(cfg_path), "--synthetic_assets", "--basemodel", base, "--debug",
         "--max_iters", str(P14_ITERS), "--profile_dir", str(prof)], env)
    run_s = time.perf_counter() - t0
    iters, vals = parse_train_log(lines)
    run_iters = iters
    run = out_root / cfg.TRAIN.exp_str
    if sorted(iters) != list(range(1, P14_ITERS + 1)) \
            or not all(math.isfinite(v) for m, _, _ in iters.values() for v in m.values()):
        raise SystemExit(f"[14] teacher512 run: iteration lines {iters}")
    if [it for it, *_ in vals] != [P14_ITERS] \
            or not all(math.isfinite(v) for _, *pv in vals for v in pv):
        raise SystemExit(f"[14] teacher512 run: validation lines {vals}")
    if not any(f"warm start from {base} at iter 0" in ln for ln in lines):
        raise SystemExit("[14] teacher512 run: no warm start from the basemodel")
    ckpt_dir = run / "checkpoints"
    best = [f for f in os.listdir(ckpt_dir) if f.startswith("best_")]
    for name in ["latest.pt"] + best:
        payload = torch.load(ckpt_dir / name, map_location="cpu", weights_only=True)
        if payload["iteration"] != P14_ITERS or not all(
                bool(torch.isfinite(v).all()) for v in payload["state"]["model"].values()
                if v.is_floating_point()):
            raise SystemExit(f"[14] checkpoint {name}: iteration {payload['iteration']}")
        del payload
    if len(best) != 1:
        raise SystemExit(f"[14] checkpoints {os.listdir(ckpt_dir)}")
    grid = codec.decode_jpeg((run / "visuals_training" / "train_render"
                              / f"training_{P14_ITERS}.jpg").read_bytes())
    grid_items = 1 if accum else min(2, bs)
    if grid.shape != (3 * size, grid_items * size, 3):
        raise SystemExit(f"[14] the visual grid is {grid.shape}")
    if not ((run / "config.yaml").is_file() and (run / "codes" / "chip_smoke.py").is_file()
            and (run / "codes" / "guava_renderer_tpu_torch" / "cli" / "trainer_loop.py").is_file()):
        raise SystemExit(f"[14] run directory {sorted(os.listdir(run))}")
    # a step is 6 samples: K3 once a sample, K1 and K5 once a sample and, under remat, once
    # more in the backward's recomputed forward; the visual grid adds a forward of its
    # items, and the validation one a frame of its full batches
    remat = bool(cfg.TRAIN.get("remat", False))
    step_fwd = bs * (2 if remat else 1)
    vbs = 1 if accum else bs
    n_fwd = step_fwd * P14_ITERS + grid_items + n_valid // vbs * vbs
    want = {"K1": n_fwd, "K3": bs * P14_ITERS, "K5": n_fwd * k5.LAUNCHES}
    if run_launches != want:
        raise SystemExit(f"[14] teacher512 run: launches {run_launches}, expected {want}")
    for k in launches:
        launches[k] += run_launches[k]
    busy_ms, window_ms = trace_busy(prof / TRACE_FILE)
    timed = [iters[i] for i in range(P14_WARMUP + 2, P14_ITERS + 1)]
    step_med = statistics.median(s for _, s, _ in timed)
    wait_med = statistics.median(w for _, _, w in timed)
    losses = [iters[i][0]["total"] for i in sorted(iters)]
    terms = ", ".join(f"{k} {v:.4g}" for k, v in sorted(iters[P14_ITERS][0].items()))
    say(14, f"teacher512 through python -m guava_renderer_tpu_torch.cli.train ({n_train} "
            f"train and {n_valid} validation frames, batch {bs}"
            f"{' by per-sample accumulation' if accum else ''}"
            f"{', remat' if remat else ''}, basemodel at gain "
            f"{TRAIN_INIT_GAIN}) in {run_s:.1f} s: {P14_WARMUP} warm-up, 1 profiled and "
            f"{P14_ITERS - P14_WARMUP - 1} timed iterations, median "
            f"{step_med:.1f} ms/step of the timed (host clock; all "
            f"{', '.join(f'{iters[i][1]:.0f}' for i in sorted(iters))}), loader wait "
            f"{wait_med:.2f} ms a step (all {', '.join(f'{iters[i][2]:.2f}' for i in sorted(iters))}); "
            f"losses {', '.join(f'{v:.4f}' for v in losses)} (the last: {terms}); "
            f"validation @{vals[0][0]} psnr "
            f"{vals[0][1]:.3f} ssim {vals[0][2]:.4f}; latest and {best[0]} load; grid "
            f"{grid.shape[1]}x{grid.shape[0]} decodes")
    say(14, f"profiler over iteration {P14_WARMUP + 1}: device busy {busy_ms:.1f} ms of a "
            f"{window_ms:.1f} ms window (idle share {1 - busy_ms / window_ms:.3f}), "
            f"{busy_ms / step_med:.3f} of the timed median step (idle share "
            f"{1 - busy_ms / step_med:.3f}); launches "
            f"a step K1 {step_fwd}, K3 {bs}, K5 {step_fwd * k5.LAUNCHES}; the run's {run_launches} "
            f"(grid and validation included)")

    # -- 4. resume from latest: goes on at the next iteration
    t0 = time.perf_counter()
    latest = str(ckpt_dir / "latest.pt")
    lines, resume_launches = run_train_cli(
        ["-c", str(cfg_path), "--synthetic_assets", "--basemodel", latest, "--debug",
         "--max_iters", str(P14_ITERS + 1)], env)
    iters, vals = parse_train_log(lines)
    if sorted(iters) != [P14_ITERS + 1] or [v[0] for v in vals] != [P14_ITERS + 1] \
            or not any(f"warm start from {latest} at iter {P14_ITERS}" in ln for ln in lines) \
            or not all(math.isfinite(v) for v in iters[P14_ITERS + 1][0].values()):
        raise SystemExit(f"[14] resume: iterations {sorted(iters)}, validation {vals}")
    for k in launches:
        launches[k] += resume_launches[k]
    terms = ", ".join(f"{k} {v:.4g}" for k, v in sorted(iters[P14_ITERS + 1][0].items()))
    say(14, f"resume from latest at iteration {P14_ITERS}: iteration {P14_ITERS + 1} in "
            f"{iters[P14_ITERS + 1][1]:.0f} ms, loss {terms}, "
            f"validation @{vals[0][0]} psnr {vals[0][1]:.3f} ssim {vals[0][2]:.4f}; the process "
            f"in {time.perf_counter() - t0:.1f} s; launches {resume_launches}")

    # -- 5. a witness for the run's local_xyz term
    xyz_witness(cfg, work, base, latest, run_iters)
    return time.perf_counter() - t14, launches


def xyz_terms(statics, batch):
    """The local_xyz regulariser of each sample of `batch` (OptimizationLoss's
    relu(|uv_local_xyz| - threshold) x lambda), from the avatar alone."""
    cfg = statics.loss_cfg
    terms = []
    with torch.no_grad():
        for i in range(batch["target"]["image"].shape[0]):
            src = split_batch(batch, i)["source"]
            body, flame = _unpack_params(src["params"])
            avatar, _ = build_avatar(
                statics.inferer, statics.ehm, statics.faces, statics.uvmap_f_idx,
                statics.uvmap_f_bary, statics.uvmap_mask, src["image"], src["w2c"], body, flame,
                image_size=statics.image_size, invtanfov=statics.invtanfov)
            excess = torch.linalg.vector_norm(avatar.uv_local_xyz, dim=-1) - cfg.threshold_local_xyz
            terms.append(float(torch.clamp(excess, min=0.0).mean() * cfg.lambda_local_xyz))
    return terms


def f64_tree(x):
    """Every floating tensor of a nested module / dict / tuple in float64 (modules in
    place)."""
    if isinstance(x, torch.nn.Module):
        return x.double()
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: f64_tree(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_replace"):
        return type(x)(*[f64_tree(v) for v in x])
    if isinstance(x, tuple):
        return tuple(f64_tree(v) for v in x)
    return x


def avatar_inputs(statics, one):
    """(source, vertices, texel mask) of a batch of 1, as build_avatar makes them."""
    src = one["source"]
    with torch.no_grad():
        body, flame = _unpack_params(src["params"])
        verts = ehm_forward(statics.ehm, body, flame).vertices
        mask, _ = texel_visibility(verts, statics.faces, src["w2c"], statics.uvmap_f_idx,
                                   statics.uvmap_mask, statics.image_size, statics.invtanfov)
    return src, verts, mask


def inferer_term(statics, src, verts, mask, f64=False):
    """The local_xyz term (as xyz_terms takes it) of the inferer's UV offsets from these
    inputs, moved to the inferer's device; with `f64` in float64 (the inferer turned so
    in place)."""
    cfg = statics.loss_cfg
    cast = f64_tree if f64 else (lambda x: x)
    dev = statics.uvmap_f_bary.device
    args = tuple(t.to(dev) for t in (src["image"], src["w2c"], verts, mask))
    with torch.no_grad():
        _, uv_gs, _ = cast(statics.inferer)(*cast(args), statics.uvmap_f_idx,
                                            cast(statics.uvmap_f_bary), statics.faces)
        excess = torch.linalg.vector_norm(uv_gs["local_pos"], dim=-1) - cfg.threshold_local_xyz
        return float(torch.clamp(excess, min=0.0).mean() * cfg.lambda_local_xyz)


def xyz_witness(cfg, work, base, latest, run_iters):
    """The teacher512 run's local_xyz term, witnessed. The run's iterations but its
    last are replayed in this process through run_training from the same basemodel,
    and the run's batches are rebuilt in the loader's order (a fresh dataset and
    loader, as the run's process made them). On the card, the term of each sample
    from the basemodel's weights, from the replay's last and from the run's `latest`.
    The largest of them is recomputed from the CPU's inputs (vertices, texel mask) by
    the CPU's inferer in float32 and in float64 and by the card's: the card's distance
    from the float64 term is held to WITNESS_FACTOR times the CPU's float32 one, and so
    is the card's own term where its texel mask equals the CPU's (the visibility of a
    face covering a pixel's centre by a hair can flip between the two devices'
    float32 vertices). Beside them, the term of each iteration of the run and of the
    replay (from their logs' moving averages)."""
    t0 = time.perf_counter()
    n, bs = len(run_iters), int(cfg.TRAIN.batch_size)
    rt = build_runtime(cfg, synthetic_assets=True, device=DEV)
    replay = work / "replay"
    trainer_loop.run_training(rt, build_dataset(cfg, "train"), build_dataset(cfg, "valid"),
                              str(replay), basemodel=base, debug=True, max_iters=n - 1)
    replay_iters, _ = parse_train_log((replay / "train_log.txt").read_text().splitlines())
    weights = {"the basemodel": base,
               f"the replay's iteration {n - 1}": str(replay / "checkpoints" / "latest.pt"),
               "the run's latest": latest}
    loader = endless(PrefetchLoader(build_dataset(cfg, "train"), bs, shuffle=True))
    host = [b for b, _ in zip(loader, range(n))]
    ckpts = CheckpointManager(str(work / "witness"))

    def statics_with(rt, path):
        ckpts.restore(make_train_state(rt.model), path)
        return rt.statics

    card = {}
    for name, path in weights.items():
        statics = statics_with(rt, path)
        card[name] = [xyz_terms(statics, to_device(b, DEV)) for b in host]
    loss_cfg = rt.statics.loss_cfg
    name, it, i = max(((name, it, i) for name, rows in card.items()
                       for it, r in enumerate(rows) for i in range(len(r))),
                      key=lambda p: card[p[0]][p[1]][p[2]])
    # that sample: the CPU's inputs (vertices, texel mask) and terms in float32 and with
    # the inferer in float64; the card's inferer on the CPU's inputs (and on them with
    # cuDNN off); the card's own inputs against the CPU's
    g = card[name][it][i]
    statics = statics_with(rt, weights[name])
    _, verts_g, mask_g = avatar_inputs(statics, split_batch(to_device(host[it], DEV), i))
    rt_cpu = build_runtime(cfg, synthetic_assets=True, device="cpu")
    statics_cpu = statics_with(rt_cpu, weights[name])
    src, verts, mask = avatar_inputs(
        statics_cpu, split_batch(to_device(host[it], torch.device("cpu")), i))
    c = inferer_term(statics_cpu, src, verts, mask)
    t = inferer_term(statics_cpu, src, verts, mask, f64=True)
    g_same = inferer_term(statics, src, verts, mask)
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        g_native = inferer_term(statics, src, verts, mask)
    flips = int((mask_g.cpu() != mask).sum())
    dverts = float((verts_g.cpu() - verts).abs().max())
    del rt, rt_cpu, statics, statics_cpu
    torch.cuda.empty_cache()
    allowed = WITNESS_FACTOR * max(abs(c - t), 2.0 ** -24 * abs(t))

    def per_step(log_iters):
        avg = [log_iters[k][0]["local_xyz_loss"] for k in sorted(log_iters)]
        return ", ".join(f"{k * a - (k - 1) * b:.4g}" for k, a, b
                         in zip(range(1, len(avg) + 1), avg, [0.0] + avg))

    def row(terms):
        return ", ".join(f"{v:.4g}" for v in terms)

    say(14, f"witness for the run's local_xyz term (relu(|uv_local_xyz| - "
            f"{loss_cfg.threshold_local_xyz}) x {loss_cfg.lambda_local_xyz}; each step's from "
            f"its log's moving averages): the run's {per_step(run_iters)}; its first {n - 1} "
            f"iterations replayed here from the basemodel: losses "
            f"{row(replay_iters[k][0]['total'] for k in sorted(replay_iters))} (the run's "
            f"{row(run_iters[k][0]['total'] for k in sorted(run_iters))}), local_xyz "
            f"{per_step(replay_iters)}")
    for w in weights:
        say(14, f"  the term from {w}'s weights on the card, on the run's {n} batches rebuilt "
                f"in the loader's order, a step (the mean of its {bs} samples): "
                f"{row(sum(r) / len(r) for r in card[w])}; a sample: "
                f"{'; '.join(row(r) for r in card[w])}")
    def rel(a):
        return f"{abs(a - t) / max(abs(t), 1e-30):.2e}"

    say(14, f"  the largest, batch {it + 1}'s item {i} from {name}'s weights: the CPU's "
            f"float64 inferer {t:.9g}; the CPU's float32 {c:.9g} ({rel(c)} from it); the "
            f"card's inferer on the CPU's inputs {g_same:.9g} ({rel(g_same)}; allowed "
            f"{allowed / max(abs(t), 1e-30):.2e}, {WITNESS_FACTOR} x the CPU's), with cuDNN off "
            f"{g_native:.9g} ({rel(g_native)}); the card end to end {g:.9g} ({rel(g)}): its "
            f"vertices within {dverts:.3g} of the CPU's, its texel mask differs at {flips} "
            f"texels; witness in {time.perf_counter() - t0:.1f} s")
    if not abs(g_same - t) <= allowed or (flips == 0 and not abs(g - t) <= allowed):
        raise SystemExit(f"[14] witness: local_xyz of batch {it + 1}'s item {i} from {name}'s "
                         f"weights: the card {g_same} on the CPU's inputs, {g} on its own "
                         f"({flips} texels of the mask differ), the CPU {c}, float64 {t}")


def run_test_cli(args, timeout=TEST_TIMEOUT_S):
    """`python -m guava_renderer_tpu_torch.cli.test ARGS` (through TEST_WRAPPER) ->
    (its output lines, its K1/K2/K5 launches); exits on a non-zero return code."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", TEST_WRAPPER, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    out = proc.stdout.splitlines() + proc.stderr.splitlines()
    if proc.returncode != 0:
        raise SystemExit(f"[15] cli.test {' '.join(args)}: rc {proc.returncode}; tail:\n"
                         + "\n".join(out[-40:]))
    launches = [json.loads(ln[len("LAUNCHES "):]) for ln in proc.stdout.splitlines()
                if ln.startswith("LAUNCHES ")]
    return out, launches[-1]


def zero_launches():
    k1.launches = k2.launches = k5.launches = 0


def read_launches():
    torch.cuda.synchronize()
    return {"K1": k1.launches, "K2": k2.launches, "K5": k5.launches}


def driver_launches(creations, frames):
    """K1 and K2 once a frame (the planned gather), K5 k5.LAUNCHES a creation."""
    return {"K1": frames, "K2": frames, "K5": creations * k5.LAUNCHES}


def pngs(d):
    return sorted(p.name for p in Path(d).glob("*.png"))


def check_dump(where, d, indices, video, size, width=None):
    """PNGs named by `indices`, the MP4 `video` of as many frames of size x width,
    each within VIDEO_MEAN_LEVELS of its PNGs (side by side when `width` is two of
    them), and speed_info.json under the creation limit -> (ms/creation, fps,
    the largest mean abs of an MP4 frame from its PNGs)."""
    d = Path(d)
    names = [f"{i:06d}.png" for i in indices]
    n = len(names)
    dirs = [d / "gt", d / "render"] if width else [d]
    for sub in dirs:
        if pngs(sub) != names:
            raise SystemExit(f"[15] {where}: {sub} holds {len(pngs(sub))} PNGs, expected {n}")
    v = read_video(str(d / video))
    shape = (n, size, width or size, 3)
    if v.frames.shape != shape or v.fps != 30.0:
        raise SystemExit(f"[15] {where}: {video} is {v.frames.shape} at {v.fps} fps, "
                         f"expected {shape} at 30")
    worst = 0.0
    for i, name in enumerate(names):
        want = np.concatenate([codec.read_rgb(str(sub / name)) for sub in dirs], axis=1)
        worst = max(worst, float(np.abs(v.frames[i].astype(int) - want).mean()))
    if not worst <= VIDEO_MEAN_LEVELS:
        raise SystemExit(f"[15] {where}: an MP4 frame lies {worst:.3f} levels (mean abs) "
                         f"from its PNGs, over {VIDEO_MEAN_LEVELS}")
    info = json.loads((d / "speed_info.json").read_text())
    if not (0 < info["infer_time"] < CREATE_LIMIT_MS and info["render_speed"] > 0):
        raise SystemExit(f"[15] {where}: speed_info {info} (creation limit "
                         f"{CREATE_LIMIT_MS:.0f} ms)")
    return info["infer_time"], info["render_speed"], worst


def drivers(work, frame_ms, create_ms):
    """Phase 15: the inference drivers and their entry points at teacher512 widths on
    phase 14's teacher512 dataset and run directory (its checkpoints and config
    snapshot), then a micro run on the card against the CPU. -> (seconds, K1/K2/K5
    launches)."""
    t15 = time.perf_counter()
    total = {"K1": 0, "K2": 0, "K5": 0}

    def count(got):
        for k in total:
            total[k] += got[k]

    data = work / "teacher512"
    run = work / "out" / load_config(str(work / "teacher512.yaml")).TRAIN.exp_str
    snapshot = run / "config.yaml"
    cfg = load_config(str(snapshot))
    size, tile = int(cfg.MODEL.image_size), int(cfg.MODEL.raster.tile)
    ds = TrackedVideoDataset(str(data), "test", image_size=size,
                             feature_img_size=cfg.MODEL.feature_img_size,
                             origin_image_size=cfg.DATASET.origin_image_size)
    n_test = len(ds)
    out = work / "p15"
    common = ["-m", str(run), "--data_path", str(data), "--synthetic_assets"]

    # -- 0. the weights' frame 0 on this card: the instances it bins
    rt = build_runtime(cfg, synthetic_assets=True, device=DEV)
    _, weights = load_model_params(rt, str(run))
    pipe = FramePipeline.from_runtime(rt)
    avatar, _ = pipe.infer_avatar(ds[0]["source"])
    tgt = ds[0]["target"]
    body, flame = _unpack_params(_batched_params(tgt["params"], DEV))
    with torch.no_grad():
        gs = deform_avatar(avatar, rt.ehm, pipe.faces, body, flame, plan=pipe.plan,
                           compact_faces=pipe.cfaces)
        n_canon = canonical_gaussians(avatar, pipe.faces).xyz.shape[1]
    cam = Camera.from_w2c(torch.as_tensor(tgt["w2c"], device=DEV), 1.0 / float(
        cfg.MODEL.invtanfov), size, size)
    n_inst = frame_instances(gs, cam, tile)
    # the host's writes a frame beside the frame: its two PNGs and its MP4 sample
    gt = to_uint8(np.asarray(tgt["image"]) * np.asarray(tgt["mask"]))
    split = {"frame": [], "PNGs": [], "JPEG": []}
    for i in range(3):
        t0 = time.perf_counter()
        frame = pipe.render_frame(avatar, tgt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        render = to_uint8(frame["render"].cpu().numpy())
        _save_png(str(work / "p15_gt.png"), gt)
        _save_png(str(work / "p15_render.png"), render)
        t2 = time.perf_counter()
        codec.encode_jpeg(np.concatenate([gt, render], axis=1), 95)
        t3 = time.perf_counter()
        for k, v in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[k].append(v * 1e3)
    split = {k: statistics.median(v) for k, v in split.items()}
    write_share = (split["PNGs"] + split["JPEG"]) / sum(split.values())
    del rt, pipe, avatar, gs, frame
    torch.cuda.empty_cache()
    if not 0 < n_inst <= CONFIG_INSTANCE_BUDGET:
        raise SystemExit(f"[15] frame 0 of {weights} bins {n_inst} instances (budget "
                         f"{CONFIG_INSTANCE_BUDGET})")

    # -- 1. self-reenactment through `python -m guava_renderer_tpu_torch.cli.test`
    t0 = time.perf_counter()
    self_dir = out / "self"
    lines, got = run_test_cli(["-c", str(snapshot), *common, "-s", str(self_dir),
                               "--max_frames", str(P15_FRAMES)])
    self_s = time.perf_counter() - t0
    if not any(ln.startswith("[test] weights: ") and "checkpoints" in ln for ln in lines):
        raise SystemExit("[15] cli.test did not load the run's checkpoint")
    videos = sorted({k.split("/")[0] for k in ds.frames})
    if sorted(p.name for p in self_dir.iterdir()) != videos:
        raise SystemExit(f"[15] self-reenactment wrote {sorted(os.listdir(self_dir))}")
    speeds, worst = [], 0.0
    for vid in videos:
        scene = self_dir / vid
        if not (scene / "avatar.ply").is_file():
            raise SystemExit(f"[15] {vid}: no avatar.ply")
        idxs = [i for i, k in enumerate(ds.frames) if k.split("/")[0] == vid][:P15_FRAMES]
        ms, fps, err = check_dump(f"self {vid}", scene, idxs, f"{vid}_compare.mp4", size,
                                  width=2 * size)
        speeds.append((ms, fps))
        worst = max(worst, err)
    want = driver_launches(2 * len(videos), len(videos) * (P15_FRAMES + 1))
    if got != want:
        raise SystemExit(f"[15] self-reenactment launches {got}, expected {want} (a warm-up "
                         f"and a timed creation, a warm-up and {P15_FRAMES} frames a video)")
    count(got)
    say(15, f"self-reenactment through python -m guava_renderer_tpu_torch.cli.test on "
            f"{weights}: {len(videos)} videos x {P15_FRAMES} frames at {size}^2 in "
            f"{self_s:.1f} s; ms/creation (speed_info) "
            f"{', '.join(f'{m:.2f}' for m, _ in speeds)} (phase 6: {create_ms:.2f}; limit "
            f"{CREATE_LIMIT_MS:.0f}); fps {', '.join(f'{f:.2f}' for _, f in speeds)} "
            f"(phase 4's render_frame: {1e3 / frame_ms:.2f}); frame 0 bins {n_inst} instances "
            f"({n_canon} Gaussians); PNGs, avatar.ply and the compare MP4s written, each MP4 "
            f"frame within {worst:.3f} levels of its PNGs (limit {VIDEO_MEAN_LEVELS}); "
            f"launches {got}")
    say(15, f"host split of a dumped frame (ms, median of 3, host clock): render_frame "
            f"{split['frame']:.2f}, its gt and render PNGs {split['PNGs']:.2f}, its MP4 sample "
            f"(JPEG q95 of {size}x{2 * size}) {split['JPEG']:.2f}: the writes take "
            f"{write_share:.3f} of a frame")

    # -- 2. cross-reenactment and the static novel views, in this process
    t0 = time.perf_counter()
    zero_launches()
    test_cli.main([*common, "-s", str(out / "modes"), "--render_cross_act"])
    got = read_launches()
    ms_c, fps_c, _ = check_dump("cross", out / "modes" / "cross", range(n_test),
                                "cross_reenact.mp4", size)
    if got != driver_launches(2, n_test):
        raise SystemExit(f"[15] cross-reenactment launches {got}")
    count(got)
    zero_launches()
    test_cli.main([*common, "-s", str(out / "modes"), "--render_static_novel_views"])
    got = read_launches()
    ms_n, fps_n, _ = check_dump("novel views", out / "modes" / "novel_0", range(P15_VIEWS),
                                "novel_views.mp4", size)
    if got != driver_launches(2, P15_VIEWS):
        raise SystemExit(f"[15] novel-view launches {got}")
    count(got)
    torch.cuda.empty_cache()
    say(15, f"cross-reenactment ({n_test} frames) and static novel views ({P15_VIEWS} "
            f"keyframes) through cli.test's main in {time.perf_counter() - t0:.1f} s: "
            f"ms/creation {ms_c:.2f}, {ms_n:.2f}; fps {fps_c:.2f}, {fps_n:.2f}; PNG and MP4 "
            f"frame counts as expected")

    # -- 3. an EMAGE-style track -> convert_motion, resample_motion -> create_avatar ->
    # render_motion at 512^2 and 1024^2
    t0 = time.perf_counter()
    mdir = out / "motion"
    mdir.mkdir(parents=True)
    recs = [ds[i]["target"]["params"] for i in range(n_test)]
    poses = np.zeros((P15_MOTION_T, 165), np.float32)
    for t in range(P15_MOTION_T):
        p = recs[t % n_test]
        poses[t] = np.concatenate([np.reshape(p[k], -1) for k in (
            "global_pose", "body_pose", "flame_jaw", "flame_eyes", "left_hand_pose",
            "right_hand_pose")])
    emage = str(mdir / "emage.npz")
    np.savez(emage, poses=poses)
    n_30 = int(np.floor((P15_MOTION_T - 1) / P15_MOTION_FPS * 30)) + 1
    conv = convert_motion.main(["--smplx_motion", emage, "--src_fps", str(P15_MOTION_FPS),
                                "--dst_fps", "30", "-o", str(mdir / "converted.npz")])
    with np.load(conv) as z:
        if z["smplx/body_pose"].shape != (n_30, 21, 3) or float(z["fps"]) != 30.0:
            raise SystemExit(f"[15] convert_motion: {[(k, z[k].shape) for k in z.files]}")
    res = resample_motion.main(["-i", emage, "-o", str(mdir / "emage30.npz"), "--src_fps",
                                str(P15_MOTION_FPS), "--dst_fps", "30"])
    with np.load(res) as z:
        if z["poses"].shape != (n_30, 165):
            raise SystemExit(f"[15] resample_motion: poses {z['poses'].shape}")
    zero_launches()
    avatar_path = str(mdir / "avatar.pt")
    create_avatar.main([*common, "--source_video_id", videos[0], "--output_avatar_path",
                        avatar_path])
    got = read_launches()
    if got != driver_launches(2, 0) or not (mdir / "avatar.ply").is_file():
        raise SystemExit(f"[15] create_avatar: launches {got}")
    count(got)
    refined = []
    real_forward = NeuralRefiner.forward

    def recording_forward(self, x, *a, **kw):
        refined.append(tuple(x.shape[1:3]))
        return real_forward(self, x, *a, **kw)

    shapes = {}
    NeuralRefiner.forward = recording_forward
    try:
        for s in P15_MOTION_SIZES:
            zero_launches()
            refined.clear()
            mp4 = str(mdir / f"motion_{s}.mp4")
            render_motion.main(["-a", avatar_path, *common[:2], "--synthetic_assets",
                                "--smplx_motion", res, "--image_size", str(s),
                                "--max_frames", str(P15_MOTION_FRAMES), "-o", mp4])
            got = read_launches()
            v = read_video(mp4)
            shapes[s] = (v.frames.shape, sorted(set(refined)))
            if v.frames.shape != (P15_MOTION_FRAMES, s, s, 3) \
                    or refined != [(size, size)] * P15_MOTION_FRAMES \
                    or got != driver_launches(0, P15_MOTION_FRAMES):
                raise SystemExit(f"[15] render_motion at {s}: frames {v.frames.shape}, "
                                 f"refiner inputs {refined}, launches {got}")
            count(got)
    finally:
        NeuralRefiner.forward = real_forward
    torch.cuda.empty_cache()
    say(15, f"motion: a {P15_MOTION_T}-frame track at {P15_MOTION_FPS} fps, convert_motion "
            f"and resample_motion to 30 fps ({n_30} frames), create_avatar, then "
            f"render_motion of {P15_MOTION_FRAMES} frames: "
            + "; ".join(f"{s}^2 frames {shapes[s][0][1:3]}, refiner at {shapes[s][1]}"
                        for s in P15_MOTION_SIZES)
            + f"; in {time.perf_counter() - t0:.1f} s")

    # -- 4. metrics on step 1's dumps (no LPIPS-vgg weights here: LPIPS skipped)
    outs = metrics.main(["-m", str(self_dir), "--pretrained_dir", str(work / "no_lpips")])
    agg = outs[str(self_dir)]["aggregate"]
    if not all(math.isfinite(agg[k]) for k in ("psnr", "ssim", "mae")) \
            or agg["lpips"] is not None or "lpips_skipped" not in agg \
            or not all((self_dir / v / "results.json").is_file() for v in videos) \
            or not (self_dir / "results.json").is_file():
        raise SystemExit(f"[15] metrics: {agg}")
    say(15, f"metrics over {len(videos)} scenes: psnr {agg['psnr']:.4f}, ssim "
            f"{agg['ssim']:.5f}, mae {agg['mae']:.5f}; LPIPS skipped (no lpips_vgg.pt)")

    # -- 5. the app service: one cross-reenactment, polled until done
    t0 = time.perf_counter()
    zero_launches()
    svc = app.GenerationService(types.SimpleNamespace(
        model_path=str(run), synthetic_assets=True, allow_random_weights=False,
        save_dir=str(out / "app"), max_frames=P15_FRAMES, device="cuda"))
    key = svc.submit(str(data), str(data))
    polls, path, state = 0, None, "running"
    while time.perf_counter() - t0 < APP_TIMEOUT_S:
        _, path = svc.check_status(data.name, data.name)
        state = svc.jobs[key]["state"]
        polls += 1
        if path is not None and state != "done":
            raise SystemExit(f"[15] app: the video came back while the job was {state}")
        if path is not None or state == "failed":
            break
        time.sleep(APP_POLL_S)
    got = read_launches()
    if state != "done" or path is None:
        raise SystemExit(f"[15] app: job {svc.jobs[key]}, path {path}")
    v = read_video(path)
    if v.frames.shape != (P15_FRAMES, size, size, 3) or got != driver_launches(2, P15_FRAMES):
        raise SystemExit(f"[15] app: video {v.frames.shape}, launches {got}")
    count(got)
    del svc
    torch.cuda.empty_cache()
    say(15, f"app service: one cross-reenactment of {P15_FRAMES} frames done in "
            f"{time.perf_counter() - t0:.1f} s over {polls} polls {APP_POLL_S * 1e3:.0f} ms "
            f"apart; the video came back only with the job done, and reads back whole")

    # -- 6. micro: cli.test on the card against the CPU from one port checkpoint
    t0 = time.perf_counter()
    mdata, mmodel = out / "micro_ds", out / "micro_model"
    write_synthetic_dataset(str(mdata), n_videos=1, n_frames=4, image_size=48, n_shape=8,
                            n_exp=4)
    mcfg = load_config(str(MICRO_CONFIG), {"DATASET": {"data_path": str(mdata)}})
    mmodel.mkdir()
    mcfg._dump(str(mmodel / "config.yaml"))
    mrt = init_params(build_runtime(mcfg, synthetic_assets=True, device="cpu"), seed=0)
    CheckpointManager(str(mmodel)).save_latest(make_train_state(mrt.model), 0)
    del mrt
    zero_launches()
    for dev in ("cuda", "cpu"):
        test_cli.main(["-m", str(mmodel), "--data_path", str(mdata), "-s",
                       str(out / f"micro_{dev}"), "--synthetic_assets", "--device", dev])
        if dev == "cuda":
            got = read_launches()
    if got != driver_launches(2, 4 + 1):
        raise SystemExit(f"[15] micro on the card: launches {got}")
    count(got)
    limit = SMALL_CREATE_TOL * 255 + 1
    worst = 0
    for sub in ("render", "gt"):
        names = pngs(out / "micro_cuda" / "vid000" / sub)
        if len(names) != 4 or names != pngs(out / "micro_cpu" / "vid000" / sub):
            raise SystemExit(f"[15] micro {sub}: {names}")
        for name in names:
            a, b = (codec.read_rgb(str(out / f"micro_{d}" / "vid000" / sub / name)).astype(int)
                    for d in ("cuda", "cpu"))
            worst = max(worst, int(np.abs(a - b).max()))
    if not worst <= limit:
        raise SystemExit(f"[15] micro PNGs on the card vs the CPU differ by {worst} levels "
                         f"(limit {limit:.3f})")
    say(15, f"micro cli.test (micro_synthetic.yaml, a seed-0 port checkpoint) with --device "
            f"cuda and --device cpu: every render and gt PNG pair within {worst} levels "
            f"(limit SMALL_CREATE_TOL x 255 + 1 = {limit:.3f}); on the card launches {got}; "
            f"{time.perf_counter() - t0:.1f} s")
    return time.perf_counter() - t15, total



def real_schema(smi):
    """Phase 16: build_runtime under TRAIN_CONFIG on SMPL-X/FLAME files written in the
    published schema at the published counts; one warm-up and P16_CREATIONS timed
    creations, then P16_FRAMES frames; K5 on this rig's z-buffer inputs, K2 on its face
    table and K1 on frame 0 against their plain versions; the same files at micro widths
    on the card against the CPU. Returns (seconds, the main path's launches)."""
    t16 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="p16_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        paths = write_schema_assets(str(work), seed=P16_SEED)
        write_s = time.perf_counter() - t0
        counts = SCHEMA_COUNTS
        over = {"MODEL": {"smplx_assets_dir": paths["smplx_dir"],
                          "flame_assets_dir": paths["flame_dir"]}}
        cfg = load_config(str(TRAIN_CONFIG)).merge(over)

        # the host's asset load: the loaders' calls, the UV fill inside them
        spent = {"load": 0.0, "uv_fill": 0.0}

        def timed(key, fn):
            def run(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    spent[key] += time.perf_counter() - t
            return run

        kept = (bmdata.uv_face_tables, ctx_module.load_smplx, ctx_module.load_flame)
        bmdata.uv_face_tables = timed("uv_fill", kept[0])
        ctx_module.load_smplx = timed("load", kept[1])
        ctx_module.load_flame = timed("load", kept[2])
        try:
            t0 = time.perf_counter()
            rt = build_runtime(cfg, device=DEV)
            build_s = time.perf_counter() - t0
        finally:
            bmdata.uv_face_tables, ctx_module.load_smplx, ctx_module.load_flame = kept
        read_s = spent["load"] - spent["uv_fill"]
        V, F = rt.num_vertices, int(rt.smplx.faces.shape[0])
        n_texels = int(rt.extras.uvmap_mask.sum())
        want_v = counts["smplx_vertices"] + 120          # the 8 x 15 teeth rows
        if (V, rt.flame.num_vertices, rt.smplx.n_shape, rt.smplx.n_exp) != \
                (want_v, counts["flame_vertices"] + 120, 300, 50):
            raise SystemExit(f"[16] the runtime's rig: V {V}, FLAME {rt.flame.num_vertices}, "
                             f"shape/exp {rt.smplx.n_shape}/{rt.smplx.n_exp}")
        say(16, f"{counts['smplx_vertices']}-vertex, {counts['smplx_faces']}-face SMPL-X and "
                f"{counts['flame_vertices']}-vertex FLAME files written in {write_s:.2f} s; "
                f"build_runtime({TRAIN_CONFIG.name}) on them in {build_s:.2f} s, of which the "
                f"loaders {spent['load']:.3f} s host clock: npz/pkl/obj read and teeth "
                f"{read_s:.3f} s, UV fill at {rt.cfg.MODEL.uvmap_size}^2 {spent['uv_fill']:.3f} "
                f"s; V={V} F={F} (teeth included), {n_texels} chart texels; on {smi}")

        init_params(rt, seed=0)
        pipe = FramePipeline.from_runtime(rt)
        w2c = np.eye(4, dtype=np.float32)
        w2c[2, 3] = 30.0
        source = {"image": np.random.default_rng(P16_SEED).uniform(
            0, 1, (FEAT, FEAT, 3)).astype(np.float32), "w2c": w2c, "params": pose_params(300, 50)}
        targets = [{"params": pose_params(300, 50, 0.01 * i), "w2c": w2c}
                   for i in range(P16_FRAMES)]

        # the main path: creations (K5), then frames (K1, K2), counted from zero
        captured = []
        real_zbuffer = opsmesh.mesh_zbuffer
        k1.launches = k2.launches = k5.launches = 0
        opsmesh.mesh_zbuffer = lambda *a: captured.append(a) or real_zbuffer(*a)
        try:
            avatar, extra = pipe.infer_avatar(source)                 # warm-up
        finally:
            opsmesh.mesh_zbuffer = real_zbuffer
        n_kept = int(avatar.uv_valid.sum())
        n_visible = int(extra["texel_mask"].sum())
        create_ms = []
        for _ in range(P16_CREATIONS):
            (avatar, _), ms = timed_once(lambda: pipe.infer_avatar(source))
            create_ms.append(ms)
        check_avatar(avatar, "[16] creation")
        if pipe.plan is None:
            raise SystemExit("[16] the created avatar does not take the planned face gather")
        pipe.render_frame(avatar, targets[0])                          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = pipe.render_frames(avatar, targets, group=4)
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3 / P16_FRAMES
        launches = {"K1": k1.launches, "K2": k2.launches, "K5": k5.launches}
        n_create = P16_CREATIONS + 1
        if launches != {"K1": P16_FRAMES + 1, "K2": P16_FRAMES + 1,
                        "K5": n_create * k5.LAUNCHES}:
            raise SystemExit(f"[16] launches {launches} for {n_create} creations and "
                             f"{P16_FRAMES + 1} frames")
        size = pipe.image_size
        for out in outs:
            v = out["render"]
            if v.shape != (size, size, 3) or not bool(torch.isfinite(v).all()) \
                    or float(v.min()) < 0.0 or float(v.max()) > 1.0:
                raise SystemExit(f"[16] bad render {tuple(v.shape)}")
        frames = iter(targets[:5])
        busy, kernels_a_frame, _ = profile_window(
            lambda: pipe.render_frame(avatar, next(frames)), 5)
        split = creation_split(pipe, source, 1)
        tile = rt.renderer.settings.tile
        with torch.no_grad():
            body, flame = _unpack_params(_batched_params(targets[0]["params"], DEV))
            gs = deform_avatar(avatar, rt.ehm, pipe.faces, body, flame, plan=pipe.plan,
                               compact_faces=pipe.cfaces)
            cam = Camera.from_w2c(torch.as_tensor(w2c, device=DEV), pipe.tanfov, size, size)
            n_inst = frame_instances(gs, cam, tile)
        say(16, f"{n_create} creations ({P16_CREATIONS} timed: median "
                f"{statistics.median(create_ms):.2f} ms, least {min(create_ms):.2f}, most "
                f"{max(create_ms):.2f} ms host clock; split of one in ms, CUDA events: "
                + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
                + f"), then {P16_FRAMES} {size}^2 frames through render_frames: "
                f"{frame_ms:.3f} ms/frame host clock, {busy:.3f} ms/frame device busy, "
                f"{kernels_a_frame:.0f} device kernels a frame; the avatar keeps {n_kept} UV "
                f"rows ({avatar.uv_valid.shape[0]} with the pad) of {n_texels} chart texels, "
                f"{n_visible} of them visible (share {n_visible / n_texels:.4f}); frame 0 bins "
                f"{n_inst} instances at tile {tile}; launches {launches}; on {smi}")

        # the three kernels on this rig's inputs against their plain versions
        args5 = captured[0]
        got5 = k5.mesh_zbuffer(*args5)
        want5, k5_plain_ms = timed_once(lambda: k5.mesh_zbuffer_plain(*args5))
        hit = want5[0] >= 0
        if not torch.equal(got5[0], want5[0]) or not torch.equal(torch.isinf(got5[1]), ~hit):
            raise SystemExit("[16] K5 differs from its plain version on the real-schema rig")
        err5 = float((got5[1][hit] - want5[1][hit]).abs().max()) if bool(hit.any()) else 0.0
        if not err5 <= K5_DEPTH_TOL:
            raise SystemExit(f"[16] K5 depth max abs {err5} > {K5_DEPTH_TOL}")
        k5_ms = cuda_ms(lambda: k5.mesh_zbuffer(*args5))
        with torch.no_grad():
            res = ehm_forward(rt.ehm, body, flame)
            tri = res.vertices[0, pipe.cfaces.reshape(-1)].reshape(-1, 3, 3)
            table = _face_table(tri).contiguous()
            ids = pipe.plan.compact_ids
            got2, want2 = k2.face_gather(table, ids), k2.face_gather_plain(table, ids)
            if not torch.equal(got2, want2):
                raise SystemExit(f"[16] K2 differs from its plain version: max abs "
                                 f"{float((got2 - want2).abs().max())}")
            k2_ms = cuda_ms(lambda: k2.face_gather(table, ids))
            k2_plain_ms = cuda_ms(lambda: k2.face_gather_plain(table, ids))
            proj = project_gaussians(gs.xyz[0], gs.scaling[0], gs.rotation[0], gs.opacity[0],
                                     cam)
            ranges, order = bin_gaussians(proj, size, size, tile)
            rows = pack_rows(proj, gs.colors[0])
            bg = torch.zeros(32, device=DEV)
            got1 = k1.blend(rows, order, ranges, bg, size, size, tile)
            want1, k1_plain_ms = timed_once(
                lambda: k1.blend_plain(rows, order, ranges, bg, size, size, tile))
            # the random weights give this avatar colours of ~1e4: each element is held to
            # K1_TOL of its own magnitude, or to K1_TOL absolute where that is below 1
            err1 = max(float((g - w).abs().max()) for g, w in zip(got1, want1))
            rel1 = max(float(((g - w).abs() / w.abs().clamp(min=1.0)).max())
                       for g, w in zip(got1, want1))
            if not rel1 <= K1_TOL:
                raise SystemExit(f"[16] K1 vs plain: max abs {err1}, {rel1} of an element's "
                                 f"magnitude (floored at 1) > {K1_TOL}")
            k1_ms = cuda_ms(lambda: k1.blend(rows, order, ranges, bg, size, size, tile))
        say(16, f"K5 on the creation's z-buffer inputs ({args5[0].shape[0]} faces, "
                f"{args5[1].shape[0]} instances, {args5[3]}x{args5[4]}, tile {args5[5]}): best "
                f"instance equal to plain, depth max abs {err5:.3g} (tol {K5_DEPTH_TOL}), "
                f"kernel {k5_ms:.4f} ms (median of 10), plain {k5_plain_ms:.1f} ms (one call); "
                f"K2 on frame 0's face table (Fc={table.shape[0]}, N={ids.shape[0]}): equal "
                f"to plain, kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms; K1 on frame 0 "
                f"(P={rows.shape[0]}, instances={order.shape[0]}, tile {tile}): max abs vs plain "
                f"{err1:.3g}, at most {rel1:.3g} of an element's magnitude floored at 1 (tol "
                f"{K1_TOL}), "
                f"kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.1f} ms "
                f"(one call); on {smi}")
        # the rows kept hang on the random draw: opacities saturate to 0 or 1 by seed
        kept_by_seed = {}
        for seed in (1, 2):
            init_params(rt, seed=seed)
            kept_by_seed[seed] = int(pipe.infer_avatar(source)[0].uv_valid.sum())
        say(16, f"UV rows kept of the {n_texels} chart texels by init_params seed: 0 {n_kept}, "
                + ", ".join(f"{k} {v}" for k, v in kept_by_seed.items()) + f"; on {smi}")
        del rt, pipe, avatar, extra, outs, got1, want1, got5, want5, args5, captured

        # the same files at micro widths: the card against the CPU
        micro = load_config(str(MICRO_CONFIG)).merge(over)
        mw2c = np.eye(4, dtype=np.float32)
        mw2c[2, 3] = 6.0
        msrc = {"image": np.random.default_rng(1).uniform(0, 1, (28, 28, 3)).astype(np.float32),
                "w2c": mw2c, "params": pose_params(300, 50)}
        got = {}
        for key, dev in (("cpu", torch.device("cpu")), ("gpu", DEV)):
            mrt = init_params(build_runtime(micro, device=dev), seed=0)
            mpipe = FramePipeline.from_runtime(mrt)
            full, mextra = mpipe.infer_avatar(msrc, prune=False)
            pruned, _ = mpipe.infer_avatar(msrc)
            out = mpipe.render_frame(pruned, {"params": pose_params(300, 50, 0.03), "w2c": mw2c})
            got[key] = {"avatar": {k: v.cpu() for k, v in full._asdict().items()},
                        "mask": mextra["texel_mask"].cpu().reshape(-1),
                        "frame": {k: v.cpu() for k, v in out.items()}}
        agree = got["cpu"]["mask"] == got["gpu"]["mask"]
        field_err = {}
        for k, c in got["cpu"]["avatar"].items():
            g = got["gpu"]["avatar"][k]
            if k.startswith("uv_") and c.dim() >= 2 and c.shape[1] == agree.shape[0]:
                c, g = c[:, agree], g[:, agree]
            if not c.is_floating_point():
                if not torch.equal(c, g):
                    raise SystemExit(f"[16] micro creation: {k} differs on the card")
            elif k == "uv_scales":
                field_err[k] = float(((g - c).abs() / c.abs().clamp(min=1e-12)).max())
            else:
                field_err[k] = float((g - c).abs().max())
        worst = max(field_err, key=field_err.get)
        if not field_err[worst] <= SMALL_CREATE_TOL:
            raise SystemExit(f"[16] micro creation: {worst} card vs CPU {field_err[worst]} > "
                             f"{SMALL_CREATE_TOL}")
        n_differ = int((~agree).sum())
        if n_differ == 0:
            ferr = max(float((got["cpu"]["frame"][k] - got["gpu"]["frame"][k]).abs().max())
                       for k in got["cpu"]["frame"])
            if not ferr <= SMALL_CREATE_TOL:
                raise SystemExit(f"[16] micro frame: card vs CPU max abs {ferr} > "
                                 f"{SMALL_CREATE_TOL}")
            frame_note = f"frame max abs {ferr:.3g}"
        else:
            frame_note = (f"the texel masks differ at {n_differ} texels, so the frame is "
                          f"not held")
        say(16, f"the files at micro widths ({micro.MODEL.image_size}^2, chart "
                f"{micro.MODEL.uvmap_size}^2), create + frame on the card vs the CPU: avatar "
                f"fields worst {worst} {field_err[worst]:.3g} (uv_scales relative; UV terms on "
                f"the {int(agree.sum())} texels whose masks agree), {frame_note} "
                f"(tol {SMALL_CREATE_TOL})")
        return time.perf_counter() - t16, launches
    finally:
        shutil.rmtree(work, ignore_errors=True)

def p17_counts():
    torch.cuda.synchronize()
    return {"K1": k1.launches, "K2": k2.launches, "K3": k1.bwd_launches,
            "K4": k2.bwd_launches, "K5": k5.launches, "K6": k1.bf16_launches}


def p17_zero():
    k1.launches = k1.bwd_launches = k1.bf16_launches = 0
    k2.launches = k2.bwd_launches = k5.launches = 0


def p17_micro(device, batch_size):
    """The micro pipeline's model, loss and batch on `device` (seed 0)."""
    tp = make_micro_pipeline(batch_size=batch_size, seed=0, device=device)
    model = torch.nn.ModuleDict({"inferer": tp.statics.inferer, "renderer": tp.statics.renderer})
    return model, make_loss_fn(tp.statics, None), tp.batch


def p17_rank(group):
    """Phase 17 (c): one gloo rank of a micro-width data-parallel step of batch
    P17_RANKS, one sample a rank, all ranks on cuda:0."""
    model, loss_fn, batch = p17_micro(group.device, P17_RANKS)
    mesh.replicate(model, group)
    state = make_train_state(model, learning_rate=TRAIN_LR)
    p17_zero()
    loss, _ = make_parallel_train_step(loss_fn, state, group)(mesh.shard_batch(batch, group))
    counts = p17_counts()
    return {"loss": float(loss), "launches": counts,
            "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
            "grads": {n: None if p.grad is None else p.grad.cpu()
                      for n, p in model.named_parameters()},
            "jax": any(m == "jax" or m.startswith("jax.") for m in sys.modules)}


def p17_train(group):
    """Phase 17 (a), training: P17_STEPS steps of batch 1 at phase 8's widths from
    one start by make_train_step (the gradients kept), by make_parallel_train_step
    on a world of one fed those gradients (a loss whose gradient is each step's
    kept gradient: the parameters must come out bit-equal), and by
    make_parallel_train_step on the real loss (timed; K3 adds by float atomics, so
    its gradients and the parameters they lead to differ from run to run by
    rounding: a second make_train_step run gives that gap, and the parallel run
    is held to P17_DRIFT_FACTOR times it on step 1's gradients and on the
    parameters after step 1; after later steps Adam's ~lr·sign(g) updates can
    part whole blocks of small-gradient entries, so those are only reported).
    Then the parallel eval step against the plain one."""
    tcfg = InfererConfig(image_size=SIZE, uvmap_size=UV, invtanfov=INVTANFOV)
    tsc = make_train_scene(SIZE, UV, BODY_SIDE, HEAD_SIDE, feat_size=FEAT, batch_size=1,
                           device=DEV)
    statics, lpips, state, loss_fn = train_setup(tsc, tcfg, TRAIN_LR)
    model = state.model
    params = list(model.parameters())
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def run(step_of, loss):
        """-> ms and losses a step, each step's gradients, the parameters after
        the last step and after the first."""
        model.load_state_dict(start)
        step = step_of(loss, make_train_state(model, learning_rate=TRAIN_LR))
        ms, losses, grads = [], [], []
        for t in range(P17_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            value, _ = step(tsc.batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(value))
            grads.append([None if p.grad is None else p.grad.detach().clone() for p in params])
            if t == 0:
                first = [p.detach().clone() for p in params]
        return ms, losses, grads, [p.detach().clone() for p in params], first

    def replay(batch, it):
        kept = grads_s[it]
        return sum((p * g).sum() for p, g in zip(params, kept) if g is not None), {}

    def parallel(loss, st):
        return make_parallel_train_step(loss, st, group)

    ms_s, losses_s, grads_s, params_s, first_s = run(make_train_step, loss_fn)
    _, _, grads_r, params_r, _ = run(parallel, replay)
    for t in range(P17_STEPS):
        if not all((a is None and b is None) or (a is not None and b is not None
                                                 and torch.equal(a, b))
                   for a, b in zip(grads_r[t], grads_s[t])):
            raise SystemExit(f"[17] the parallel step changed the gradient of step {t}")
    if not all(torch.equal(a, b) for a, b in zip(params_r, params_s)):
        raise SystemExit("[17] the parallel step on one rank is not bit-equal to make_train_step")
    del grads_r, params_r
    counts = p17_counts()
    ms_p, losses_p, grads_p, params_p, first_p = run(parallel, loss_fn)
    counts = {k: v - counts[k] for k, v in p17_counts().items()}
    if not all(math.isfinite(v) for v in losses_p):
        raise SystemExit(f"[17] parallel losses {losses_p}")
    _, losses_s2, grads_s2, params_s2, first_s2 = run(make_train_step, loss_fn)  # the rerun gap
    drift = {"grad": p17_gap(grads_p[0], grads_s[0]), "first": p17_gap(first_p, first_s),
             "last": p17_gap(params_p, params_s)}
    gap = {"grad": p17_gap(grads_s2[0], grads_s[0]), "first": p17_gap(first_s2, first_s),
           "last": p17_gap(params_s2, params_s)}
    del grads_p, grads_s2, params_s2, first_p, first_s2
    # held: step 1's gradients by their largest entry, the parameters after it by L2
    for k, i in (("grad", 0), ("first", 1)):
        if not drift[k][i] <= P17_DRIFT_FACTOR * gap[k][i]:
            raise SystemExit(f"[17] the parallel run on the real loss lies {drift[k]} from "
                             f"make_train_step's ({k}; relative, L2), two make_train_step runs "
                             f"{gap[k]} (tol x{P17_DRIFT_FACTOR})")
    eval_fn = trainer_loop.eval_metrics_fn(statics)
    model.load_state_dict(start)
    plain = eval_fn(tsc.batch)
    par = make_parallel_eval_step(eval_fn, group)(tsc.batch)
    if par != plain:
        raise SystemExit(f"[17] parallel eval {par} differs from {plain}")
    return {"ms_single": ms_s, "ms_parallel": ms_p, "losses_single": losses_s,
            "losses_parallel": losses_p, "losses_rerun": losses_s2, "drift": drift, "gap": gap,
            "eval": par, "launches": counts, "n_params": sum(p.numel() for p in params)}


def p17_pair(tr, key):
    d, g = tr["drift"][key], tr["gap"][key]
    return f"({d[0]:.3g}, {d[1]:.3g}) vs ({g[0]:.3g}, {g[1]:.3g})"


def p17_gap(got, want):
    """Two runs' tensors (gradients or parameters, None where a parameter has
    no gradient) -> (the largest over tensors of max |got - want| / max |want|,
    the L2 norm of got - want over all of them). The two must have gradients
    on the same parameters."""
    if [g is None for g in got] != [w is None for w in want]:
        raise SystemExit("[17] the two runs have gradients on different parameters")
    pairs = [(g.float(), w.float()) for g, w in zip(got, want) if w is not None]
    rel = max(float((g - w).abs().max() / w.abs().max().clamp(min=1e-30)) for g, w in pairs)
    l2 = math.sqrt(sum(float(((g - w).double() ** 2).sum()) for g, w in pairs))
    return rel, l2


def multi_device(smi, pipe, main_avatar, targets, seq, sc):
    """Phase 17: the multi-device paths on one card. (a) a world of one
    (P17_BACKEND) on this process: the parallel train and eval steps at phase 8's
    widths, the frames-DP render of P17_FRAMES bench frames (bit-equal to phase 4's
    render_frame frames) and the row-band wrapper (one band: bit-equal to
    rasterize); (b) in this process, the P17_BANDS bands of bench frame 0 by
    render_band (K1, then K6 under bf16_rows) against the full frame, and the frame
    shards of P17_RANKS x 2 ranks against the sequential frames, with the band K1
    times; (c) P17_RANKS gloo ranks on cuda:0, a micro-width data-parallel step of
    batch P17_RANKS against one process's; then knn_mean_sq_dist on frame 0's
    Gaussians, card against CPU. Returns (seconds, the launches of K1-K6)."""
    t17 = time.perf_counter()
    p17_zero()
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="p17_", dir=ROOT / "build"))
    frames = targets[:P17_FRAMES]
    bg = torch.linspace(0, 1, 32, device=DEV)
    st = RasterizeSettings(tile=TILE)
    st16 = st._replace(bf16_rows=True)
    with torch.no_grad():
        body, flame = _unpack_params(_batched_params(frames[0]["params"], DEV))
        gs = deform_avatar(main_avatar, sc.ehm, pipe.faces, body, flame, plan=pipe.plan,
                           compact_faces=pipe.cfaces)
    args = (gs.xyz[0], gs.colors[0], gs.opacity[0], gs.scaling[0], gs.rotation[0])
    try:
        # (a)
        t0 = time.perf_counter()
        group = mesh.init_group(0, 1, DEV, str(work / "rendezvous"), P17_BACKEND)
        init_s = time.perf_counter() - t0
        try:
            tr = p17_train(group)
            torch.cuda.empty_cache()
            before = p17_counts()
            brend = make_batch_frame_renderer(pipe, group)
            brend(main_avatar, frames[:1])                  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            renders, raws = brend(main_avatar, frames)
            torch.cuda.synchronize()
            dp_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
            if not all(torch.equal(renders[i], seq[i]["render"])
                       and torch.equal(raws[i], seq[i]["raw"]) for i in range(len(frames))):
                raise SystemExit("[17] the frames-DP render is not bit-equal to render_frame")
            with torch.no_grad():
                full = rasterize(*args, sc.cam, bg, st)
                sharded = rasterize_row_sharded(*args, sc.cam, bg, group, st)
            if not all(torch.equal(a, b) for a, b in zip(full, sharded)):
                raise SystemExit("[17] the row-band wrapper on one rank is not rasterize")
            frame_counts = {k: v - before[k] for k, v in p17_counts().items()}
        finally:
            mesh.close_group()
        say(17, f"(a) a {P17_BACKEND} world of one on {torch.cuda.get_device_name(0)} (joined in "
                f"{init_s:.2f} s): make_parallel_train_step bit-equal to make_train_step over "
                f"{P17_STEPS} steps of batch 1 at phase 8's widths ({tr['n_params'] / 1e6:.1f}M "
                f"parameters) when fed the same gradients; on the real loss ms/step parallel "
                f"{', '.join(f'{v:.1f}' for v in tr['ms_parallel'])} vs single "
                f"{', '.join(f'{v:.1f}' for v in tr['ms_single'])}, losses "
                f"{tr['losses_parallel']} vs {tr['losses_single']} (a rerun "
                f"{tr['losses_rerun']}); from make_train_step's run, as (largest entry over "
                f"each tensor's largest, L2), the parallel run vs a make_train_step rerun: "
                f"step 1's gradients {p17_pair(tr, 'grad')}, the parameters after step 1 "
                f"{p17_pair(tr, 'first')} (held: the gradients' first, the parameters' L2, "
                f"to x{P17_DRIFT_FACTOR} the rerun's; K3's atomics), after step {P17_STEPS} "
                f"{p17_pair(tr, 'last')} (not held); launches {tr['launches']}; "
                f"eval {tr['eval']} equal to the plain eval; frames-DP {len(frames)} frames "
                f"{dp_ms:.2f} ms/frame, bit-equal to phase 4's; the row-band wrapper bit-equal "
                f"to rasterize; frame launches {frame_counts}; on {smi}")

        # (b)
        before = p17_counts()
        with torch.no_grad():
            full16 = rasterize(*args, sc.cam, bg, st16)
            c0 = p17_counts()
            bands = [render_band(d, P17_BANDS, *args, sc.cam, bg, st) for d in range(P17_BANDS)]
            c1 = p17_counts()
            bands16 = [render_band(d, P17_BANDS, *args, sc.cam, bg, st16)
                       for d in range(P17_BANDS)]
            c2 = p17_counts()
        blends = {"f32": (c1["K1"] - c0["K1"], c1["K6"] - c0["K6"]),
                  "bf16_rows": (c2["K1"] - c1["K1"], c2["K6"] - c1["K6"])}
        if blends != {"f32": (P17_BANDS, 0), "bf16_rows": (0, P17_BANDS)}:
            raise SystemExit(f"[17] the bands' blends (K1, K6) {blends}: each f32 band must be "
                             f"one K1 and each bf16_rows band one K6")
        moved = max(float(((torch.cat([b[i] for b in bands16], 1)
                            - torch.cat([b[i] for b in bands], 1)).abs()
                           / full[i].abs().clamp(min=1.0)).max()) for i in (0, 2))
        if not moved > P17_BF16_MOVES:
            raise SystemExit(f"[17] the bf16_rows bands lie {moved} from the f32 bands, not "
                             f"over {P17_BF16_MOVES}: bf16_rows was not honoured")
        errs = {}
        for key, got, want in (("f32", bands, full), ("bf16", bands16, full16)):
            for i, name in ((0, "color"), (2, "invdepth")):
                cat = torch.cat([b[i] for b in got], 1)
                errs[key, name] = float(((cat - want[i]).abs()
                                         / want[i].abs().clamp(min=1.0)).max())
        bf16_ref = max(float(((full16[i] - full[i]).abs() / full[i].abs().clamp(min=1.0)).max())
                       for i in (0, 2))
        if not max(errs["f32", n] for n in ("color", "invdepth")) <= P17_BAND_TOL:
            raise SystemExit(f"[17] f32 bands vs the full frame {errs} > {P17_BAND_TOL}")
        if not (bf16_ref > 0 and max(errs["bf16", n] for n in ("color", "invdepth"))
                <= P17_BF16_FACTOR * bf16_ref):
            raise SystemExit(f"[17] bf16 bands vs the bf16 frame {errs}, the bf16 frame vs f32 "
                             f"{bf16_ref}")
        per_rank = len(frames) // P17_RANKS
        shards = [pipe.render_frame(main_avatar, t) for r in range(P17_RANKS)
                  for t in frames[r * per_rank:(r + 1) * per_rank]]
        if not all(torch.equal(a["render"], b["render"]) for a, b in zip(shards, seq)):
            raise SystemExit("[17] the frame shards differ from the sequential frames")
        band_counts = {k: v - before[k] for k, v in p17_counts().items()}
        preps = [band_prep(d, P17_BANDS, *args, sc.cam, st) for d in range(P17_BANDS)]
        whole = band_prep(0, 1, *args, sc.cam, st)
        h = SIZE // P17_BANDS
        band_ms = [cuda_ms(lambda p=p: k1.blend(p.rows, p.order, p.ranges, bg, h, SIZE, TILE))
                   for p in preps]
        full_ms = cuda_ms(lambda: k1.blend(whole.rows, whole.order, whole.ranges, bg, SIZE, SIZE,
                                           TILE))
        say(17, f"(b) {P17_BANDS} bands of {h}x{SIZE} of bench frame 0 ({args[0].shape[0]} "
                f"Gaussians) by render_band: f32 (K1) vs the full frame color "
                f"{errs['f32', 'color']:.3g}, invdepth {errs['f32', 'invdepth']:.3g} of the "
                f"magnitude floored at 1 (tol {P17_BAND_TOL}); bf16_rows (K6) vs the bf16 frame "
                f"{errs['bf16', 'color']:.3g} / {errs['bf16', 'invdepth']:.3g}, where the bf16 "
                f"frame lies {bf16_ref:.3g} from f32 (tol x{P17_BF16_FACTOR}) and the bf16 "
                f"bands {moved:.3g} from the f32 bands (over {P17_BF16_MOVES}); the bands' "
                f"blends (K1, K6) {blends}; {P17_RANKS} frame "
                f"shards of {per_rank} bit-equal to the sequential frames; K1 a band "
                f"{', '.join(f'{v:.4f}' for v in band_ms)} ms ({sum(band_ms):.4f} summed; "
                f"instances {', '.join(str(p.order.numel()) for p in preps)}) vs one full-frame "
                f"K1 {full_ms:.4f} ms ({whole.order.numel()} instances); launches {band_counts}; "
                f"on {smi}")

        # (c)
        t0 = time.perf_counter()
        ranks = mesh.launch(P17_RANKS, p17_rank, devices=[torch.device("cuda", 0)] * P17_RANKS,
                            backend="gloo")
        launch_s = time.perf_counter() - t0
        model, loss_fn, batch = p17_micro(DEV, P17_RANKS)
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}
        state_b = make_train_state(model, learning_rate=TRAIN_LR)
        loss_b, _ = make_train_step(loss_fn, state_b)(batch)
        shard_grads = {}
        for r in range(P17_RANKS):
            model.load_state_dict(start)
            model.zero_grad(set_to_none=True)
            loss_fn(split_batch(batch, r), 0)[0].backward()
            for n, p in model.named_parameters():
                if p.grad is not None:
                    shard_grads[n] = shard_grads.get(n, 0) + p.grad / P17_RANKS
        r0, r1 = ranks[0], ranks[1]
        if any(r["jax"] for r in ranks):
            raise SystemExit("[17] a rank imported JAX")
        if not all(torch.equal(r0["params"][n], r1["params"][n]) for n in r0["params"]):
            raise SystemExit("[17] the gloo ranks' parameters differ")
        loss_err = abs(r0["loss"] - float(loss_b)) / abs(float(loss_b))
        grad_err = max(float((r0["grads"][n] - g.cpu()).abs().max()
                             / g.abs().max().clamp(min=1e-30)) for n, g in shard_grads.items())
        if sorted(n for n, g in r0["grads"].items() if g is not None) != sorted(shard_grads) \
                or not loss_err <= P17_LOSS_RTOL or not grad_err <= P17_GRAD_TOL:
            raise SystemExit(f"[17] gloo DP step: loss {loss_err} (tol {P17_LOSS_RTOL}), "
                             f"gradient {grad_err} (tol {P17_GRAD_TOL})")
        rank_counts = {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}
        say(17, f"(c) {P17_RANKS} gloo ranks on cuda:0 (spawned, joined and done in "
                f"{launch_s:.1f} s): a micro-width DP step of batch {P17_RANKS}, parameters "
                f"bit-equal on the ranks, loss {r0['loss']:.6f} vs one process's batch-"
                f"{P17_RANKS} step {float(loss_b):.6f} ({loss_err:.3g}, tol {P17_LOSS_RTOL}), "
                f"gradient vs one process's mean of the samples' {grad_err:.3g} of each tensor's "
                f"largest entry (tol {P17_GRAD_TOL}); the ranks' launches {rank_counts}")
        del model, start, shard_grads

        # kNN on the bench avatar's Gaussians
        pts = args[0].detach().contiguous()
        knn_mean_sq_dist(pts)                           # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = knn_mean_sq_dist(pts)
        torch.cuda.synchronize()
        knn_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = knn_mean_sq_dist(pts.cpu())
        knn_cpu_ms = (time.perf_counter() - t0) * 1e3
        knn_err = float((got.cpu() - want).abs().max() / want.abs().max())
        if not knn_err <= P17_KNN_RTOL:
            raise SystemExit(f"[17] knn card vs CPU {knn_err} > {P17_KNN_RTOL}")
        say(17, f"knn_mean_sq_dist over {pts.shape[0]} Gaussians: card {knn_ms:.2f} ms, CPU "
                f"{knn_cpu_ms:.1f} ms (host clock), card vs CPU {knn_err:.3g} of the largest "
                f"(tol {P17_KNN_RTOL}); on {smi}")

        launches = {k: tr["launches"][k] + frame_counts[k] + band_counts[k]
                    + rank_counts.get(k, 0) for k in band_counts}
        for k in ("K1", "K2", "K3", "K5", "K6"):
            if launches[k] == 0:
                raise SystemExit(f"[17] {k} was not launched: {launches}")
        return time.perf_counter() - t17, launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def r1_axes(x, size, align_corners=False, antialias=True):
    """resize_bilinear's cached tables (layers._resize_axis) of x resized to size."""
    H, W = x.shape[-2:]
    return (layers._resize_axis(H, size[0], align_corners, antialias, x.device),
            layers._resize_axis(W, size[1], align_corners, antialias, x.device))


def r1_gap(x, by, bx):
    """max |R1 - its plain version| of x through the bands (by, bx)."""
    got = kresize.resize(x, by, bx)
    want = kresize.resize_plain(x, by, bx)
    return float((got.float() - want.float()).abs().max())


def r1_bytes(x, size):
    """Least bytes of a resize: x read once and the output written once."""
    B, C = x.shape[:2]
    return (x.numel() + B * C * size[0] * size[1]) * x.element_size()


def resize_kernel():
    """Phase 18: R1, the banded resize (kernels/resize.py). (a) every
    caller's ratio (R1_RATIOS) in float32, bfloat16 and float16, on NCHW and
    on an NHWC view, forward tables and adjoint tables, bit-equal to the
    plain version; (b) the frame's two resizes (the (1, 32, 2048^2) NHWC
    features to 512^2, the (1, 3, 512^2) RGB back to 2048^2) against the
    plain version, timed in turns with the same resize as two launches
    through a (B, C, h, W) intermediate (identity tables on the other axis)
    and with F.interpolate(bilinear, antialias=True), a yardstick that the
    port never calls; (c) the training step's largest resizes, forward and
    backward (autograd through resize_bilinear) against the plain version on
    the forward and adjoint tables. -> the kernels line's R1 entry (main
    adds its launches: the main path's, counted in phases 6 and 8)."""
    t0 = time.perf_counter()
    g = torch.Generator(device=DEV).manual_seed(18)
    worst, n_checked = 0.0, 0
    for n_in, n_out, ac, aa in R1_RATIOS.values():
        m_in, m_out = n_in // 2 + 1, n_out // 2 + 1
        for dtype in R1_DTYPES:
            for nhwc in (False, True):
                shape = (2, n_in, m_in, 5) if nhwc else (2, 5, n_in, m_in)
                x = torch.randn(shape, generator=g, device=DEV).to(dtype)
                x = x.permute(0, 3, 1, 2) if nhwc else x
                ay, ax = r1_axes(x, (n_out, m_out), ac, aa)
                dy = torch.randn((2, 5, n_out, m_out), generator=g, device=DEV).to(dtype)
                worst = max(worst, r1_gap(x, ay.fwd, ax.fwd), r1_gap(dy, ay.adj, ax.adj))
                n_checked += 2
    if worst != 0.0:
        raise SystemExit(f"R1 differs from its plain version by up to {worst}")
    say(18, f"R1 on {n_checked} cases ({len(R1_RATIOS)} ratios x 3 types x NCHW/NHWC x "
            f"forward/adjoint): bit-equal to its plain version")

    # (b) the frame's two resizes
    feats = torch.rand((1, 4 * SIZE, 4 * SIZE, 32), generator=g, device=DEV).permute(0, 3, 1, 2)
    rgb = torch.rand((1, 3, SIZE, SIZE), generator=g, device=DEV)
    at = {}
    for name, x, size in (("frame down", feats, (SIZE, SIZE)),
                          ("frame up", rgb, (4 * SIZE, 4 * SIZE))):
        ay, ax = r1_axes(x, size)
        eye_x = kresize.make_band(np.eye(x.shape[3], dtype=np.float32), DEV)
        eye_y = kresize.make_band(np.eye(size[0], dtype=np.float32), DEV)

        def two_pass(x=x, ay=ay, ax=ax, eye_x=eye_x, eye_y=eye_y):
            return kresize.resize(kresize.resize(x, ay.fwd, eye_x), eye_y, ax.fwd)

        got = kresize.resize(x, ay.fwd, ax.fwd)
        err = float((got - kresize.resize_plain(x, ay.fwd, ax.fwd)).abs().max())
        if err != 0.0 or not torch.equal(two_pass(), got):
            raise SystemExit(f"R1 at the {name}: {err} from its plain version, or the two "
                             f"launches differ from the one")
        t = turn_times({"R1": lambda x=x, ay=ay, ax=ax: kresize.resize(x, ay.fwd, ax.fwd),
                        "two launches": two_pass,
                        "F.interpolate": lambda x=x, size=size: torch.nn.functional.interpolate(
                            x, size=size, mode="bilinear", align_corners=False, antialias=True)})
        n_bytes = r1_bytes(x, size)
        tw, cc, wsp, smem = kresize.launch_shape(x.shape[1], ay.fwd, ax.fwd,
                                                 x.stride(1) < x.stride(3))
        at[name] = {"ms": statistics.median(t["R1"]), "ms_spread": least_most(t["R1"]),
                    "two_pass_ms": statistics.median(t["two launches"]),
                    "library_ms": statistics.median(t["F.interpolate"]),
                    "plain_ms": cuda_ms(lambda x=x, ay=ay, ax=ax: kresize.resize_plain(
                        x, ay.fwd, ax.fwd), reps=3, warmup=1),
                    "bytes": n_bytes, "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
                    "taps": [ay.fwd.k, ax.fwd.k], "cta": {"columns": tw, "channels": cc,
                                                          "pitch": wsp, "smem_bytes": smem},
                    "ctas_per_sm": kresize.occupancy(smem)}
        a = at[name]
        say(18, f"R1 {name} {tuple(x.shape)} -> {size}: {a['ms']:.4f} ms (turns "
                f"{a['ms_spread'][0]:.4f}-{a['ms_spread'][1]:.4f}), bound {a['bound_ms']:.4f} "
                f"({n_bytes / 1e6:.1f} MB, {a['bound_ms'] / a['ms']:.3f} of it reached); two "
                f"launches {a['two_pass_ms']:.4f}; F.interpolate {a['library_ms']:.4f}; plain "
                f"{a['plain_ms']:.4f}; {a['taps']} taps, CTA {a['cta']}, "
                f"{a['ctas_per_sm']} CTAs an SM")
    del feats, rgb

    # (c) the training step's largest resizes, forward and backward
    train = {}
    for name, shape, size, aa, nhwc in (
            ("source 518", (R1_BATCH, 518, 518, 3), (SIZE, SIZE), True, True),
            ("rgb pyramid 148", (R1_BATCH, 3, 518, 518), (148, 148), True, False),
            ("fusion 148", (R1_BATCH, R1_PATH_CHANNELS, 148, 148), (296, 296), False, False),
            ("dpt path", (R1_BATCH, R1_PATH_CHANNELS, 296, 296), (SIZE, SIZE), False, False)):
        x = torch.randn(shape, generator=g, device=DEV)
        x = x.permute(0, 3, 1, 2) if nhwc else x
        x.requires_grad_(True)
        ay, ax = r1_axes(x, size, antialias=aa)
        out = layers.resize_bilinear(x, size, antialias=aa)
        dy = torch.randn(out.shape, generator=g, device=DEV)
        (dx,) = torch.autograd.grad(out, x, dy)
        xd = x.detach()
        err = float((out.detach() - kresize.resize_plain(xd, ay.fwd, ax.fwd)).abs().max())
        err_b = float((dx - kresize.resize_plain(dy, ay.adj, ax.adj)).abs().max())
        if err != 0.0 or err_b != 0.0:
            raise SystemExit(f"R1 at the training step's {name}: forward {err}, backward "
                             f"{err_b} from the plain version")
        fwd_ms = cuda_ms(lambda: kresize.resize(xd, ay.fwd, ax.fwd))
        bwd_ms = cuda_ms(lambda: kresize.resize(dy, ay.adj, ax.adj))
        train[name] = {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                       "fwd_bound_ms": r1_bytes(xd, size) / HBM_BYTES_PER_S * 1e3,
                       "bwd_bound_ms": r1_bytes(dy, shape[2:] if not nhwc else shape[1:3])
                       / HBM_BYTES_PER_S * 1e3}
        tr = train[name]
        say(18, f"R1 training {name} {tuple(x.shape)} -> {size}: forward {fwd_ms:.4f} ms "
                f"(bound {tr['fwd_bound_ms']:.4f}), backward {bwd_ms:.4f} ms (bound "
                f"{tr['bwd_bound_ms']:.4f}); both bit-equal to the plain version")
        del x, xd, out, dy, dx
    torch.cuda.empty_cache()
    say(18, f"phase 18 in {time.perf_counter() - t0:.1f} s")
    frame = list(at.values())
    return {"name": "R1 banded resize", "route": "cuda",
            "source": "guava_renderer_tpu_torch/csrc/resize.cu", "replaces": None,
            "max_abs_err": worst, "ms": sum(a["ms"] for a in frame),
            "plain_ms": sum(a["plain_ms"] for a in frame),
            "bound_ms": sum(a["bound_ms"] for a in frame), "bound_by": "bytes",
            "library_ms": sum(a["library_ms"] for a in frame),
            "two_pass_ms": sum(a["two_pass_ms"] for a in frame), "at": at, "training": train,
            "ptxas": ptxas_usage("resize_kernelIfE")}


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
           f"({'built now' if build.build_log else 'cached'})")
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

    k1.launches = k2.launches = kresize.launches = 0
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
    if kresize.launches:
        raise SystemExit(f"frames at the refiner's size launched R1 {kresize.launches} times")
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
    k1.launches = k2.launches = k5.launches = kresize.launches = 0
    create_ms = []
    for _ in range(N_CREATIONS):
        t0 = time.perf_counter()
        created, cextra = cpipe.infer_avatar(csc.source)
        torch.cuda.synchronize()
        create_ms.append((time.perf_counter() - t0) * 1e3)
    create_launches, create_r1 = k5.launches, kresize.launches
    if create_launches != N_CREATIONS * k5.LAUNCHES or k1.launches or k2.launches \
            or create_r1 != N_CREATIONS * R1_CREATION:
        raise SystemExit(f"{N_CREATIONS} creations launched K5 {create_launches} times, "
                         f"K1 {k1.launches}, K2 {k2.launches}, R1 {create_r1}: expected one K5 "
                         f"call ({k5.LAUNCHES} launches) and {R1_CREATION} R1 a creation")
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
           f"K5 launches {create_launches}, R1 {create_r1}; visible faces {n_visible} of {csc.faces.shape[0]}, "
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
    # "tf32" repeats the card's run with TF32 forced on: a control the frame hold must see
    for key, dev in (("cpu", torch.device("cpu")), ("gpu", DEV), ("tf32", DEV)):
        with tf32_forced() if key == "tf32" else contextlib.nullcontext():
            ssc = make_create_scene(64, 64, 21, 7, feat_size=70, device=dev)
            sinf = init_params_(UbodyGaussianInferer(scfg, ssc.smplx.num_vertices),
                                torch.Generator().manual_seed(2))
            sref = init_params_(NeuralRefiner(64, style_dim=64, num_mlp=2, channel_scale=4.0),
                                torch.Generator().manual_seed(1), gain=P7_REFINER_GAIN)
            spipe = FramePipeline(ssc.ehm, ssc.faces, sref, inferer=sinf,
                                  uv_tables=ssc.uv_tables, image_size=64, invtanfov=INVTANFOV,
                                  settings=RasterizeSettings(tile=16), device=dev)
            full, sextra = spipe.infer_avatar(ssc.source, prune=False)
            scam = Camera.from_w2c(torch.as_tensor(ssc.source["w2c"], device=dev),
                                   1.0 / INVTANFOV, 64, 64)
            face_idx = rasterize_mesh(sextra["ehm_result"].vertices[0], ssc.faces,
                                      scam).face_idx
            pruned, _ = spipe.infer_avatar(ssc.source)
            frame = spipe.render_frame(pruned, targets[3])
            # reported, not held: the same frame refined at the flax gain
            spipe.renderer.neural_refiner = init_params_(
                NeuralRefiner(64, style_dim=64, num_mlp=2, channel_scale=4.0),
                torch.Generator().manual_seed(1)).to(dev)
            flax_render = spipe.render_frame(pruned, targets[3])["render"]
        small[key] = {"avatar": {k: v.cpu() for k, v in full._asdict().items()},
                      "face_idx": face_idx.cpu(), "n_uv": pruned.uv_colors.shape[1],
                      "frame": {k: v.cpu() for k, v in frame.items()},
                      "flax_render": flax_render.cpu()}
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
    cframe_err, tf32_err = (
        max(float((small["cpu"]["frame"][k] - small[key]["frame"][k]).abs().max())
            for k in small["cpu"]["frame"]) for key in ("gpu", "tf32"))
    if not cframe_err <= P7_FRAME_TOL:
        raise SystemExit(f"64^2 create->render: GPU vs CPU max abs {cframe_err} > {P7_FRAME_TOL}")
    if not tf32_err > P7_FRAME_TOL:
        raise SystemExit(f"64^2 create->render with TF32 forced on: GPU vs CPU max abs "
                         f"{tf32_err}, within {P7_FRAME_TOL}: the frame hold cannot see TF32")
    flax_err = {key: float((small["cpu"]["flax_render"] - small[key]["flax_render"]).abs().max())
                for key in ("gpu", "tf32")}
    say(7, f"64^2 create -> render on the GPU vs the CPU (plain kernels): face_idx equal "
           f"({int((small['gpu']['face_idx'] >= 0).sum())} hit pixels), avatar fields worst "
           f"{worst} {field_err[worst]:.3g} (uv_scales relative; tol {SMALL_CREATE_TOL}), frame "
           f"max abs {cframe_err:.3g} (tol {P7_FRAME_TOL}) with the refiner at gain "
           f"{P7_REFINER_GAIN}; the control with TF32 forced on {tf32_err:.3g}, over the tol as "
           f"it must be; reported: refined at the flax gain (1), the frames lie "
           f"{flax_err['gpu']:.3g} apart, {flax_err['tf32']:.3g} with TF32 forced on")
    del small


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
    kresize.launches = 0
    with tempfile.TemporaryDirectory() as run_dir:
        train_on_batches(state, loss_fn, statics, [tsc.batch], n_steps, run_dir,
                     valid_batches=[tsc.batch], check_interval=10 ** 9, log_every=n_steps,
                     count_scrubbed=True, on_step=on_step, log=train_log.append)
        torch.cuda.synchronize()
        t_saved = time.perf_counter()
        train_launches = {"K1": k1.launches, "K3": k1.bwd_launches, "K5": k5.launches,
                          "R1": kresize.launches}
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
    # a step calls K1 and K5 once an item; the closing validation adds one of each, and
    # R1 a creation's, without the backward
    if train_launches != {"K1": n_steps + 1, "K3": n_steps,
                          "K5": (n_steps + 1) * k5.LAUNCHES,
                          "R1": (n_steps + 1) * R1_CREATION + n_steps * R1_STEP_BACKWARD}:
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
    say(8, f"{n_steps} training steps of batch 1 at full width through train_on_batches "
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
    k1.launches = k1.bwd_launches = k5.launches = kresize.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss2, metrics2 = make_sample_scan_step(loss_fn, state, count_scrubbed=True)(tsc2.batch)
    torch.cuda.synchronize()
    accum_ms = (time.perf_counter() - t0) * 1e3
    accum_launches = {"K1": k1.launches, "K3": k1.bwd_launches, "K5": k5.launches,
                      "R1": kresize.launches}
    if accum_launches != {"K1": 2, "K3": 2, "K5": 2 * k5.LAUNCHES,
                          "R1": 2 * (R1_CREATION + R1_STEP_BACKWARD)} \
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

    # ---- 13. the config-driven runtime and the bench script ----
    say(13, f"phase 13 in {config_runtime():.1f} s on {smi}")

    # ---- 14. the data layer and the config-driven, loader-driven trainer ----
    # ---- 15. the inference drivers and entry points, on phase 14's dataset and run ----
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="p14_", dir=ROOT / "build"))
    try:
        t14, p14_launches = phase14(work)
        say(14, f"phase 14 in {t14:.1f} s on {smi}; its launches {p14_launches}")
        t15, p15_launches = drivers(work, seq_ms, med_create)
        say(15, f"phase 15 in {t15:.1f} s on {smi}; its launches {p15_launches}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 16. the real-schema runtime ----
    t16, p16_launches = real_schema(smi)
    say(16, f"phase 16 in {t16:.1f} s on {smi}; its launches {p16_launches}")

    # ---- 17. the multi-device paths on one card ----
    t17, p17 = multi_device(smi, pipe, main_avatar, targets, seq, sc)
    say(17, f"phase 17 in {t17:.1f} s on {smi}; its launches {p17}")
    for entry in variant_kernels:
        if entry["name"].startswith("K6"):
            entry["launches"] += p17["K6"]

    # ---- 18. the banded resize R1 ----
    r1 = resize_kernel()
    r1["launches"] = create_r1 + train_launches["R1"] + accum_launches["R1"]

    kernels = [
        {"name": "K1 tile blend", "route": "cuda",
         "source": "guava_renderer_tpu_torch/csrc/blend.cu",
         "replaces": "guava_renderer_tpu/ops/gsplat.py:1018",
         "launches": (launches["K1"] + p14_launches["K1"] + p15_launches["K1"]
                      + p16_launches["K1"] + p17["K1"]),
         "max_abs_err": err1, "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_bound_by, "library_ms": None, **occ["K1"], "at_tiles": at_tiles},
        {"name": "K2 face gather", "route": "cuda",
         "source": "guava_renderer_tpu_torch/csrc/facegather.cu",
         "replaces": "guava_renderer_tpu/ops/facegather.py:125",
         "launches": launches["K2"] + p15_launches["K2"] + p16_launches["K2"] + p17["K2"],
         "max_abs_err": err2, "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": k2_lib_ms, "floor_ms": k2_floor_ms, **k2_occ},
        {"name": "K3 tile blend backward", "route": "cuda",
         "source": "guava_renderer_tpu_torch/csrc/blend_bwd.cu",
         "replaces": "guava_renderer_tpu/ops/gsplat.py:1457",
         "launches": train_launches["K3"] + p14_launches["K3"] + p17["K3"],
         "max_abs_err": err3, "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_bound_by, "library_ms": None, **occ["K3"]},
        {"name": "K4 face gather backward", "route": "cuda",
         "source": "guava_renderer_tpu_torch/csrc/facegather_bwd.cu",
         "replaces": "guava_renderer_tpu/ops/facegather.py:143",
         "launches": planned_launches["K4"] + p17["K4"], "max_abs_err": err4, "ms": k4_ms,
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": "bytes",
         "library_ms": k4_lib_ms},
        {"name": "K5 mesh z-buffer", "route": "cuda",
         "source": "guava_renderer_tpu_torch/csrc/meshraster.cu",
         "replaces": "guava_renderer_tpu/ops/meshraster.py:39",
         "launches": (create_launches + train_launches["K5"] + accum_launches["K5"]
                      + p14_launches["K5"] + p15_launches["K5"] + p16_launches["K5"]
                      + p17["K5"]),
         "max_abs_err": err5, "ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound,
         "bound_by": k5_bound_by, "library_ms": None, "model_cull": cull5,
         **k5_occ},
        *variant_kernels,
        *probe_kernels,
        r1,
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
