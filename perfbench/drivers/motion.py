"""Offline motion rendering: `FramePipeline.render_frame` in a closed loop at
batch 1, each frame's RGB copied to the host before the next is sent, as
`cli/render_motion.py` and `cli/test.py` take every frame. The client
receives each RGB into one pinned host buffer, as a renderer that streams
frames to an encoder does (`render_motion`'s own `.cpu()` into fresh
pageable memory costs ~22 ms a 2048² frame, paced by the host: PERF.md).

Set-up builds the runtime from the configuration (`cli/context.py:
build_runtime`, the synthetic rig), fills the refiner with seeded weights,
makes the avatar from the seeded draws on the runtime's rig and prepares it
(`FramePipeline.prepare_avatar`: prune, face-sort plan), and renders frames
spread over the motion once to load the kernels and warm the allocator.
The window then sends the motion's frames in order, looping, until
`--seconds` have passed. A seeded sample of the window's frames keeps its
outputs; once the window has closed and the port's state is freed, the
reference renders those targets again and each output is compared.
"""

from __future__ import annotations

import time

import numpy as np

from perfbench import counts
from perfbench.harness import Check, log

OUTPUTS = ("render", "raw", "invdepth")


def rel_rms(a, b) -> float:
    """||a - b|| / ||b|| over all elements (float64 sums)."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def frame_gaps(out: dict, ref: dict) -> dict:
    """{output: relative RMS gap of `out`'s to `ref`'s}, on `ref`'s device."""
    return {k: rel_rms(out[k].to(ref[k].device), ref[k]) for k in OUTPUTS}


def sample_frames(seed: int, n: int, within: int) -> list[int]:
    """The window frames whose outputs are compared: `n` of the first `within`, from the seed."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 7])
    return sorted(int(i) for i in rng.choice(within, size=n, replace=False))


def build(run):
    """The seed-independent part of set-up: the runtime and its pipeline."""
    with run.part("imports"):
        from guava_renderer_tpu_torch.cli.context import build_runtime
        from guava_renderer_tpu_torch.cli.inference import FramePipeline
        from guava_renderer_tpu_torch.kernels import build as kernels
        from guava_renderer_tpu_torch.utils.config import ConfigDict
    if run.device.type == "cuda":
        with run.part("kernel_load"):
            kernels.library()
    with run.part("runtime"):
        rt = build_runtime(ConfigDict(run.cell.config["config"]), synthetic_assets=True,
                           device=run.device)
        pipe = FramePipeline.from_runtime(rt)
    return rt, pipe


def seeded(run, rt, pipe, seed: int):
    """The seed's weights, avatar (prepared by the pipeline) and motion."""
    from guava_renderer_tpu_torch.avatar.state import GaussianAvatar
    from perfbench.inputs import avatar_draws, fill_weights, on_rig

    model = run.cell.config["config"]["MODEL"]
    with run.part("weights"):
        fill_weights(rt.renderer.neural_refiner.refiner, seed,
                     float(run.cell.config["assumed"]["weight_gain"]))
    with run.part("avatar"):
        draws = avatar_draws(int(run.cell.config["assumed"]["avatar_seed"]), seed,
                             rt.smplx.num_vertices, int(model["uvmap_size"]) ** 2, run.device)
        avatar = pipe.prepare_avatar(GaussianAvatar(**on_rig(draws, rt.smplx, rt.extras,
                                                                run.device)))
    targets = run.cell.generator().generate(run.cell.traffic, seed, rt.smplx.n_shape,
                                            rt.smplx.n_exp)
    return avatar, targets


def run(run) -> None:
    cell, check = run.cell, run.cell.workload["check"]
    import torch

    rt, pipe = build(run)
    avatar, targets = seeded(run, rt, pipe, run.seed)
    n_gauss = int(avatar.vtx_positions.shape[1] + avatar.uv_local_xyz.shape[1])
    with run.part("warmup"):
        size = int(cell.config["config"]["MODEL"]["image_size"])
        rgb = torch.empty((size, size, 3), pin_memory=run.device.type == "cuda")
        # frames spread over the motion, whose poses bin the fewest to the most instances
        for i in np.linspace(0, len(targets) - 1, int(cell.traffic["warmup_frames"])).astype(int):
            rgb.copy_(pipe.render_frame(avatar, targets[i])["render"])
    log(f"Gaussians a frame: {n_gauss} (after prune and pad); UV rows kept "
        f"{int(avatar.uv_valid.sum())}; planned gather {pipe.plan is not None}")

    log("set-up parts (s): " + ", ".join(f"{k} {v:.3f}" for k, v in run.setup_parts.items()))
    keep = set(sample_frames(run.seed, int(check["frames"]), int(check["within"])))
    kept, lat = {}, []
    n = len(targets)
    with run.window():
        start = time.perf_counter()
        i = 0
        while True:
            t0 = time.perf_counter()
            out = pipe.render_frame(avatar, targets[i % n])
            rgb.copy_(out["render"])
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if i in keep:
                kept[i] = out
            i += 1
            if t1 - start >= run.seconds:
                break
    run.attempted = i
    run.values["frames_per_s"] = i / run.window_s
    run.counts["frame_p95_ms"] = float(np.percentile(np.asarray(lat) * 1e3, 95))
    log(f"set-up {run.setup_s:.3f} s; window: {i} frames in {run.window_s:.4f} s; frame ms median "
        f"{np.median(lat) * 1e3:.4f}, p95 {run.counts['frame_p95_ms']:.4f}, "
        f"max {max(lat) * 1e3:.4f}")

    # the port's outputs to the host, its state freed, then the reference
    kept = {i: {k: out[k].cpu() for k in OUTPUTS} for i, out in kept.items()}
    del pipe, rt, avatar, out
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    check_against_reference(run, kept, targets)


def check_against_reference(run, kept: dict, targets: list) -> dict:
    """Render the kept frames' targets by the reference and append one check
    per output: the largest relative RMS gap over the kept frames. -> the gaps."""
    from perfbench.reference.frame import ReferenceFrames

    model = run.cell.config["config"]["MODEL"]
    limits = run.cell.workload["check"]["limits"]
    assumed = run.cell.config["assumed"]
    t0 = time.perf_counter()
    ref = ReferenceFrames(model, run.seed, run.device, float(assumed["weight_gain"]),
                          int(assumed["avatar_seed"]))
    # no frame compared is no evidence: the gaps stay NaN and fail
    gaps = {k: (0.0 if kept else float("nan")) for k in OUTPUTS}
    pairs, instances = [], []
    for i, out in sorted(kept.items()):
        r = ref.frame(targets[i % len(targets)])
        pairs.append(r["pairs"])
        instances.append(r["instances"])
        got = frame_gaps(out, r)
        gaps = {k: max(gaps[k], got[k]) for k in OUTPUTS}
        log(f"frame {i} (target {i % len(targets)}): instances {r['instances']}, contributing "
            f"pairs {r['pairs']}; gaps " + ", ".join(f"{k} {v:.4g}" for k, v in got.items()))
    for k in OUTPUTS:
        run.checks.append(Check(f"{k}_rel_rms", gaps[k], float(limits[k])))
    log(f"reference: {len(kept)} frames in {time.perf_counter() - t0:.1f} s")
    if kept:
        size, tile = ref.size, ref.tile
        n_gauss = int(ref.avatar.vtx_positions.shape[1] + ref.avatar.uv_local_xyz.shape[1])
        run.counts.update(
            frames=run.attempted, size=size, tile=tile, gaussians=n_gauss,
            pairs_per_frame=float(np.mean(pairs)), instances_per_frame=float(np.mean(instances)),
            refiner_flops=refiner_flops(ref), resize_flops=resize_flops(ref))
    return gaps


def refiner_flops(ref) -> float:
    """The refiner's matrix products and convolutions a frame, on its shapes."""
    import copy

    r = ref.refiner_size
    return counts.module_flops(copy.deepcopy(ref.refiner), (1, 32, r, r))


def resize_flops(ref) -> float:
    """The two bilinear resizes' taps a frame (none where the sizes agree)."""
    if ref.refiner_size == ref.size:
        return 0.0
    return (counts.bilinear_taps_flops(32, ref.size, ref.refiner_size)
            + counts.bilinear_taps_flops(3, ref.refiner_size, ref.size))


def calibration(cell, seeds, control_seeds, fault_seeds, device):
    """Yield, for each seed, the largest gap over the frames a run of that
    seed compares of each output: the port's ({"port": ...}) and, for the
    control seeds, the reference's in TF32 ({"control": ...}), each to the
    float32 reference. The planted faults of this cell are the tests'."""
    from perfbench import harness
    from perfbench.reference.frame import ReferenceFrames

    check, assumed = cell.workload["check"], cell.config["assumed"]
    model = cell.config["config"]["MODEL"]
    run = harness.Run(cell, seeds[0], 0.0, False, device)
    rt, pipe = build(run)
    for seed in seeds:
        avatar, targets = seeded(run, rt, pipe, seed)
        frames = sample_frames(seed, int(check["frames"]), int(check["within"]))
        outs = {}
        for i in frames:
            out = pipe.render_frame(avatar, targets[i % len(targets)])
            outs[i] = {k: out[k].clone() for k in OUTPUTS}
        ref = ReferenceFrames(model, seed, device, float(assumed["weight_gain"]),
                              int(assumed["avatar_seed"]))
        port, control = [], []
        for i in frames:
            r = ref.frame(targets[i % len(targets)])
            port.append(frame_gaps(outs[i], r))
            if seed in control_seeds:
                control.append(frame_gaps(ref.frame(targets[i % len(targets)], tf32=True), r))

        def worst(per_frame):
            return {k: max(g[k] for g in per_frame) for k in OUTPUTS} if per_frame else None
        del ref, outs
        yield {"seed": seed, "frames": frames, "port": worst(port), "control": worst(control)}
