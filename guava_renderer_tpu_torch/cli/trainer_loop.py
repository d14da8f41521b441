"""The training loop (counterpart of `guava_renderer_tpu/cli/trainer_loop.py`,
the reference Trainer's role, main/trainer.py:13-301).

`run_training(rt, train_ds, valid_ds, run_dir, ...)` is the config-driven
entry: it snapshots the run (config, git revision, sources), starts from
`init_params(rt)` or a `basemodel` checkpoint, and trains on batches of
`TRAIN.batch_size` from a prefetching loader (per-sample accumulation under
`TRAIN.host_accum`, a recomputed forward under `TRAIN.remat`), with a
GT / refined / raw image grid every `visual_interval`. With `n_devices` =
n > 1 it is data-parallel over n ranks of `parallel/mesh.py`, one process a
device: the batch size is rounded to a multiple of n, every rank trains on
its slice of each batch (the parallel step, or the accumulation step under
host_accum), validation is averaged over the ranks, and rank 0 alone logs,
writes visuals and writes checkpoints.

`train_on_batches` is its inner loop, and takes batches from any iterable:
batch -> train step -> moving-average logging (with it/s, the step's ms and
the ms spent waiting for the batch); every `check_interval` steps and at
the end, validation (PSNR and SSIM of the refined render), a `latest`
checkpoint and, when the SSIM improves, a `best` one.
"""

from __future__ import annotations

import itertools
import os
import shutil
import subprocess
import time
from collections.abc import Iterator
from typing import Callable, Iterable

import numpy as np
import torch

from ..data.codec import write_image
from ..data.loader import DeviceBatches, PrefetchLoader, endless
from ..ops.ssim import psnr, ssim
from ..parallel.mesh import current_group, launch, replicate
from ..train.checkpoints import CheckpointManager
from ..train.pipeline import PipelineStatics, forward_pipeline, make_loss_fn
from ..train.trainstep import (
    TrainState, make_accum_train_step, make_parallel_eval_step, make_parallel_train_step,
    make_sample_scan_step, make_train_state, make_train_step, split_batch, split_samples)
from ..utils.logging_utils import (  # noqa: F401  (MovingAverageMeter: this module's API)
    MovingAverageMeter, SpeedMeter, build_logger, profiler_trace)
from .context import Runtime, init_params

NAMED_CHECKPOINT = 100000      # iteration kept as a named snapshot (as the JAX trainer)


def eval_metrics_fn(statics: PipelineStatics) -> Callable[[dict], dict]:
    """-> fn(batch) -> {"psnr", "ssim"} of the clamped refined render against
    the masked target, as floats."""

    @torch.no_grad()
    def fn(batch):
        outputs, _, _ = forward_pipeline(batch, statics)
        gt = batch["target"]["image"] * batch["target"]["mask"]
        r = torch.clamp(outputs.renders, 0, 1)
        return {"psnr": float(psnr(r, gt).mean()), "ssim": float(ssim(r, gt))}

    return fn


def run_validation(eval_fn: Callable[[dict], dict], valid_batches: Iterable[dict]) -> dict:
    """Mean PSNR and SSIM over the validation batches (zeros for none). On a
    rank, `eval_fn` is the parallel eval step and each batch the rank's slice."""
    vals = [eval_fn(b) for b in valid_batches]
    if not vals:
        return {"psnr": 0.0, "ssim": 0.0}
    return {k: sum(v[k] for v in vals) / len(vals) for k in ("psnr", "ssim")}


def _make_step(loss_fn, state, per_sample, count_scrubbed, group):
    if group is None:
        make_step = make_sample_scan_step if per_sample else make_train_step
        return make_step(loss_fn, state, count_scrubbed=count_scrubbed)
    if not per_sample:
        return make_parallel_train_step(loss_fn, state, group, count_scrubbed=count_scrubbed)
    # host-accum: each rank's samples are its slices of the microbatches
    accum = make_accum_train_step(loss_fn, state, group, count_scrubbed=count_scrubbed)
    return lambda batch: accum(split_samples(batch))


def train_on_batches(state: TrainState, loss_fn: Callable, statics: PipelineStatics,
                     batches: Iterable[dict], n_steps: int, run_dir: str, *,
                     valid_batches: Iterable[dict] = (), check_interval: int = 1000,
                     log_every: int = 100, resume: str | None = None,
                     per_sample: bool = False, count_scrubbed: bool = False,
                     on_step: Callable[[int, torch.Tensor, dict], None] | None = None,
                     log: Callable[[str], None] = print,
                     profile_dir: str | None = None, group=None) -> TrainState:
    """Train `state` in place until iteration `n_steps`.

    `batches` is an iterator, taken as it comes, or a collection, cycled.
    `valid_batches` is read whole at every check (a collection, or a
    re-iterable loader). `resume` names a checkpoint file to start from (its
    iteration counts as done). `per_sample` takes the accumulation step.
    `on_step(it, loss, metrics)` sees every step's detached results. With
    `profile_dir`, the second iteration (the first after a warm-up) is traced
    there by torch.profiler. Returns the state; the checkpoints are under
    `<run_dir>/checkpoints`.

    With `group` (`parallel/mesh.py`) this is one rank of a data-parallel
    run: `batches` and `valid_batches` are its slices, the step is the
    parallel step (the accumulation step, a sample of each rank a
    microbatch, with `per_sample`), validation is averaged over the ranks,
    and rank 0 alone logs, profiles and writes checkpoints. Every rank
    restores `resume`.
    """
    lead = group is None or group.rank == 0
    if not lead:
        log = _quiet
    ckpts = CheckpointManager(run_dir)
    if resume:
        state, done = ckpts.restore(state, resume)
        log(f"warm start from {resume} at iter {done}")
    step = _make_step(loss_fn, state, per_sample, count_scrubbed, group)
    eval_fn = eval_metrics_fn(statics)
    if group is not None:
        eval_fn = make_parallel_eval_step(eval_fn, group)
    if isinstance(valid_batches, Iterator):
        valid_batches = list(valid_batches)
    meter, speed = MovingAverageMeter(), SpeedMeter()
    train_iter = batches if isinstance(batches, Iterator) else itertools.cycle(batches)
    profile_it = state.iteration + 2 if profile_dir and lead else None
    for it in range(state.iteration + 1, n_steps + 1):
        with profiler_trace(profile_dir if it == profile_it else None):
            t0 = time.perf_counter()
            batch = next(train_iter)
            t1 = time.perf_counter()
            with speed.time_frame():
                loss, metrics = step(batch)
                meter.update(metrics)          # float(): the step's one sync
            t2 = time.perf_counter()
        if it == profile_it:
            log(f"profiler trace of iteration {it} written to {profile_dir}")
        if on_step is not None:
            on_step(it, loss, metrics)
        if it % log_every == 0 or it == n_steps:
            log(f"iter {it}: {meter.format()} ({speed.render_fps:.2f} it/s; step "
                f"{(t2 - t1) * 1e3:.1f} ms, batch wait {(t1 - t0) * 1e3:.1f} ms)")
        if it % check_interval == 0 or it == n_steps:
            val = run_validation(eval_fn, valid_batches)
            log(f"validation @{it}: psnr={val['psnr']:.3f} ssim={val['ssim']:.4f}")
            if lead:
                ckpts.save_latest(state, it)
                if val["ssim"] > ckpts.best_ssim():
                    ckpts.save_best(state, it, val["ssim"])
        if it == NAMED_CHECKPOINT and lead:
            ckpts.save_named(str(NAMED_CHECKPOINT), state, it)
    return state


def _quiet(msg: str) -> None:
    pass


# -- the config-driven entry ---------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SNAPSHOT_DIRS = ("guava_renderer_tpu_torch", "configs")
SNAPSHOT_FILES = ("chip_smoke.py", "bench_torch.py")


def _save_grid(path: str, rows: list[np.ndarray]) -> None:
    grid = np.concatenate([np.concatenate(list(r), axis=1) for r in rows], axis=0)
    grid = np.clip(grid * 255.0, 0, 255).astype(np.uint8)
    write_image(path, grid)


def _snapshot_run(run_dir: str, rt: Runtime) -> None:
    """config.yaml, git_rev.txt and a copy of the sources under codes/
    (ref: main/trainer.py:276-294), so a run is reproducible without the
    checkout; a failure is printed and never fatal."""
    os.makedirs(run_dir, exist_ok=True)
    rt.cfg._dump(os.path.join(run_dir, "config.yaml"))
    try:
        rev = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                             cwd=REPO).stdout.strip()
        with open(os.path.join(run_dir, "git_rev.txt"), "w") as f:
            f.write(rev + "\n")
    except Exception:
        pass
    try:
        codes = os.path.join(run_dir, "codes")
        if os.path.isdir(codes):
            shutil.rmtree(codes)
        for sub in SNAPSHOT_DIRS:
            src = os.path.join(REPO, sub)
            if os.path.isdir(src):
                shutil.copytree(src, os.path.join(codes, sub), ignore=shutil.ignore_patterns(
                    "__pycache__", "*.pyc", "*.so", "*.o", "*.npz", "*.pt"))
        for f in SNAPSHOT_FILES:
            src = os.path.join(REPO, f)
            if os.path.isfile(src):
                shutil.copy2(src, os.path.join(codes, f))
    except Exception as e:  # snapshot failure must never kill training
        print(f"[trainer] codes snapshot failed: {e}")


def _dump_visuals(statics: PipelineStatics, batch: dict, vis_dir: str, it: int) -> None:
    """A GT / refined / raw grid of the batch's first two items; a failure
    is printed and never fatal."""
    try:
        with torch.no_grad():
            outputs = forward_pipeline(batch, statics)[0]
        tgt = batch["target"]
        gt = (tgt["image"] * tgt["mask"]).cpu().numpy()
        n = min(2, gt.shape[0])
        _save_grid(os.path.join(vis_dir, f"training_{it}.jpg"),
                   [gt[:n], outputs.renders[:n].cpu().numpy(),
                    outputs.raw_renders[:n].cpu().numpy()])
    except Exception as e:  # visuals must never kill training
        print(f"[visuals] skipped: {e}")


def run_training(rt: Runtime, train_ds, valid_ds, run_dir: str, basemodel: str | None = None,
                 debug: bool = False, max_iters: int | None = None,
                 n_devices: int | None = None, profile_dir: str | None = None) -> TrainState:
    """Train the runtime's modules on `train_ds` as `rt.cfg` says, on
    `rt.device`; validate on `valid_ds`. Returns the train state.

    `n_devices` = n > 1 trains data-parallel over n ranks. Called on every
    rank of a group of n (`parallel/mesh.py`; `cli.train --devices` starts
    them), each rank trains `rt` on its device. Called outside a group, it
    launches n ranks of `rt.device`'s kind (cuda:0..n-1, or gloo ranks on
    the CPU), each building its runtime from `rt.cfg`, and loads rank 0's
    trained state into `rt`'s modules. Inside a group, `n_devices` None
    means the group's size."""
    group = current_group()
    n = n_devices or (group.size if group is not None else 1)
    if group is None and n > 1:
        return _launch_training(rt, train_ds, valid_ds, run_dir, n, dict(
            basemodel=basemodel, debug=debug, max_iters=max_iters, profile_dir=profile_dir))
    if group is not None and n != group.size:
        raise ValueError(f"n_devices={n} on a group of {group.size} ranks")
    lead = group is None or group.rank == 0
    cfg = rt.cfg
    log = _quiet
    vis_dir = os.path.join(run_dir, "visuals_training", "train_render")
    if lead:
        log = build_logger("train", run_dir).info
        _snapshot_run(run_dir, rt)
        os.makedirs(vis_dir, exist_ok=True)

    if group is not None:
        log(f"data-parallel over {n} ranks ({group.backend}, rank 0 on {group.device})")
    batch_size = int(cfg.TRAIN.batch_size)
    if batch_size % n:
        batch_size = max(n, (batch_size // n) * n)
        log(f"batch_size rounded to {batch_size} for {n} devices")
    init_params(rt)
    if group is not None:          # the ranks start bit-equal
        replicate(rt.model, group)
        replicate(rt.lpips, group)
    state = make_train_state(rt.model, **_optimizer_kwargs(cfg))
    loss_fn = make_loss_fn(rt.statics, rt.lpips, remat=bool(cfg.TRAIN.get("remat", False)))
    # TRAIN.host_accum: one sample of each rank at a time, gradients
    # accumulated over the batch; the effective batch stays batch_size
    host_accum = bool(cfg.TRAIN.get("host_accum", False)) and batch_size > n
    if host_accum:
        log(f"host-accum: {batch_size // n} samples x {n}/step")

    pin = rt.device.type == "cuda"
    shard = dict(rank=group.rank, world_size=n) if group is not None else {}
    train = DeviceBatches(PrefetchLoader(train_ds, batch_size, shuffle=True, pin_memory=pin,
                                         **shard), rt.device)
    valid = DeviceBatches(PrefetchLoader(valid_ds, n if host_accum else batch_size,
                                         shuffle=False, drop_last=True, pin_memory=pin, **shard),
                          rt.device)
    visual_interval = int(cfg.TRAIN.get("visual_interval", 1000))

    def on_step(it, loss, metrics):
        if lead and it % visual_interval == 0:
            batch = train.last
            _dump_visuals(rt.statics, split_batch(batch, 0) if host_accum else batch, vis_dir, it)

    return train_on_batches(
        state, loss_fn, rt.statics, endless(train), max_iters or int(cfg.TRAIN.train_iter),
        run_dir, valid_batches=valid, check_interval=int(cfg.TRAIN.check_interval),
        log_every=1 if debug else 100, resume=basemodel, per_sample=host_accum,
        on_step=on_step, log=log, profile_dir=profile_dir, group=group)


def _optimizer_kwargs(cfg) -> dict:
    opt = cfg.OPTIMIZE
    return dict(learning_rate=float(opt.learning_rate), lr_decay_rate=float(opt.lr_decay_rate),
                lr_decay_iter=int(opt.lr_decay_iter))


def _training_rank(group, cfg, synthetic_assets, train_ds, valid_ds, run_dir, kw):
    from .context import build_runtime

    rt = build_runtime(cfg, synthetic_assets=synthetic_assets, device=group.device)
    state = run_training(rt, train_ds, valid_ds, run_dir, n_devices=group.size, **kw)
    return state.state_dict() if group.rank == 0 else None


def _launch_training(rt: Runtime, train_ds, valid_ds, run_dir: str, n: int, kw: dict):
    """run_training over n spawned ranks; rank 0's final state lands in `rt`."""
    saved = launch(n, _training_rank, rt.cfg, rt.synthetic_assets, train_ds, valid_ds, run_dir,
                   kw, device=rt.device.type)[0]
    state = make_train_state(rt.model, **_optimizer_kwargs(rt.cfg))
    state.load_state_dict(saved)
    return state
