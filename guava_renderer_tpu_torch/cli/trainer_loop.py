"""Training loop (counterpart of `guava_renderer_tpu/cli/trainer_loop.py`,
cut to what needs no dataset).

Per iteration: batch -> train step -> moving-average logging; every
`check_interval` steps and at the end, validation (PSNR and SSIM of the
refined render), a `latest` checkpoint and, when the SSIM improves, a `best`
one. The batches come from any iterable; the loader, the image grids and the
configuration-driven entry point of the JAX package are not here yet.
"""

from __future__ import annotations

import itertools
from collections import defaultdict, deque
from typing import Callable, Iterable

import torch

from ..ops.ssim import psnr, ssim
from ..train.checkpoints import CheckpointManager
from ..train.pipeline import PipelineStatics, forward_pipeline
from ..train.trainstep import TrainState, make_sample_scan_step, make_train_step


class MovingAverageMeter:
    """Moving averages over the last `window` iterations."""

    def __init__(self, window: int = 100):
        self._values: dict[str, deque] = defaultdict(lambda: deque(maxlen=window))

    def update(self, metrics: dict) -> None:
        for k, v in metrics.items():
            self._values[k].append(float(v))

    def averages(self) -> dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self._values.items() if v}

    def format(self) -> str:
        return " ".join(f"{k}={v:.4f}" for k, v in sorted(self.averages().items()))


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
    """Mean PSNR and SSIM over the validation batches (zeros for none)."""
    vals = [eval_fn(b) for b in valid_batches]
    if not vals:
        return {"psnr": 0.0, "ssim": 0.0}
    return {k: sum(v[k] for v in vals) / len(vals) for k in ("psnr", "ssim")}


def run_training(state: TrainState, loss_fn: Callable, statics: PipelineStatics,
                 batches: Iterable[dict], n_steps: int, run_dir: str, *,
                 valid_batches: Iterable[dict] = (), check_interval: int = 1000,
                 log_every: int = 100, resume: str | None = None,
                 per_sample: bool = False, count_scrubbed: bool = False,
                 on_step: Callable[[int, torch.Tensor, dict], None] | None = None,
                 log: Callable[[str], None] = print) -> TrainState:
    """Train `state` in place until iteration `n_steps`, cycling over `batches`.

    `resume` names a checkpoint file to start from (its iteration counts as
    done). `per_sample` takes the accumulation step. `on_step(it, loss,
    metrics)` sees every step's detached results. Returns the state; the
    checkpoints are under `<run_dir>/checkpoints`.
    """
    ckpts = CheckpointManager(run_dir)
    if resume:
        state, done = ckpts.restore(state, resume)
        log(f"warm start from {resume} at iter {done}")
    make_step = make_sample_scan_step if per_sample else make_train_step
    step = make_step(loss_fn, state, count_scrubbed=count_scrubbed)
    eval_fn = eval_metrics_fn(statics)
    valid_batches = list(valid_batches)
    meter = MovingAverageMeter()
    train_iter = itertools.cycle(batches)
    for it in range(state.iteration + 1, n_steps + 1):
        loss, metrics = step(next(train_iter))
        meter.update(metrics)
        if on_step is not None:
            on_step(it, loss, metrics)
        if it % log_every == 0 or it == n_steps:
            log(f"iter {it}: {meter.format()}")
        if it % check_interval == 0 or it == n_steps:
            val = run_validation(eval_fn, valid_batches)
            log(f"validation @{it}: psnr={val['psnr']:.3f} ssim={val['ssim']:.4f}")
            ckpts.save_latest(state, it)
            if val["ssim"] > ckpts.best_ssim():
                ckpts.save_best(state, it, val["ssim"])
    return state
