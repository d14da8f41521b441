"""The train step (counterpart of `guava_renderer_tpu/train/trainstep.py`).

Optimizer parity with the reference: Adam with betas (0, 0.99), eps 1e-8 and
no weight decay; parameters whose name contains `style_mlp` or
`final_linear` at 0.1x the learning rate; a linear decay of the learning
rate from 1 to `lr_decay_rate` over `lr_decay_iter` steps. Non-finite
gradient entries are set to 0 before the update (`nan_to_num_`).

The multi-device steps run on every rank of a process group
(`parallel/mesh.py`), each on its local slice of the global batch:
`make_parallel_train_step`, `make_accum_train_step` (microbatches on the
host) and `make_parallel_eval_step`. The gradients, the loss and the metrics
are averaged over the ranks by explicit all-reduces after `backward()`, the
counterpart of the JAX step's `jax.lax.pmean`, and the NaN scrub runs after
that mean, as it runs first in the JAX optimizer: a non-finite entry on one
rank is zeroed on every rank. Every rank then takes the same update from
the same numbers, so the ranks' parameters stay bit-equal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from ..parallel.mesh import all_reduce_mean_
from ..utils.logging_utils import span, spanned

SLOW_MARKERS = ("style_mlp", "final_linear")   # parameter groups at 0.1x lr
SLOW_SCALE = 0.1


@dataclasses.dataclass
class TrainState:
    model: nn.Module                      # every trained parameter (e.g. a ModuleDict)
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    iteration: int = 0                    # steps taken so far

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "iteration": self.iteration}

    def load_state_dict(self, sd: dict) -> None:
        """The weights, the Adam moments and the schedule's position come from
        `sd`; the optimizer's hyperparameters and schedule stay this state's
        own (its run's config), as a JAX run's schedule is its config's and not
        in its checkpoints."""
        self.model.load_state_dict(sd["model"])
        own_groups = self.optimizer.state_dict()["param_groups"]
        self.optimizer.load_state_dict({"state": sd["optimizer"]["state"],
                                        "param_groups": own_groups})
        # rebuilt one step before the saved position: its first step sets each lr there
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, self.scheduler.lr_lambdas,
            last_epoch=int(sd["scheduler"]["last_epoch"]) - 1)
        self.iteration = int(sd["iteration"])


def lr_labels(model: nn.Module) -> dict[str, str]:
    """Parameter name -> 'slow' (style_mlp / final_linear) or 'normal'."""
    return {name: "slow" if any(m in name for m in SLOW_MARKERS) else "normal"
            for name, p in model.named_parameters() if p.requires_grad}


def make_optimizer(model: nn.Module, learning_rate: float = 1e-4, lr_decay_rate: float = 0.03,
                   lr_decay_iter: int = 200000):
    """-> (Adam over two parameter groups, its linear-decay scheduler). Step
    the scheduler once after every optimizer step."""
    labels = lr_labels(model)
    named = dict(model.named_parameters())
    groups = []
    for label, scale in (("normal", 1.0), ("slow", SLOW_SCALE)):
        params = [named[n] for n, lab in labels.items() if lab == label]
        if params:
            groups.append({"params": params, "lr": learning_rate * scale})
    optimizer = torch.optim.Adam(groups, betas=(0.0, 0.99), eps=1e-8, weight_decay=0.0)

    def factor(step: int) -> float:
        return 1.0 + (lr_decay_rate - 1.0) * min(step, lr_decay_iter) / lr_decay_iter

    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


def make_train_state(model: nn.Module, **optimizer_kwargs) -> TrainState:
    optimizer, scheduler = make_optimizer(model, **optimizer_kwargs)
    return TrainState(model, optimizer, scheduler, 0)


def scrub_nan_grads(model: nn.Module, count: bool = False) -> torch.Tensor | None:
    """Set every non-finite gradient entry to 0, in place. With `count`,
    return how many entries that was (a 0-d tensor on the gradients' device)."""
    n = None
    for p in model.parameters():
        if p.grad is None:
            continue
        if count:
            bad = (~torch.isfinite(p.grad)).sum()
            n = bad if n is None else n + bad
        p.grad.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)
    return n


@spanned("guava.update")
def _update(state: TrainState, count_scrubbed: bool):
    scrubbed = scrub_nan_grads(state.model, count=count_scrubbed)
    state.optimizer.step()
    state.scheduler.step()
    state.iteration += 1
    return scrubbed


def _accumulate(loss_fn: Callable, state: TrainState, batches: list):
    """Zero the gradients, then backward each batch's loss (over len(batches)
    when there are several), so `.grad` holds the mean gradient. -> the mean
    loss and metrics, detached."""
    state.optimizer.zero_grad(set_to_none=True)
    n = len(batches)
    loss_sum, metric_sum = None, {}
    for batch in batches:
        loss, metrics = loss_fn(batch, state.iteration)
        with span("guava.backward"):
            (loss if n == 1 else loss / n).backward()     # .grad accumulates over the batches
        loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        for k, v in metrics.items():
            metric_sum[k] = metric_sum[k] + v.detach() if k in metric_sum else v.detach()
    return loss_sum / n, {k: v / n for k, v in metric_sum.items()}


def _finish(state: TrainState, loss, metrics, count_scrubbed: bool):
    scrubbed = _update(state, count_scrubbed)
    if scrubbed is not None:
        metrics["scrubbed_grads"] = scrubbed
    return loss, metrics


def make_train_step(loss_fn: Callable, state: TrainState, count_scrubbed: bool = False):
    """loss_fn(batch, iteration) -> (loss, metrics). -> step(batch) -> (loss,
    metrics), detached; the step updates `state` in place. With
    `count_scrubbed`, metrics gains "scrubbed_grads"."""

    @spanned("guava.train_step")
    def step(batch):
        return _finish(state, *_accumulate(loss_fn, state, [batch]), count_scrubbed)

    return step


def split_batch(batch, index: int):
    """Item `index` of every tensor of a nested batch, kept as a batch of 1."""
    if isinstance(batch, dict):
        return {k: split_batch(v, index) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor) and batch.dim() > 0:
        return batch[index:index + 1]
    return batch


def batch_size(batch) -> int:
    if isinstance(batch, dict):
        return batch_size(next(iter(batch.values())))
    return batch.shape[0]


def split_samples(batch) -> list:
    """A nested batch as a list of batches of 1."""
    return [split_batch(batch, i) for i in range(batch_size(batch))]


def make_sample_scan_step(loss_fn: Callable, state: TrainState, count_scrubbed: bool = False):
    """`make_train_step` with per-sample gradient accumulation: the batch is
    processed one sample at a time, each as a batch of 1, and the gradients
    and metrics are averaged. Every loss term is a per-sample mean, so the
    result equals the batched step up to the order of float sums, while the
    activations held at any time are one sample's."""

    @spanned("guava.train_step")
    def step(batch):
        return _finish(state, *_accumulate(loss_fn, state, split_samples(batch)), count_scrubbed)

    return step


# -- the multi-device steps ----------------------------------------------------

def _reduce(state: TrainState, group, loss, metrics):
    """Average the gradients, the loss and the metrics over the ranks, in
    place of `.grad`: one all-reduce of the loss, the metrics and which
    parameters have a gradient on this rank, then one of the gradients a
    dtype. A parameter with a gradient on some rank gets the mean (zeros
    where a rank has none); one with a gradient on no rank keeps None."""
    params = [p for p in state.model.parameters() if p.requires_grad]
    keys = sorted(metrics)
    dev = group.device
    head = torch.cat([
        torch.tensor([p.grad is not None for p in params], dtype=torch.float32, device=dev),
        loss.reshape(1).float().to(dev),
        *(metrics[k].reshape(1).float().to(dev) for k in keys)])
    all_reduce_mean_([head], group)
    live = [p for p, h in zip(params, head[:len(params)].tolist()) if h > 0]
    for p in live:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_mean_([p.grad for p in live], group)
    n = len(params)
    return head[n].to(loss.dtype), {k: head[n + 1 + i].to(metrics[k].dtype)
                                    for i, k in enumerate(keys)}


def make_parallel_train_step(loss_fn: Callable, state: TrainState, group,
                             count_scrubbed: bool = False):
    """The data-parallel step on one rank of `group` (`parallel/mesh.py`),
    counterpart of the JAX `make_parallel_train_step`: step(local_batch)
    runs this rank's slice of the global batch, averages gradients, loss and
    metrics over the ranks, then scrubs and updates. -> (loss, metrics), the
    means over the ranks. The JAX step's `sample_scan` is
    `make_accum_train_step` over `split_samples(local_batch)`."""

    @spanned("guava.train_step")
    def step(batch):
        loss, metrics = _reduce(state, group, *_accumulate(loss_fn, state, [batch]))
        return _finish(state, loss, metrics, count_scrubbed)

    return step


def make_accum_train_step(loss_fn: Callable, state: TrainState, group,
                          count_scrubbed: bool = False):
    """Gradient accumulation over microbatches on the host, counterpart of
    the JAX `make_accum_train_step`: step(microbatches) takes this rank's
    slice of each microbatch, accumulates the mean gradient over them, and
    then all ranks do one all-reduce and one update. The effective batch is
    the microbatches' global size summed. It equals the JAX step (a pmean
    per microbatch, then the mean over microbatches) up to the order of
    float sums."""

    @spanned("guava.train_step")
    def step(microbatches):
        if not microbatches:
            raise ValueError("make_accum_train_step needs at least one microbatch")
        loss, metrics = _reduce(state, group, *_accumulate(loss_fn, state, list(microbatches)))
        return _finish(state, loss, metrics, count_scrubbed)

    return step


def make_parallel_eval_step(metrics_fn: Callable, group):
    """Evaluation on one rank of `group`, counterpart of the JAX
    `make_parallel_eval_step`: peval(local_batch) -> {name: float}, each
    metric of `metrics_fn(local_batch)` (floats or 0-d tensors) averaged
    over the ranks in float32 (the reference's `fabric.all_reduce(mean)`)."""

    def peval(batch):
        metrics = metrics_fn(batch)
        keys = sorted(metrics)
        vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32).reshape(())
                            .to(group.device) for k in keys])
        all_reduce_mean_([vals], group)
        return dict(zip(keys, vals.tolist()))

    return peval
