"""The published training step: `train/trainstep.py:make_train_step` over
`train/pipeline.py:make_loss_fn` (LPIPS on), fed by the port's loader
(`data/loader.py`: `PrefetchLoader`, pinned batches, `DeviceBatches`).

Set-up writes the store once a checkout (the traffic's generator), builds
the runtime from the configuration, fills the three networks with the
seed's weights, builds the train state, the step and the loader (its
sample order from the seed), and takes the job's first steps through the
window's own call and feed: they load the kernels, and their loss, their
first gradient (Adam's first moment after one step: its beta1 is 0) and
their change of each parameter are what the reference follows. Every
`restore_every` steps, those first ones included, the run loads the
set-up's train state again (`TrainState.load_state_dict`), so the work
stays that of the job's first steps. The window takes steps, each ending
in its loss on the host, until `--seconds` have passed. Once it has closed
and the port's state is freed, the reference takes the same first steps
and each reading is compared.
"""

from __future__ import annotations

import copy
import statistics
import time

import torch

from perfbench.harness import Check, log


def leaf_gaps(port: dict, ref: dict, leaves=None) -> list[float]:
    """Over the leaves, |norm_port - norm_ref| / max(norm_ref, the median leaf's norm_ref)."""
    names = sorted(ref) if leaves is None else sorted(leaves)
    median = statistics.median(ref[n] for n in names)
    return [abs(port[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names]


def moved_leaves(grads: dict, share: float = 1e-3) -> list[str]:
    """The leaves whose reference gradient is more than `share` of the median
    leaf's: the others are nought to rounding and move under Adam by it alone."""
    median = statistics.median(grads.values())
    return [n for n, g in grads.items() if g > share * median]


def readings(port: dict, ref: dict) -> dict:
    """The worst step's loss gap, the worst leaf's first gradient, and the
    worst and the median moved leaf's change, each relative to the reference.
    The cell's limits name the ones compared."""
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(port["losses"], ref["losses"]))
    change = leaf_gaps(port["change"], ref["change"], moved_leaves(ref["grads"]))
    return {"loss_rel": loss,
            "grad_leaf_gap": max(leaf_gaps(port["grads"], ref["grads"])),
            "change_leaf_gap": max(change),
            "change_median_gap": statistics.median(change)}


def build(run):
    """The runtime, its train state and step, the loader; -> a namespace."""
    cell = run.cell
    cfg = copy.deepcopy(cell.config["config"])
    with run.part("dataset"):
        cfg["DATASET"]["data_path"] = cell.generator().generate(cell.traffic, run.seed)
    with run.part("imports"):
        from guava_renderer_tpu_torch.cli.context import build_runtime
        from guava_renderer_tpu_torch.data.loader import DeviceBatches, PrefetchLoader, endless
        from guava_renderer_tpu_torch.data.tracked import build_dataset
        from guava_renderer_tpu_torch.kernels import build as kernels
        from guava_renderer_tpu_torch.train.pipeline import make_loss_fn
        from guava_renderer_tpu_torch.train.trainstep import make_train_state, make_train_step
        from guava_renderer_tpu_torch.utils.config import ConfigDict
        from perfbench.reference.train import make_weights
    if run.device.type == "cuda":
        with run.part("kernel_load"):
            kernels.library()
    with run.part("runtime"):
        rt = build_runtime(ConfigDict(cfg), synthetic_assets=True, device=run.device)
    with run.part("weights"):
        make_weights(rt.inferer, rt.renderer, rt.lpips, run.seed, cell.config["assumed"])
    with run.part("train_state"):
        opt = cfg["OPTIMIZE"]
        state = make_train_state(rt.model, learning_rate=float(opt["learning_rate"]),
                                 lr_decay_rate=float(opt["lr_decay_rate"]),
                                 lr_decay_iter=int(opt["lr_decay_iter"]))
        step = make_train_step(make_loss_fn(rt.statics, rt.lpips, remat=False), state,
                               count_scrubbed=True)
    with run.part("snapshot"):
        sd = state.state_dict()
        start = dict(sd, model={k: v.clone() for k, v in sd["model"].items()},
                     optimizer=copy.deepcopy(sd["optimizer"]),
                     scheduler=copy.deepcopy(sd["scheduler"]))
    with run.part("loader"):
        cc = ConfigDict(cfg)
        loader = PrefetchLoader(build_dataset(cc, "train"), int(cfg["TRAIN"]["batch_size"]),
                                shuffle=True, seed=run.seed, pin_memory=run.device.type == "cuda")
        batches = iter(DeviceBatches(endless(loader), run.device))
    return dict(rt=rt, state=state, step=step, start=start, batches=batches,
                data_path=cfg["DATASET"]["data_path"], batch=int(cfg["TRAIN"]["batch_size"]))


def first_steps(run, job: dict, n: int = 3) -> dict:
    """The job's first `n` steps through the window's call and feed -> the
    port's readings (losses, first-gradient and change norms by leaf)."""
    from perfbench.reference.train import leaf_norms

    state = job["state"]
    named = [(n_, p) for n_, p in state.model.named_parameters() if p.requires_grad]
    before = {n_: p.detach().clone() for n_, p in named}
    losses, grads, scrubbed = [], None, 0
    for _ in range(n):
        loss, metrics = job["step"](next(job["batches"]))
        losses.append(float(loss))
        scrubbed += int(metrics["scrubbed_grads"])
        if grads is None:
            st = state.optimizer.state
            grads = leaf_norms((n_, st[p]["exp_avg"] if p in st else torch.zeros_like(p))
                               for n_, p in named)
    change = leaf_norms((n_, p.detach() - before[n_]) for n_, p in named)
    return {"losses": losses, "grads": grads, "change": change, "scrubbed": scrubbed}


def run(run) -> None:
    cell = run.cell
    every = int(cell.config["assumed"]["restore_every"])
    job = build(run)
    with run.part("warmup"):
        port = first_steps(run, job, every)
        job["state"].load_state_dict(job["start"])
    log(f"first steps: losses {port['losses']}, scrubbed gradient entries {port['scrubbed']}")
    log("set-up parts (s): " + ", ".join(f"{k} {v:.3f}" for k, v in run.setup_parts.items()))

    waits, times, scrubbed = [], [], 0
    state, step, batches = job["state"], job["step"], job["batches"]
    with run.window():
        start = time.perf_counter()
        k = 0
        while True:
            if k and k % every == 0:
                state.load_state_dict(job["start"])
            t0 = time.perf_counter()
            batch = next(batches)
            t1 = time.perf_counter()
            loss, metrics = step(batch)
            float(loss)
            t2 = time.perf_counter()
            scrubbed += int(metrics["scrubbed_grads"])
            waits.append(t1 - t0)
            times.append(t2 - t0)
            k += 1
            if t2 - start >= run.seconds:
                break
    run.attempted = k
    run.values["train_samples_per_s"] = k * job["batch"] / run.window_s
    run.counts.update(steps=k, batch=job["batch"], batch_wait_ms=1e3 * statistics.mean(waits),
                      scrubbed=scrubbed)
    log(f"set-up {run.setup_s:.3f} s; window: {k} steps in {run.window_s:.4f} s; step ms median "
        f"{1e3 * statistics.median(times):.4f}, max {1e3 * max(times):.4f}; batch wait ms mean "
        f"{run.counts['batch_wait_ms']:.4f}; scrubbed gradient entries {scrubbed}")

    data_path = job["data_path"]
    del job, state, step, batches, batch, loss, metrics
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    check_against_reference(run, port, data_path, every)


def check_against_reference(run, port: dict, data_path: str, steps: int) -> dict:
    from perfbench.reference.train import follow

    limits = run.cell.workload["check"]["limits"]
    t0 = time.perf_counter()
    ref = follow(run.cell.config, data_path, run.seed, run.device, steps, count_flops=run.trace)
    got = readings(port, ref)
    for name, limit in limits.items():
        run.checks.append(Check(name, got[name], float(limit)))
    log("readings (compared or not): " + ", ".join(f"{k} {v!r}" for k, v in got.items()))
    n_items = len(ref["instances"])
    log(f"reference: {steps} steps in {time.perf_counter() - t0:.1f} s; losses {ref['losses']}; "
        f"instances an item {ref['instances']}; contributing pairs an item {ref['pairs']}; "
        f"UV rows over the opacity threshold an item {ref['uv_rows_kept']}")
    m = run.cell.config["config"]["MODEL"]
    run.counts.update(pairs_per_step=sum(ref["pairs"]) / steps,
                      instances_per_step=sum(ref["instances"]) / steps,
                      gaussians_per_step=ref["gaussians"] * n_items / steps,
                      items_per_step=n_items / steps, size=int(m["image_size"]),
                      tile=int(m["raster"]["tile"]), network_flops=ref.get("network_flops"),
                      params=ref["params"])
    return got


def calibration(cell, seeds, control_seeds, fault_seeds, device):
    """Yield, for each seed, the numbers compared: the port's against the
    reference ({"port": ...}); for the control seeds, the reference's in
    TF32 ({"control": ...}); for the fault seeds, the reference's with half
    of each batch left out and the mean taken over the rest
    ({"half_batch": ...})."""
    from perfbench import harness
    from perfbench.reference.train import follow

    every = int(cell.config["assumed"]["restore_every"])
    for seed in seeds:
        run = harness.Run(cell, seed, 0.0, False, device)
        job = build(run)
        port = first_steps(run, job, every)
        data_path, half = job["data_path"], slice(0, job["batch"] // 2)
        del job
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = follow(cell.config, data_path, seed, device, every)
        rec = {"seed": seed, "port": readings(port, ref), "losses": port["losses"],
               "scrubbed": port["scrubbed"], "instances": ref["instances"]}
        if seed in control_seeds:
            rec["control"] = readings(follow(cell.config, data_path, seed, device, every,
                                             tf32=True), ref)
        if seed in fault_seeds:
            rec["half_batch"] = readings(follow(cell.config, data_path, seed, device, every,
                                                items=half), ref)
        yield rec
