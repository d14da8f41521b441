"""Rank-side work of the port's multi-device tests (tests/test_torch_parallel.py,
test_torch_sharded_render.py, test_torch_batch_render.py).

`parallel.mesh.launch` runs these functions in spawned gloo ranks on the CPU.
This module imports torch and the port only, never JAX, so a rank holds no
JAX; each function reports whether one got in. Results come back as plain
numpy arrays and floats.
"""

from __future__ import annotations

import copy
import sys

import numpy as np
import torch
from torch import nn

from guava_renderer_tpu_torch.parallel import mesh


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _params(model: nn.Module) -> dict:
    return {n: _np(p) for n, p in model.named_parameters()}


def _grads(model: nn.Module) -> dict:
    return {n: None if p.grad is None else _np(p.grad) for n, p in model.named_parameters()}


def _clean() -> dict:
    return {"jax": any(m == "jax" or m.startswith("jax.") for m in sys.modules),
            "threads": torch.get_num_threads()}


# -- the toy losses of tests/test_trainstep.py ---------------------------------

def module_from_tree(tree: dict) -> nn.Module:
    """A module whose parameters are the leaves of a nested dict, by path."""
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, module_from_tree(v))
        else:
            m.register_parameter(k, nn.Parameter(torch.tensor(np.asarray(v))))
    return m


def toy_loss(model: nn.Module):
    def fn(batch, iteration):
        pred = batch["x"] @ model.dense.kernel + model.dense.bias
        pred = pred @ model.refiner.generator.style_mlp.mlp0.kernel
        pred = pred @ model.final_linear.kernel
        loss = ((pred - batch["y"]) ** 2).mean()
        return loss, {"loss": loss}

    return fn


def nan_loss(model: nn.Module):
    """The toy loss plus mean(sqrt(s + 0 * bias[0])): the gradient of bias[0]
    is NaN on a batch holding an s of 0 and finite on any other."""
    base = toy_loss(model)

    def fn(batch, iteration):
        loss, _ = base(batch, iteration)
        loss = loss + torch.sqrt(batch["s"] + 0.0 * model.dense.bias[0]).mean()
        return loss, {"loss": loss}

    return fn


def toy_metrics(model: nn.Module):
    def fn(batch):
        with torch.no_grad():
            pred = batch["x"] @ model.dense.kernel + model.dense.bias
            return {"mse": ((pred - batch["y"]) ** 2).mean(), "mean_x": batch["x"].mean()}

    return fn


def _tensors(batch: dict) -> dict:
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def _toy_checks(group, params, batch, nan_batch, lr):
    from guava_renderer_tpu_torch.train.trainstep import (
        make_accum_train_step, make_parallel_eval_step, make_parallel_train_step,
        make_train_state, split_samples)

    out = {}
    full = _tensors(batch)
    local = mesh.shard_batch(full, group)

    def fresh():
        model = module_from_tree(params)
        return model, make_train_state(model, learning_rate=lr)

    model, state = fresh()
    loss, metrics = make_parallel_train_step(toy_loss(model), state, group)(local)
    out["dp"] = {"params": _params(model), "loss": float(loss), "metric": float(metrics["loss"])}

    model, state = fresh()      # the JAX step's sample_scan: the rank's samples as microbatches
    loss, _ = make_accum_train_step(toy_loss(model), state, group)(split_samples(local))
    out["dp_scan"] = {"params": _params(model), "loss": float(loss)}

    # 4 microbatches of (n ranks x 1 sample): microbatch i is samples [n·i, n·i + n)
    n = group.size
    micro = [mesh.shard_batch({k: v[n * i:n * i + n] for k, v in full.items()}, group)
             for i in range(len(batch["x"]) // n)]
    model, state = fresh()
    loss, metrics = make_accum_train_step(toy_loss(model), state, group)(micro)
    out["accum"] = {"params": _params(model), "loss": float(loss),
                    "metric": float(metrics["loss"]), "iteration": state.iteration}

    model, _ = fresh()
    out["eval"] = make_parallel_eval_step(toy_metrics(model), group)(local)

    model, state = fresh()
    loss, metrics = make_parallel_train_step(nan_loss(model), state, group,
                                             count_scrubbed=True)(
        mesh.shard_batch(_tensors(nan_batch), group))
    out["nan"] = {"params": _params(model), "grads": _grads(model), "loss": float(loss),
                  "scrubbed": int(metrics["scrubbed_grads"])}
    return out


# -- the micro pipeline --------------------------------------------------------

def _micro_checks(group, lr):
    from guava_renderer_tpu_torch.cli.trainer_loop import eval_metrics_fn
    from guava_renderer_tpu_torch.testing import make_micro_pipeline
    from guava_renderer_tpu_torch.train.pipeline import make_loss_fn
    from guava_renderer_tpu_torch.train.trainstep import (
        make_accum_train_step, make_parallel_eval_step, make_parallel_train_step,
        make_train_state, make_train_step)

    tp = make_micro_pipeline(batch_size=2 * group.size, seed=0, device="cpu")
    model = nn.ModuleDict({"inferer": tp.statics.inferer, "renderer": tp.statics.renderer})
    mesh.replicate(model, group)
    start = copy.deepcopy(model.state_dict())
    loss_fn = make_loss_fn(tp.statics, None)
    local = mesh.shard_batch(tp.batch, group)
    out = {}

    state = make_train_state(model, learning_rate=lr)
    loss, metrics = make_parallel_train_step(loss_fn, state, group)(local)
    out["dp"] = {"params": _params(model), "grads": _grads(model), "loss": float(loss),
                 "metrics": {k: float(v) for k, v in metrics.items()}}

    model.load_state_dict(start)
    state = make_train_state(model, learning_rate=lr)
    loss, _ = make_accum_train_step(loss_fn, state, group)([local, local])
    out["accum_same_twice"] = {"params": _params(model), "loss": float(loss)}

    model.load_state_dict(start)
    out["eval"] = make_parallel_eval_step(eval_metrics_fn(tp.statics), group)(local)

    if group.rank == 0:     # in one process: the whole batch, and each rank's slice
        model.load_state_dict(start)
        out["single_eval"] = eval_metrics_fn(tp.statics)(tp.batch)
        state = make_train_state(model, learning_rate=lr)
        loss, metrics = make_train_step(loss_fn, state)(tp.batch)
        out["single"] = {"loss": float(loss),
                         "metrics": {k: float(v) for k, v in metrics.items()}}
        shard_grads = []
        for r in range(group.size):
            model.load_state_dict(start)
            model.zero_grad(set_to_none=True)
            mine = mesh.shard_batch(tp.batch, mesh.Group(r, group.size, group.device, "none"))
            loss_fn(mine, 0)[0].backward()
            shard_grads.append(_grads(model))
        out["shard_mean_grads"] = {
            n: None if shard_grads[0][n] is None
            else sum(g[n] for g in shard_grads) / np.float32(group.size)
            for n in shard_grads[0]}
    return out


def _training(group, cfg_path, data_path, run_dir):
    from guava_renderer_tpu_torch.cli.context import build_runtime
    from guava_renderer_tpu_torch.cli.trainer_loop import run_training
    from guava_renderer_tpu_torch.data.tracked import build_dataset
    from guava_renderer_tpu_torch.utils.config import load_config

    cfg = load_config(cfg_path, {"DATASET": {"data_path": data_path}})
    rt = build_runtime(cfg, synthetic_assets=True, device=group.device)
    state = run_training(rt, build_dataset(cfg, "train"), build_dataset(cfg, "valid"), run_dir,
                         debug=True, max_iters=1, n_devices=group.size)
    return {"params": _params(state.model), "iteration": state.iteration}


def parallel_world(group, toy, micro_lr, train_args):
    """Every check of tests/test_torch_parallel.py on one rank."""
    out = _toy_checks(group, *toy)
    out["micro"] = _micro_checks(group, micro_lr)
    out["train"] = _training(group, *train_args)
    out.update(_clean())
    return out


# -- rendering ----------------------------------------------------------------

def sharded_world(group, scene, bf16):
    """rasterize_row_sharded of the scene on this rank (H split over the ranks)."""
    from guava_renderer_tpu_torch.ops.gsplat import RasterizeSettings
    from guava_renderer_tpu_torch.parallel.sharded_render import rasterize_row_sharded

    args, cam = scene_tensors(scene)
    out = {}
    for key, on in (("f32", False), ("bf16", True)):
        if on and not bf16:
            continue
        color, radii, invd = rasterize_row_sharded(*args, cam, torch.tensor(scene["bg"]), group,
                                                   RasterizeSettings(tile=16, bf16_rows=on))
        out[key] = (_np(color), _np(radii), _np(invd))
    out.update(_clean())
    return out


def scene_tensors(scene: dict):
    from guava_renderer_tpu_torch.core.cameras import Camera

    args = [torch.tensor(scene[k]) for k in ("means", "colors", "opac", "scales", "quats")]
    cam = Camera(R=torch.eye(3), t=torch.zeros(3), tanfovx=torch.tensor(scene["tanfov"]),
                 tanfovy=torch.tensor(scene["tanfov"]), width=scene["width"],
                 height=scene["height"])
    return args, cam


def micro_frame_pipeline(renderer_np=None):
    """The micro pipeline's statics and a FramePipeline over its refiner,
    with the flax renderer weights `renderer_np` carried in when given."""
    from guava_renderer_tpu_torch.cli.inference import FramePipeline
    from guava_renderer_tpu_torch.convert import state_dict_from_flax
    from guava_renderer_tpu_torch.testing import make_micro_pipeline

    s = make_micro_pipeline(batch_size=1, device="cpu").statics
    if renderer_np is not None:
        s.renderer.load_state_dict(state_dict_from_flax(renderer_np))
    return FramePipeline(s.ehm, s.faces, s.renderer.neural_refiner, image_size=s.image_size,
                         invtanfov=s.invtanfov, settings=s.renderer.settings, device="cpu")


def avatar_tensors(avatar_np: dict):
    from guava_renderer_tpu_torch.avatar.state import GaussianAvatar

    return GaussianAvatar(**{k: torch.tensor(v) for k, v in avatar_np.items()})


def batch_world(group, renderer_np, avatar_np, targets, cfg_path, data_path, out_dir):
    """Every rank-side check of tests/test_torch_batch_render.py."""
    from guava_renderer_tpu_torch.cli.context import build_runtime, init_params
    from guava_renderer_tpu_torch.cli.inference import render_set
    from guava_renderer_tpu_torch.data.tracked import TrackedVideoDataset
    from guava_renderer_tpu_torch.parallel.batch_render import make_batch_frame_renderer
    from guava_renderer_tpu_torch.utils.config import load_config

    pipe = micro_frame_pipeline(renderer_np)
    avatar = avatar_tensors(avatar_np)
    renders, raws = make_batch_frame_renderer(pipe, group)(avatar, targets)
    out = {"renders": _np(renders), "raws": _np(raws)}
    if group.rank == 0:       # the sequential frames, in this process
        seq = [pipe.render_frame(avatar, t) for t in targets]
        out["seq_renders"] = np.stack([_np(o["render"]) for o in seq])
        out["seq_raws"] = np.stack([_np(o["raw"]) for o in seq])

    cfg = load_config(cfg_path, {"DATASET": {"data_path": data_path}})
    rt = build_runtime(cfg, synthetic_assets=True, device=group.device)
    init_params(rt)
    ds = TrackedVideoDataset(data_path, "test", image_size=cfg.MODEL.image_size,
                             feature_img_size=cfg.MODEL.feature_img_size,
                             origin_image_size=cfg.DATASET.origin_image_size)
    out["dp_results"] = render_set(rt, rt.model, ds, f"{out_dir}/dp", dp_frames=True)
    if group.rank == 0:       # the sequential driver, in this process
        out["seq_results"] = render_set(rt, rt.model, ds, f"{out_dir}/seq")
    out.update(_clean())
    return out
