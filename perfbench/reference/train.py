"""The reference of the published training step: the first steps of the job,
worked out again from the configuration, the seed and the store.

The batches are read from the store by the frozen data layer (the record
store's reader, the JPEG and PNG decoders, the area resize, the tracked
dataset with its own seeded choice of source frames) in the loader's
order (`PrefetchLoader`: the epoch's indices shuffled by
`default_rng(seed)`, batches in turn). The model is the frozen inferer
(ViT + DPT encoder, vertex and UV branches, the plain z-buffer) and the
frozen StyleUNet refiner, with the benchmark's weights; a sample's image is
the reference rasterizer with gradients (`raster.rasterize(grad=True)`), refined;
the loss is the frozen `OptimizationLoss` with the frozen LPIPS; the update
zeroes non-finite gradient entries and takes Adam with the job's settings
(betas (0, 0.99), eps 1e-8, the `style_mlp` and `final_linear` parameters at
0.1x the learning rate, a linear decay over `lr_decay_iter` steps).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..inputs import fill_weights
from . import raster
from .frame import build_rig, precision
from .frozen.avatar.deformer import deform_avatar
from .frozen.avatar.inferer import InfererConfig, UbodyGaussianInferer, build_avatar
from .frozen.bodymodel.ehm import BodyParams, FlameParams
from .frozen.core.cameras import Camera
from .frozen.data.tracked import TrackedVideoDataset
from .frozen.models.styleunet import StyleUNet
from .frozen.train.losses import LossConfig, OptimizationLoss
from .frozen.train.lpips import LPIPS

SLOW_MARKERS = ("style_mlp", "final_linear")
INFERER, RENDERER, LPIPS_NET = 0, 1, 2     # the parts of the weights' seed


class _Refiner(nn.Module):
    """The StyleUNet under the parameter names the port's renderer gives it."""

    def __init__(self, su: dict):
        super().__init__()
        self.neural_refiner = nn.Module()
        self.neural_refiner.refiner = StyleUNet(
            int(su["out_size"]), int(su["in_dim"]), int(su["out_dim"]),
            int(su["num_style_feat"]), int(su["num_mlp"]), float(su["channel_scale"]),
            small=bool(su["small"]))

    def forward(self, feats):    # (B, H, W, 32) -> (B, H, W, 3)
        return self.neural_refiner.refiner(feats.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def inferer_config(model: dict) -> InfererConfig:
    su = model["styleunet"]
    return InfererConfig(
        image_size=int(model["image_size"]), uvmap_size=int(model["uvmap_size"]),
        invtanfov=float(model["invtanfov"]), dino_out_dim=int(model["dino_out_dim"]),
        uv_out_dim=int(model["uv_out_dim"]), smplx_fea_dim=int(model["smplx_fea_dim"]),
        prj_out_dim=int(model["prj_out_dim"]), global_vertex_dim=int(model["global_vertex_dim"]),
        color_dim=int(model["color_dim"]), uv_base_dim=int(model.get("uv_base_dim", 32)),
        style_dim=int(su["num_style_feat"]), num_mlp=int(su["num_mlp"]),
        channel_scale=float(su["channel_scale"]), vit_dim=int(model.get("vit_dim", 768)),
        vit_depth=int(model.get("vit_depth", 12)), vit_heads=int(model.get("vit_heads", 12)),
        pyramid_dims=tuple(model.get("pyramid_dims", (256, 512, 1024, 1024))))


def loss_config(opt: dict) -> LossConfig:
    """The OPTIMIZE section's loss settings, with the defaults the runtime takes."""
    given = dict(opt, mask_renders_until=opt.get("mask_renders_until", 1000),
                 crop_size=opt.get("crop_size", 256))
    return LossConfig(**{k: type(getattr(LossConfig(), k))(given[k]) for k in (
        "lambda_l1", "lambda_perpetual", "lambda_perpetual_high", "perpetual_increase_iter",
        "lambda_head_crop", "lambda_hand_crop", "lambda_local_xyz", "lambda_local_scale",
        "threshold_local_xyz", "threshold_scale", "mask_renders_until", "crop_size")})


def make_weights(inferer, renderer, lpips, seed: int, assumed: dict) -> None:
    """The benchmark's weights of the three networks, and the UV opacity
    head's bias of the configuration (the same call fills the port's)."""
    gain = float(assumed["weight_gain"])
    fill_weights(inferer, seed, gain, part=INFERER)
    fill_weights(renderer, seed, gain, part=RENDERER)
    fill_weights(lpips, seed, gain, part=LPIPS_NET)
    with torch.no_grad():
        inferer.uv_point_decoder.opacity1.bias.fill_(float(assumed["uv_opacity_bias"]))


def batches(data_path: str, cfg: dict, seed: int, n: int, device) -> list[dict]:
    """The loader's first `n` batches, read again from the store."""
    m, d = cfg["MODEL"], cfg["DATASET"]
    ds = TrackedVideoDataset(data_path, "train", image_size=int(m["image_size"]),
                             feature_img_size=int(m["feature_img_size"]),
                             origin_image_size=int(d["origin_image_size"]),
                             head_crop_size=int(d["head_crop_size"]),
                             hand_crop_size=int(d["hand_crop_size"]))
    order = np.arange(len(ds))
    np.random.default_rng(seed).shuffle(order)
    B = int(cfg["TRAIN"]["batch_size"])

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        a = np.stack([np.asarray(it) for it in items])
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32) if a.dtype.kind == "f" else a)
        return t.to(device)

    return [stack([ds[int(i)] for i in order[b * B:(b + 1) * B]]) for b in range(n)]


def _params(p: dict) -> tuple[BodyParams, FlameParams]:
    body = BodyParams(shape=p["shape"], body_pose=p["body_pose"], global_pose=p.get("global_pose"),
                      left_hand_pose=p.get("left_hand_pose"),
                      right_hand_pose=p.get("right_hand_pose"), exp=p.get("exp"),
                      joints_offset=p.get("joints_offset"), head_scale=p.get("head_scale"),
                      hand_scale=p.get("hand_scale"))
    flame = FlameParams(shape=p["flame_shape"], exp=p["flame_exp"], jaw=p["flame_jaw"],
                        eyes=p.get("flame_eyes"), eyelids=p.get("flame_eyelids"))
    return body, flame


class ReferenceTraining:
    """The reference model and optimizer of one configuration and seed."""

    def __init__(self, config: dict, seed: int, device):
        cfg, assumed = config["config"], config["assumed"]
        m, opt = cfg["MODEL"], cfg["OPTIMIZE"]
        self.device = torch.device(device)
        self.size, self.tile = int(m["image_size"]), int(m["raster"]["tile"])
        self.invtanfov = float(m["invtanfov"])
        self.threshold = float(m["opacity_threshold"])
        self.ehm, self.faces, smplx, extras = build_rig(m, self.device)
        self.uv = tuple(torch.as_tensor(np.asarray(x), dtype=dt, device=self.device) for x, dt in (
            (extras.uvmap_f_idx, torch.int64), (extras.uvmap_f_bary, torch.float32),
            (extras.uvmap_mask, torch.bool)))
        inferer = UbodyGaussianInferer(inferer_config(m), smplx.num_vertices)
        self.model = nn.ModuleDict({"inferer": inferer, "renderer": _Refiner(m["styleunet"])})
        self.model.to(self.device)
        self.lpips = LPIPS("alex").to(self.device)
        make_weights(inferer, self.model["renderer"], self.lpips, seed, assumed)
        self.loss = OptimizationLoss(loss_config(opt), self.lpips)
        lr, rate, span = (float(opt["learning_rate"]), float(opt["lr_decay_rate"]),
                          int(opt["lr_decay_iter"]))
        named = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        groups = []
        for slow in (False, True):
            ps = [p for n, p in named if any(k in n for k in SLOW_MARKERS) == slow]
            if ps:
                groups.append({"params": ps, "lr": lr * (0.1 if slow else 1.0)})
        self.optimizer = torch.optim.Adam(groups, betas=(0.0, 0.99), eps=1e-8, weight_decay=0.0)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda step: 1.0 + (rate - 1.0) * min(step, span) / span)
        self.instances, self.pairs, self.kept = [], [], []

    def loss_of(self, batch: dict, iteration: int, items=None) -> torch.Tensor:
        """The job's loss of a batch (of its `items` alone, where given)."""
        if items is not None:
            batch = _take(batch, items)
        src, tgt = batch["source"], batch["target"]
        body, flame = _params(src["params"])
        avatar, _ = build_avatar(self.model["inferer"], self.ehm, self.faces, *self.uv,
                                 src["image"], src["w2c"], body, flame,
                                 image_size=self.size, invtanfov=self.invtanfov)
        with torch.no_grad():
            live = (avatar.uv_opacity[..., 0] > self.threshold) & avatar.uv_valid
            self.kept.extend(int(n) for n in live.sum(dim=-1))
        body, flame = _params(tgt["params"])
        gs = deform_avatar(avatar, self.ehm, self.faces, body, flame)
        feats = []
        for b, w2c in enumerate(tgt["w2c"]):
            cam = Camera.from_w2c(w2c, 1.0 / self.invtanfov, self.size, self.size)
            color, _, pairs, inst = raster.rasterize(
                gs.xyz[b], gs.colors[b], gs.opacity[b], gs.scaling[b], gs.rotation[b], cam,
                self.tile, chunk=32, grad=True)
            feats.append(color)
            self.pairs.append(pairs)
            self.instances.append(inst)
        feats = torch.stack(feats)
        renders = self.model["renderer"](feats)
        total, _ = self.loss(renders, feats[..., :3], tgt["image"], tgt["mask"], tgt.get("boxes"),
                             avatar.uv_local_xyz, avatar.uv_scales, iteration)
        return total

    def step(self, batch: dict, iteration: int, tf32: bool = False, items=None) -> float:
        """One step of the job -> its loss; gradients left in `.grad`."""
        with precision(tf32):
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.loss_of(batch, iteration, items)
            loss.backward()
            for p in self.model.parameters():
                if p.grad is not None:
                    p.grad.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)
            self.optimizer.step()
            self.schedule.step()
        return float(loss.detach())


def _take(batch, items):
    if isinstance(batch, dict):
        return {k: _take(v, items) for k, v in batch.items()}
    return batch[items]


def leaf_norms(named_tensors) -> dict:
    """{name: the float64 norm of the tensor}."""
    return {n: float(t.detach().double().norm()) for n, t in named_tensors}


def network_flops(counter) -> float:
    """The operations that a FlopCounterMode counted inside the networks (the
    inferer, the refiner, LPIPS), forward and backward: the rasterizer and
    the loss's arithmetic between them are left out."""
    nets = ("UbodyGaussianInferer", "_Refiner", "LPIPS")
    return float(sum(sum(ops.values()) for name, ops in counter.get_flop_counts().items()
                     if name in nets))


def follow(config: dict, data_path: str, seed: int, device, steps: int = 3, tf32: bool = False,
           items=None, count_flops: bool = False) -> dict:
    """The reference's readings of the job's first `steps` steps: the loss of
    each, the norm of each leaf's first gradient after the scrub, and the
    norm of each leaf's change over the steps. `items` keeps only those
    samples of each batch (a fault, half of the batch left out). With
    `count_flops`, also the networks' operations in the first step."""
    from torch.utils.flop_counter import FlopCounterMode

    ref = ReferenceTraining(config, seed, device)
    named = [(n, p) for n, p in ref.model.named_parameters() if p.requires_grad]
    start = {n: p.detach().clone() for n, p in named}
    losses, grads, flops = [], None, None
    for it, batch in enumerate(batches(data_path, config["config"], seed, steps, device)):
        if count_flops and it == 0:
            counter = FlopCounterMode(display=False)
            with counter:
                losses.append(ref.step(batch, it, tf32=tf32, items=items))
            flops = network_flops(counter)
        else:
            losses.append(ref.step(batch, it, tf32=tf32, items=items))
        if grads is None:
            grads = leaf_norms((n, p.grad if p.grad is not None else torch.zeros_like(p))
                               for n, p in named)
    change = leaf_norms((n, p.detach() - start[n]) for n, p in named)
    n_gauss = int(ref.ehm.smplx["v_template"].shape[0]) + ref.uv[0].numel()
    return {"losses": losses, "grads": grads, "change": change, "pairs": ref.pairs,
            "instances": ref.instances, "uv_rows_kept": ref.kept, "network_flops": flops, "gaussians": n_gauss,
            "params": sum(p.numel() for _, p in named)}
