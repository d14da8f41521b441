"""Runtime assembly: config -> assets -> EHM -> modules -> pipeline statics
(counterpart of `guava_renderer_tpu/cli/context.py`).

Built once and shared by every config-driven entry point. The modules hold
their own parameters: `init_params` fills them from a seed and
`load_model_params` overlays trained or converted weights.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
from torch import nn

from ..avatar.inferer import InfererConfig, UbodyGaussianInferer
from ..avatar.renderer import GaussianRenderer, NeuralRefiner
from ..bodymodel.data import load_flame, load_smplx
from ..bodymodel.flame import add_teeth_flame
from ..bodymodel.ehm import BodyParams, EhmModel, FlameParams
from ..bodymodel.synthetic import synthetic_ehm
from ..core.cameras import Camera
from ..device import resolve_device
from ..models.styleunet import init_params_
from ..ops.gsplat import RasterizeSettings, _check_settings
from ..train.losses import LossConfig
from ..train.lpips import LPIPS, init_lpips_
from ..train.pipeline import PipelineStatics
from ..utils.config import ConfigDict, load_config
from .inference import _unpack_params

# MODEL.raster knobs of the JAX package that schedule its TPU kernels (caps,
# chunking, DMA banks, sort order, tile cull, priority window). The port bins
# uncapped and walks sub-tiles, so it accepts them and reports them ignored.
TPU_ONLY_RASTER = ("chunk", "max_tiles_per_gaussian", "large_k", "tpg_large",
                   "instance_budget", "dma_banks", "presort", "tile_cull", "priority_window")


@dataclass
class Runtime:
    cfg: ConfigDict
    smplx: Any
    flame: Any
    extras: Any
    ehm: EhmModel
    statics: PipelineStatics
    lpips: LPIPS
    num_vertices: int
    device: torch.device
    # MODEL.raster entries the port does not read, with their values
    ignored_raster: dict = field(default_factory=dict)
    synthetic_assets: bool = False        # as build_runtime was asked (a rank rebuilds it so)

    @property
    def inferer(self) -> UbodyGaussianInferer:
        return self.statics.inferer

    @property
    def renderer(self) -> GaussianRenderer:
        return self.statics.renderer

    @property
    def model(self) -> nn.ModuleDict:
        """The trained modules, keyed as checkpoints and converted weights
        key them ("inferer.*", "renderer.*")."""
        return nn.ModuleDict({"inferer": self.inferer, "renderer": self.renderer})


def resolve_config(config_name: str) -> ConfigDict:
    """Accept a config name (configs/train/<name>.yaml), a yaml path, or a
    model dir containing config.yaml (ref: main/test.py:230-241)."""
    candidates = [
        config_name,
        os.path.join("configs", "train", f"{config_name}.yaml"),
        os.path.join(config_name, "config.yaml"),
    ]
    for c in candidates:
        if os.path.isfile(c):
            return load_config(c)
    raise FileNotFoundError(f"no config found for {config_name!r}; tried {candidates}")


def raster_settings(raster_cfg) -> tuple[RasterizeSettings, dict]:
    """MODEL.raster -> (the port's settings, the entries it ignores). Raises
    on the combinations the JAX package refuses."""
    raster_cfg = dict(raster_cfg or {})
    settings = RasterizeSettings(
        tile=int(raster_cfg.get("tile", 16)),
        bf16_rows=bool(raster_cfg.get("bf16_rows", False)),
        size_classes=tuple((int(c), int(k)) for c, k in raster_cfg.get("size_classes", ())),
        vmem_classes=int(raster_cfg.get("vmem_classes", 0)),
        streaming=bool(raster_cfg.get("streaming", False)),
    )
    _check_settings(settings)
    kept = ("tile", "bf16_rows", "size_classes", "vmem_classes", "streaming")
    return settings, {k: v for k, v in raster_cfg.items() if k not in kept}


def build_runtime(cfg: ConfigDict, synthetic_assets: bool = False, device="cuda") -> Runtime:
    dev = resolve_device(device)
    m = cfg.MODEL
    model_path = os.path.join(m.smplx_assets_dir, "SMPLX_NEUTRAL_2020.npz")
    if synthetic_assets or not os.path.exists(model_path):
        if not synthetic_assets:
            print(
                "[context] SMPL-X model files not found — falling back to synthetic "
                f"assets (no {model_path}; geometry is procedural; download the real "
                "models per the README for production runs)"
            )
        smplx, flame, extras = synthetic_ehm(
            body_side=int(m.get("synthetic_body_side", 64)),
            head_side=int(m.get("synthetic_head_side", 12)),
            uv_size=m.uvmap_size,
            n_shape=int(m.get("synthetic_n_shape", 50)),
            n_exp=int(m.get("synthetic_n_exp", 20)),
            add_teeth=bool(m.get("add_teeth", True)),
        )
    else:
        smplx, extras = load_smplx(
            m.smplx_assets_dir,
            n_shape=300,
            n_exp=50,
            add_teeth=bool(m.get("add_teeth", True)),
            uv_size=m.uvmap_size,
            flame_assets_dir=m.flame_assets_dir,
        )
        flame = load_flame(m.flame_assets_dir, n_shape=300, n_exp=50)
        if bool(m.get("add_teeth", True)):
            # the EHM writes the FLAME head over smplx2flame_ind, which the
            # SMPL-X graft extended by the teeth rows: FLAME takes them too,
            # as the synthetic rig's FLAME does (the JAX package's real
            # branch skips this and fails in EhmModel.build)
            flame, _ = add_teeth_flame(flame)

    ehm = EhmModel.build(smplx, flame, extras, device=dev)

    ru = m.get("refiner_type", "styleunet")
    rcfg = m.get(ru, None)
    icfg = InfererConfig(
        image_size=m.image_size,
        uvmap_size=m.uvmap_size,
        invtanfov=float(m.invtanfov),
        dino_out_dim=m.dino_out_dim,
        uv_out_dim=m.uv_out_dim,
        smplx_fea_dim=m.smplx_fea_dim,
        prj_out_dim=m.prj_out_dim,
        global_vertex_dim=m.global_vertex_dim,
        color_dim=m.color_dim,
        uv_base_dim=int(m.get("uv_base_dim", 32)),
        style_dim=int(rcfg.get("num_style_feat", 512)) if rcfg else 512,
        num_mlp=int(rcfg.get("num_mlp", 8)) if rcfg else 8,
        channel_scale=float(rcfg.get("channel_scale", 1)) if rcfg else 1.0,
        vit_dim=int(m.get("vit_dim", 768)),
        vit_depth=int(m.get("vit_depth", 12)),
        vit_heads=int(m.get("vit_heads", 12)),
        pyramid_dims=tuple(m.get("pyramid_dims", (256, 512, 1024, 1024))),
    )
    settings, ignored = raster_settings(m.get("raster", None))
    if ignored:
        print(f"[context] MODEL.raster entries ignored by the port (TPU scheduling): {ignored}",
              file=sys.stderr)

    inferer = UbodyGaussianInferer(icfg, smplx.num_vertices)
    # the refiner runs at styleunet.out_size; it differs from image_size in
    # the multi-resolution renders of render_motion.py (720/1080/2048)
    rsize = (int(rcfg.get("out_size", m.image_size)) if rcfg else None) or m.image_size
    refiner = NeuralRefiner(
        rsize,
        style_dim=int(rcfg.get("num_style_feat", 512)) if rcfg else 512,
        num_mlp=int(rcfg.get("num_mlp", 8)) if rcfg else 8,
        channel_scale=float(rcfg.get("channel_scale", 1)) if rcfg else 1.0,
        small=bool(rcfg.get("small", True)) if rcfg else True,
        refiner_type=ru,
    )
    renderer = GaussianRenderer(
        refiner, settings, refiner_size=rsize,
        # serving lever (MODEL.bf16_refiner): refiner compute in bfloat16,
        # rasterizer float32
        refiner_dtype=torch.bfloat16 if bool(m.get("bf16_refiner", False)) else None,
    )

    opt = cfg.OPTIMIZE
    loss_cfg = LossConfig(
        lambda_l1=float(opt.lambda_l1),
        lambda_perpetual=float(opt.lambda_perpetual),
        lambda_perpetual_high=float(opt.lambda_perpetual_high),
        perpetual_increase_iter=int(opt.perpetual_increase_iter),
        lambda_head_crop=float(opt.lambda_head_crop),
        lambda_hand_crop=float(opt.lambda_hand_crop),
        lambda_local_xyz=float(opt.lambda_local_xyz),
        lambda_local_scale=float(opt.lambda_local_scale),
        threshold_local_xyz=float(opt.threshold_local_xyz),
        threshold_scale=float(opt.threshold_scale),
        mask_renders_until=int(opt.get("mask_renders_until", 1000)),
        crop_size=int(opt.get("crop_size", 256)),
    )

    statics = PipelineStatics(
        ehm=ehm,
        faces=torch.as_tensor(np.asarray(smplx.faces), dtype=torch.int64, device=dev),
        uvmap_f_idx=torch.as_tensor(np.asarray(extras.uvmap_f_idx), dtype=torch.int64,
                                    device=dev),
        uvmap_f_bary=torch.as_tensor(np.asarray(extras.uvmap_f_bary), dtype=torch.float32,
                                     device=dev),
        uvmap_mask=torch.as_tensor(np.asarray(extras.uvmap_mask), dtype=torch.bool, device=dev),
        inferer=inferer.to(dev),
        renderer=renderer.to(dev),
        loss_cfg=loss_cfg,
        image_size=m.image_size,
        invtanfov=float(m.invtanfov),
    )
    return Runtime(
        cfg=cfg, smplx=smplx, flame=flame, extras=extras, ehm=ehm, statics=statics,
        lpips=LPIPS("alex").to(dev), num_vertices=smplx.num_vertices, device=dev,
        ignored_raster=ignored, synthetic_assets=synthetic_assets,
    )


def init_params(rt: Runtime, seed: int = 0) -> Runtime:
    """Seeded random weights for the inferer, the renderer and LPIPS (one
    generator, in that order; flax-scale initializers, `init_params_`),
    then the pretrained backbones where their files exist."""
    gen = torch.Generator().manual_seed(seed)
    init_params_(rt.inferer, gen)
    init_params_(rt.renderer, gen)
    init_lpips_(rt.lpips, gen)
    load_pretrained_backbones(rt)
    return rt


def load_pretrained_backbones(rt: Runtime, pretrained_dir: str | None = None) -> Runtime:
    """Overlay converted pretrained weights when their files exist.

    The reference trains with a frozen torch-hub DINOv2
    (ref: ubody_gaussian.py:37-38) and an LPIPS-alex perceptual loss
    (ref: loss_utils.py:79). `python -m
    guava_renderer_tpu_torch.tools.convert_weights` writes them into
    MODEL.pretrained_dir (default assets/pretrained/):
        dinov2_vitb14.pt  -> inferer.dino_encoder.dino
        lpips_alex.pt     -> the LPIPS module
    Missing files are skipped with a notice (random backbone)."""
    from ..train.weights import load_state_file

    d = pretrained_dir or str(rt.cfg.MODEL.get("pretrained_dir", "assets/pretrained"))
    dino_path = os.path.join(d, "dinov2_vitb14.pt")
    if os.path.isfile(dino_path):
        load_state_file(dino_path, rt.inferer.dino_encoder.dino)
        print(f"[context] loaded pretrained DINOv2 from {dino_path}")
    else:
        print(f"[context] no pretrained DINOv2 at {dino_path} — random backbone")
    lpips_path = os.path.join(d, "lpips_alex.pt")
    if os.path.isfile(lpips_path):
        load_state_file(lpips_path, rt.lpips)
        print(f"[context] loaded pretrained LPIPS from {lpips_path}")
    return rt


def load_model_params(rt: Runtime, model_path: str | None, basemodel: str | None = None,
                      allow_random: bool = False) -> tuple[nn.ModuleDict, str]:
    """Weight discovery shared by the inference entry points
    (ref: main/test.py:242-252 best*/latest* + find_pt_file).

    Order: explicit `basemodel` (a checkpoint file) > the port's checkpoints
    under <model_path>/checkpoints > converted reference weights
    <model_path>/converted_params.pt. Random init requires allow_random (the
    reference hard-requires weights). Loads into the runtime's modules and
    returns them as `rt.model`, with a description of the source."""
    from ..train.checkpoints import CheckpointManager
    from ..train.trainstep import make_train_state
    from ..train.weights import load_state_file

    init_params(rt)
    model = rt.model

    if basemodel:
        cm = CheckpointManager(os.path.dirname(os.path.dirname(basemodel)) or ".")
        _, it = cm.restore(make_train_state(model), basemodel)
        return model, f"{basemodel} @ iter {it}"

    if model_path:
        if os.path.isdir(os.path.join(model_path, "checkpoints")):
            cm = CheckpointManager(model_path)
            found = cm.find_checkpoint()
            if found:
                _, it = cm.restore(make_train_state(model))
                return model, f"{found} @ iter {it}"
        converted = os.path.join(model_path, "converted_params.pt")
        if os.path.isfile(converted):
            load_state_file(converted, model)
            return model, f"converted reference weights {converted}"

    if not allow_random:
        raise SystemExit(
            f"no trained weights found under {model_path!r} — the reference "
            "requires a trained checkpoint (best_*.pt). Pass "
            "--allow_random_weights for random init (debug only), or convert "
            "the released checkpoint with "
            "`python -m guava_renderer_tpu_torch.tools.convert_guava_checkpoint`."
        )
    print("[context] RANDOM WEIGHTS (explicitly allowed)")
    return model, "random initialization"


def camera_from_w2c(rt: Runtime, w2c) -> Camera:
    size = int(rt.cfg.MODEL.image_size)
    w2c = torch.as_tensor(np.asarray(w2c), dtype=torch.float32, device=rt.device)
    return Camera.from_w2c(w2c, 1.0 / float(rt.cfg.MODEL.invtanfov), size, size)


def batch_params_to_body_flame(params: dict) -> tuple[BodyParams, FlameParams]:
    return _unpack_params(params)
