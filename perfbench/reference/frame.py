"""The reference of one rendered frame: what `FramePipeline.render_frame`
returns for an avatar made from the benchmark's draws, worked out again
from the configuration, the seed and the target.

The rig is the frozen synthetic rig at the configuration's sizes; the
avatar is the benchmark's draws on it, pruned at the configuration's
opacity threshold and put in the face-sort order of the frozen plan, as
`FramePipeline.prepare_avatar` leaves it (ties in depth resolve by
Gaussian id, so both sides need one order of ids); a frame is the frozen
EHM and row-gather deform, the reference rasterizer (`raster.py`), and the
frozen StyleUNet between two frozen bilinear resizes when the refiner's
size differs from the raster's. Float32 throughout, TF32 off, unless the
caller asks for the control (`tf32=True`).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..inputs import avatar_draws, fill_weights, on_rig
from . import raster
from .frozen.avatar.deformer import deform_avatar, sort_avatar_by_plan
from .frozen.avatar.state import GaussianAvatar, prune_avatar
from .frozen.bodymodel.ehm import BodyParams, EhmModel, FlameParams
from .frozen.bodymodel.synthetic import synthetic_ehm
from .frozen.core.cameras import Camera
from .frozen.models.layers import resize_bilinear
from .frozen.models.styleunet import StyleUNet
from .frozen.ops.facegather import build_face_sort_plan


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products and convolutions (TF32 off), or TF32 for the control."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def build_rig(model: dict, device):
    """-> (EhmModel, faces (F, 3) int64, smplx data, extras) of the synthetic rig."""
    smplx, flame, extras = synthetic_ehm(
        body_side=int(model["synthetic_body_side"]), head_side=int(model["synthetic_head_side"]),
        uv_size=int(model["uvmap_size"]), n_shape=int(model["synthetic_n_shape"]),
        n_exp=int(model["synthetic_n_exp"]), add_teeth=bool(model["add_teeth"]))
    ehm = EhmModel.build(smplx, flame, extras, device=device)
    faces = torch.as_tensor(np.asarray(smplx.faces), dtype=torch.int64, device=device)
    return ehm, faces, smplx, extras


class ReferenceFrames:
    """The reference renderer of one configuration and seed."""

    def __init__(self, model: dict, seed: int, device, weight_gain: float, avatar_seed: int):
        self.device = torch.device(device)
        self.size = int(model["image_size"])
        self.tile = int(model["raster"]["tile"])
        self.tanfov = 1.0 / float(model["invtanfov"])
        su = model["styleunet"]
        self.refiner_size = int(su["out_size"])
        self.ehm, self.faces, smplx, extras = build_rig(model, self.device)
        self.n_shape, self.n_exp = smplx.n_shape, smplx.n_exp
        draws = avatar_draws(avatar_seed, seed, smplx.num_vertices, int(model["uvmap_size"]) ** 2,
                             self.device)
        avatar = prune_avatar(GaussianAvatar(**on_rig(draws, smplx, extras, self.device)),
                              float(model["opacity_threshold"]))
        plan = build_face_sort_plan(avatar.uv_binding_face.cpu().numpy(),
                                    avatar.uv_valid.cpu().numpy())
        self.avatar = sort_avatar_by_plan(avatar, plan)
        self.refiner = StyleUNet(self.refiner_size, int(su["in_dim"]), int(su["out_dim"]),
                                 int(su["num_style_feat"]), int(su["num_mlp"]),
                                 float(su["channel_scale"]), small=bool(su["small"]))
        self.refiner = self.refiner.to(self.device).eval()
        fill_weights(self.refiner, seed, weight_gain)

    @torch.no_grad()
    def frame(self, target: dict, tf32: bool = False) -> dict:
        """-> {"render", "raw": (H, W, 3), "invdepth": (H, W), "pairs": the
        contributing (pixel, Gaussian) pairs, "instances": binned instances}."""
        with precision(tf32):
            p = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)[None]
                 for k, v in target["params"].items()}
            body = BodyParams(shape=p["shape"], body_pose=p["body_pose"])
            flame = FlameParams(shape=p["flame_shape"], exp=p["flame_exp"], jaw=p["flame_jaw"])
            gs = deform_avatar(self.avatar, self.ehm, self.faces, body, flame)
            w2c = torch.as_tensor(target["w2c"], dtype=torch.float32, device=self.device)
            cam = Camera.from_w2c(w2c, self.tanfov, self.size, self.size)
            color, invdepth, pairs, instances = raster.rasterize(
                gs.xyz[0], gs.colors[0], gs.opacity[0], gs.scaling[0], gs.rotation[0], cam,
                self.tile)
            x = color.permute(2, 0, 1)[None]
            r = self.refiner_size
            if r != self.size:
                x = resize_bilinear(x, (r, r))
            rgb = self.refiner(x)
            if r != self.size:
                rgb = resize_bilinear(rgb, (self.size, self.size))
            return {"render": torch.clamp(rgb[0].permute(1, 2, 0), 0, 1),
                    "raw": torch.clamp(color[..., :3], 0, 1), "invdepth": invdepth,
                    "pairs": pairs, "instances": instances}
