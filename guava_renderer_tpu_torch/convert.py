"""Carry the JAX package's state into the port.

Every function takes the JAX objects with their leaves already turned into
numpy arrays (e.g. `jax.tree_util.tree_map(np.asarray, x)`) and reads
NamedTuple fields by name, so this module needs nothing of JAX.

The port's modules carry the flax names, so the mapping is a per-leaf
transpose; `train/weights.py` composes it with its own copy of the GUAVA
name maps to read a released GUAVA `.pt` straight into the port.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .avatar.inferer import InfererConfig, UbodyGaussianInferer
from .avatar.state import GaussianAvatar
from .bodymodel.ehm import EhmModel
from .core.cameras import Camera
from .device import resolve_device
from .ops.facegather import FaceSortPlan, segment_starts


def _t(x, device, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def avatar_from_numpy(avatar, device="cuda") -> GaussianAvatar:
    dev = resolve_device(device)
    dtypes = {"uv_binding_face": torch.int64, "uv_valid": torch.bool}
    return GaussianAvatar(**{
        k: _t(getattr(avatar, k), dev, dtypes.get(k, torch.float32))
        for k in GaussianAvatar._fields
    })


def ehm_from_numpy(ehm, device="cuda") -> EhmModel:
    dev = resolve_device(device)
    return EhmModel(
        smplx={k: _t(v, dev) for k, v in ehm.smplx.items()},
        flame={k: _t(v, dev) for k, v in ehm.flame.items()},
        smplx_parents=tuple(int(p) for p in ehm.smplx_parents),
        flame_parents=tuple(int(p) for p in ehm.flame_parents),
        smplx2flame_ind=_t(ehm.smplx2flame_ind, dev, torch.int64),
        left_hand_ind=_t(ehm.left_hand_ind, dev, torch.int64),
        right_hand_ind=_t(ehm.right_hand_ind, dev, torch.int64),
        left_hand_center=_t(ehm.left_hand_center, dev),
        right_hand_center=_t(ehm.right_hand_center, dev),
        n_shape=int(ehm.n_shape),
        n_exp=int(ehm.n_exp),
    )


def camera_from_numpy(cam, device="cuda") -> Camera:
    dev = resolve_device(device)
    return Camera(R=_t(cam.R, dev), t=_t(cam.t, dev), tanfovx=_t(cam.tanfovx, dev),
                  tanfovy=_t(cam.tanfovy, dev), width=int(cam.width),
                  height=int(cam.height), znear=float(cam.znear), zfar=float(cam.zfar))


def plan_from_numpy(plan) -> FaceSortPlan:
    return FaceSortPlan(
        perm=np.asarray(plan.perm, np.int32),
        inv_perm=np.asarray(plan.inv_perm, np.int32),
        compact_ids=np.asarray(plan.compact_ids, np.int32),
        used_faces=np.asarray(plan.used_faces, np.int32),
        n_texels=int(plan.n_texels),
        n_compact=int(plan.n_compact),
        segment_starts=segment_starts(plan.compact_ids, int(plan.n_compact)),
    )


# flax ConvTranspose modules: their kernels are (kh, kw, I, O) and unflipped
_CONV_TRANSPOSE = ("resize0", "resize1")


def state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """A flax "params" tree -> a state dict under the same dotted names.

    Per leaf: conv kernels (kh, kw, I, O) and ModulatedConv weights
    (k, k, I, O) -> (O, I, kh, kw); ConvTranspose kernels -> (I, O, kh, kw),
    flipped spatially (flax does not flip, `nn.ConvTranspose2d` does); dense
    kernels (I, O) -> (O, I); LayerNorm `scale` -> `weight`;
    `constant_input` NHWC -> NCHW; `uv_base_feature` (U, U, C) -> (C, U, U).
    Everything else (biases, LayerScale gammas, tokens, embeddings, the
    vertex base feature) is carried as it is."""
    if "params" in params:
        params = params["params"]
    out = {}

    def walk(tree, prefix, owner):
        for name, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{name}.", name)
                continue
            a = np.asarray(v, np.float32)
            if name == "kernel" and a.ndim == 4 and owner in _CONV_TRANSPOSE:
                name, a = "weight", a[::-1, ::-1].transpose(2, 3, 0, 1)
            elif name in ("kernel", "weight") and a.ndim == 4:
                name, a = "weight", a.transpose(3, 2, 0, 1)
            elif name == "kernel" and a.ndim == 2:
                name, a = "weight", a.T
            elif name == "scale":
                name = "weight"
            elif name == "constant_input":
                a = a.transpose(0, 3, 1, 2)
            elif name == "uv_base_feature":
                a = a.transpose(2, 0, 1)
            out[prefix + name] = torch.tensor(np.array(a, order="C"))

    walk(params, "", "")
    return out


def refiner_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax `NeuralRefiner` variables (or their "params" subtree) -> the
    state dict of the port's `avatar.renderer.NeuralRefiner`."""
    return state_dict_from_flax(params)


def inferer_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax `UbodyGaussianInferer` variables (or their "params" subtree) ->
    the state dict of the port's `avatar.inferer.UbodyGaussianInferer`."""
    return state_dict_from_flax(params)


def inferer_from_flax(params: Mapping, cfg: InfererConfig, num_vertices: int,
                      device="cuda") -> UbodyGaussianInferer:
    """The port's inferer carrying a flax tree's weights, in eval mode on
    `device`. Raises unless every flax leaf lands on a parameter of the same
    shape and every parameter is filled."""
    dev = resolve_device(device)
    inferer = UbodyGaussianInferer(cfg, num_vertices)
    sd = inferer_state_dict_from_flax(params)
    want = inferer.state_dict()
    unused, unfilled = sorted(set(sd) - set(want)), sorted(set(want) - set(sd))
    if unused or unfilled:
        raise ValueError(f"flax leaves without a parameter: {unused}; "
                         f"parameters without a flax leaf: {unfilled}")
    inferer.load_state_dict(sd)        # strict: also checks every shape
    return inferer.to(dev).eval()


def lpips_from_flax(params: Mapping, net_type: str = "alex", device="cuda"):
    """The port's `train.lpips.LPIPS` carrying a flax LPIPS tree's weights."""
    from .train.lpips import LPIPS

    dev = resolve_device(device)
    lpips = LPIPS(net_type)
    lpips.load_state_dict(state_dict_from_flax(params))
    return lpips.requires_grad_(False).to(dev).eval()


def model_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """The training tree {"inferer": ..., "renderer": ...} of flax params (or
    of gradients: the mapping is a per-leaf transpose or flip, which carries
    a gradient as it carries a weight) -> one dict keyed
    `inferer.<name>` / `renderer.<name>` like `nn.ModuleDict.state_dict()`."""
    out = {}
    for part in ("inferer", "renderer"):
        for k, v in state_dict_from_flax(params[part]).items():
            out[f"{part}.{k}"] = v
    return out


def model_from_flax(params: Mapping, inferer, renderer) -> None:
    """Load the training tree {"inferer", "renderer"} of flax params into the
    two modules in place. Raises on a stray, missing or misshapen leaf."""
    inferer.load_state_dict(state_dict_from_flax(params["inferer"]))
    renderer.load_state_dict(state_dict_from_flax(params["renderer"]))
