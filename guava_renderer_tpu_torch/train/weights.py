"""Released-checkpoint and pretrained-weight converters (counterpart of
`guava_renderer_tpu/train/weights.py`, `tools/convert_weights.py` and
`train/lpips.py:load_torch_state`).

The released GUAVA checkpoint (`best_*.pt`, ref: main/test.py:242-252) holds
two state_dicts: 'model' (Ubody_Gaussian_inferer, ref:
ubody_gaussian.py:20-159, with the frozen DINOv2 backbone under
dino_encoder.dino_model.*) and 'render_model' (GaussianRenderer.nerual_refiner,
ref: gaussian_render.py:7-17). `convert_guava_state` maps both onto the flax
names that the port's modules carry, {"inferer": ..., "renderer": ...}, as
pure layout changes:

  torch Conv2d  (O, I, kH, kW)        -> flax Conv         (kH, kW, I, O)
  torch Linear  (O, I)                -> flax Dense        (I, O)
  torch ConvT2d (I, O, kH, kW)        -> flax ConvTranspose (kH, kW, I, O)
                                         with spatial flip
  ModulatedConv2d.weight (1,O,I,k,k)  -> (k, k, I, O)
  final_linear over NCHW-flat         -> column permutation to NHWC-flat

and `guava_state_dict` composes it with `convert.state_dict_from_flax`, so
a released checkpoint lands in the port's modules as one state dict keyed
like `cli/context.py:Runtime.model` ("inferer.*", "renderer.*"). The name
maps are this package's own copy of the JAX package's.

DINOv2 needs no layout change: the port's ViT holds torch layouts and a
fused qkv, so `dinov2_state_dict` is a rename. Converted weights are saved
as `torch.save` of state dicts (`converted_params.pt`, `dinov2_vitb14.pt`,
`lpips_alex.pt`); the port reads no flax msgpack.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


# ---------------------------------------------------------------------------
# primitive layout transforms
# ---------------------------------------------------------------------------


def t2f_conv(w) -> np.ndarray:
    """torch conv (O, I, H, W) -> flax (H, W, I, O)."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def t2f_dense(w) -> np.ndarray:
    """torch linear (O, I) -> flax (I, O)."""
    return np.transpose(np.asarray(w))


def t2f_convT(w) -> np.ndarray:
    """torch ConvTranspose2d (I, O, kH, kW) -> flax (kH, kW, I, O), spatially
    flipped (flax ConvTranspose does not flip; torch's adjoint does)."""
    k = np.transpose(np.asarray(w), (2, 3, 0, 1))
    return np.ascontiguousarray(k[::-1, ::-1])


def _conv(sd: dict, p: str, bias: bool = True) -> dict:
    out = {"kernel": t2f_conv(sd[p + ".weight"])}
    if bias:
        out["bias"] = np.asarray(sd[p + ".bias"])
    return out


def _convT(sd: dict, p: str) -> dict:
    return {"kernel": t2f_convT(sd[p + ".weight"]), "bias": np.asarray(sd[p + ".bias"])}


def _dense(sd: dict, p: str) -> dict:
    return {"kernel": t2f_dense(sd[p + ".weight"]), "bias": np.asarray(sd[p + ".bias"])}


# ---------------------------------------------------------------------------
# shared blocks
# ---------------------------------------------------------------------------


def _resblock(sd: dict, p: str) -> dict:
    """Bilinear ResBlock (ref: styleunet.py:410-441) -> layers.ResBlock
    (anonymous convs: conv1->Conv_0, conv2->Conv_1, skip->Conv_2)."""
    return {
        "Conv_0": _conv(sd, p + ".conv1"),
        "Conv_1": _conv(sd, p + ".conv2"),
        "Conv_2": _conv(sd, p + ".skip", bias=False),
    }


def _rcu(sd: dict, p: str) -> dict:
    """ResidualConvUnit (ref: dino_encoder.py:118-170)."""
    return {"Conv_0": _conv(sd, p + ".conv1"), "Conv_1": _conv(sd, p + ".conv2")}


def _ffb(sd: dict, p: str, with_res1: bool) -> dict:
    """FeatureFusionBlock (ref: dino_encoder.py:173-228). The first refinenet
    stage never runs resConfUnit1 (no skip input) and our flax module only
    instantiates `res1` when a skip exists, so those torch params are dropped."""
    out = {
        "res2": _rcu(sd, p + ".resConfUnit2"),
        "Conv_0": _conv(sd, p + ".out_conv"),
    }
    if with_res1:
        out["res1"] = _rcu(sd, p + ".resConfUnit1")
    return out


def _modconv(sd: dict, p: str) -> dict:
    """ModulatedConv2d (ref: styleunet.py:518-567) -> ModulatedConv."""
    w = np.asarray(sd[p + ".weight"])[0]  # (O, I, k, k)
    return {
        "modulation": _dense(sd, p + ".modulation"),
        "weight": np.transpose(w, (2, 3, 1, 0)),  # (k, k, I, O)
    }


def _styleconv(sd: dict, p: str) -> dict:
    """StyleConv (ref: styleunet.py:489-516)."""
    return {
        "mod": _modconv(sd, p + ".modulated_conv"),
        "noise_weight": np.asarray(sd[p + ".weight"]).reshape(()),
        "bias": np.asarray(sd[p + ".bias"]).reshape(-1),
    }


def _torgb(sd: dict, p: str) -> dict:
    return {
        "mod": _modconv(sd, p + ".modulated_conv"),
        "bias": np.asarray(sd[p + ".bias"]).reshape(-1),
    }


def _final_linear(sd: dict, p: str, ch4: int) -> dict:
    """StyleUNet.final_linear flattens torch NCHW (C,4,4); our flax flattens
    NHWC (4,4,C). Permute the input columns accordingly."""
    w = np.asarray(sd[p + ".weight"])  # (style, C*16)
    idx = np.empty(ch4 * 16, np.int64)
    j = 0
    for h in range(4):
        for wx in range(4):
            for c in range(ch4):
                idx[j] = c * 16 + h * 4 + wx
                j += 1
    return {"kernel": np.transpose(w[:, idx]), "bias": np.asarray(sd[p + ".bias"])}


# ---------------------------------------------------------------------------
# StyleUNet / StyleGAN2 generator
# ---------------------------------------------------------------------------

_CHANNELS = {4: 256, 8: 256, 16: 256, 32: 256, 64: 128, 128: 64, 256: 32, 512: 16, 1024: 8}


def _chan(size: int, scale: float) -> int:
    return int(_CHANNELS[size] / scale)


def convert_generator(sd: dict, p: str, out_size: int, channel_scale: float,
                      small: bool, num_mlp: int = 8) -> dict:
    """StyleGAN2GeneratorCSFT[_small] (ref: styleunet.py:211-407)."""
    import math

    log_size = int(math.log2(out_size))
    out = {"style_mlp": {}}
    for i in range(num_mlp):
        # Sequential: [NormStyleCode, Linear, LeakyReLU, Linear, ...] -> 1+2i
        out["style_mlp"][f"mlp{i}"] = _dense(sd, f"{p}.style_mlp.{1 + 2 * i}")
    cw = np.asarray(sd[p + ".constant_input.weight"])  # (1, C, 4, 4)
    out["constant_input"] = np.transpose(cw, (0, 2, 3, 1))
    out["conv1"] = _styleconv(sd, p + ".style_conv1")
    out["to_rgb1"] = _torgb(sd, p + ".to_rgb1")
    for li in range(log_size - 2):
        if small:
            out[f"conv_up{li}"] = _styleconv(sd, f"{p}.style_convs.{li}")
            out[f"conv_plain{li}"] = _conv(sd, f"{p}.normal_convs.{li}.0")
        else:
            out[f"conv_up{li}"] = _styleconv(sd, f"{p}.style_convs.{2 * li}")
            out[f"conv_same{li}"] = _styleconv(sd, f"{p}.style_convs.{2 * li + 1}")
        out[f"to_rgb_up{li}"] = _torgb(sd, f"{p}.to_rgbs.{li}")
    return out


def convert_styleunet(sd: dict, p: str, in_size: int, out_size: int,
                      channel_scale: float = 1.0, small: bool = False,
                      extra_style: bool = False, num_mlp: int = 8) -> dict:
    """StyleUNet (ref: styleunet.py:86-207) -> models.styleunet.StyleUNet."""
    import math

    log_size = int(math.log2(out_size))
    out: dict = {}
    if in_size <= out_size:
        out["first"] = _conv(sd, p + ".conv_body_first")
    else:
        out["first"] = _conv(sd, p + ".conv_body_first.0")
        out["first_down"] = _resblock(sd, p + ".conv_body_first.1")
    for li in range(log_size - 2):
        out[f"down{li}"] = _resblock(sd, f"{p}.conv_body_down.{li}")
    out["final_conv"] = _conv(sd, p + ".final_conv")
    out["final_linear"] = _final_linear(sd, p + ".final_linear", _chan(4, channel_scale))
    if extra_style:
        out["style_fuse0"] = _dense(sd, p + ".style_fuse.0")
        out["style_fuse1"] = _dense(sd, p + ".style_fuse.2")
    for li in range(log_size - 2):
        out[f"up{li}"] = _resblock(sd, f"{p}.conv_body_up.{li}")
        # the flax module fuses the two first condition convs (shared
        # input) into one out-channel-concatenated conv, models/styleunet.py
        ca = _conv(sd, f"{p}.condition_scale.{li}.0")
        cb = _conv(sd, f"{p}.condition_shift.{li}.0")
        out[f"cond_a{li}"] = {
            "kernel": np.concatenate([ca["kernel"], cb["kernel"]], axis=-1),
            "bias": np.concatenate([ca["bias"], cb["bias"]]),
        }
        out[f"cond_scale{li}b"] = _conv(sd, f"{p}.condition_scale.{li}.2")
        out[f"cond_shift{li}b"] = _conv(sd, f"{p}.condition_shift.{li}.2")
    out["generator"] = convert_generator(
        sd, p + ".stylegan_decoder", out_size, channel_scale, small, num_mlp
    )
    return out


# ---------------------------------------------------------------------------
# ViT (DINOv2) + DPT encoder
# ---------------------------------------------------------------------------


def convert_dinov2_vit(sd: dict, p: str = "", depth: int | None = None) -> dict:
    """DINOv2 ViT-B/14 state_dict -> our VisionTransformer tree."""
    if depth is None:  # infer from the block keys present
        depth = 1 + max(
            int(k[len(p) + 7:].split(".")[0])
            for k in sd
            if k.startswith(p + "blocks.")
        )
    g = lambda k: np.asarray(sd[p + k])  # noqa: E731
    out = {
        "patch_embed": {
            "kernel": t2f_conv(sd[p + "patch_embed.proj.weight"]),
            "bias": g("patch_embed.proj.bias"),
        },
        "cls_token": g("cls_token"),
        "pos_embed": g("pos_embed"),
        "norm": {"scale": g("norm.weight"), "bias": g("norm.bias")},
    }
    for i in range(depth):
        b = f"{p}blocks.{i}."
        out[f"block{i}"] = {
            "norm1": {"scale": np.asarray(sd[b + "norm1.weight"]),
                      "bias": np.asarray(sd[b + "norm1.bias"])},
            "attn": {
                "qkv": {"kernel": t2f_dense(sd[b + "attn.qkv.weight"]),
                        "bias": np.asarray(sd[b + "attn.qkv.bias"])},
                "proj": {"kernel": t2f_dense(sd[b + "attn.proj.weight"]),
                         "bias": np.asarray(sd[b + "attn.proj.bias"])},
            },
            "ls1": {"gamma": np.asarray(sd[b + "ls1.gamma"])},
            "norm2": {"scale": np.asarray(sd[b + "norm2.weight"]),
                      "bias": np.asarray(sd[b + "norm2.bias"])},
            "mlp": {
                "Dense_0": {"kernel": t2f_dense(sd[b + "mlp.fc1.weight"]),
                            "bias": np.asarray(sd[b + "mlp.fc1.bias"])},
                "Dense_1": {"kernel": t2f_dense(sd[b + "mlp.fc2.weight"]),
                            "bias": np.asarray(sd[b + "mlp.fc2.bias"])},
            },
            "ls2": {"gamma": np.asarray(sd[b + "ls2.gamma"])},
        }
    return out


def convert_dpt_encoder(sd: dict, p: str = "dino_encoder") -> dict:
    """DINO_Enocder (ref: dino_encoder.py:6-113) -> DinoDPTEncoder tree."""
    out: dict = {"dino": convert_dinov2_vit(sd, p + ".dino_model.")}
    for i in range(4):
        out[f"project{i}"] = _conv(sd, f"{p}.projects.{i}")
    out["resize0"] = _convT(sd, f"{p}.resize_layers.0")
    out["resize1"] = _convT(sd, f"{p}.resize_layers.1")
    out["resize3"] = _conv(sd, f"{p}.resize_layers.3")
    for i in range(4):
        out[f"layer_rn{i}"] = _conv(sd, f"{p}.layer_rn.{i}", bias=False)
    # refinenet[0] is applied without a skip input -> no res1 in our tree
    for i in range(4):
        out[f"refine{i}"] = _ffb(sd, f"{p}.refinenet.{i}", with_res1=(i > 0))
    # project_l Sequential: [Upsample, Conv, Upsample, Conv]
    out["project_l0"] = _conv(sd, f"{p}.project_l.1", bias=False)
    out["project_l1"] = _conv(sd, f"{p}.project_l.3", bias=False)
    out["fuse_l0"] = _conv(sd, f"{p}.fuse_l.0", bias=False)
    out["fuse_l1"] = _conv(sd, f"{p}.fuse_l.2", bias=False)
    out["skip_l"] = _conv(sd, f"{p}.skip_l", bias=False)
    out["output_conv"] = _conv(sd, f"{p}.output_conv")
    out["output_conv_2"] = _conv(sd, f"{p}.output_conv_2")
    return out


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------


def convert_vertex_decoder(sd: dict, p: str = "vertex_gs_decoder") -> dict:
    """Vertex_GS_Decoder (ref: feature_decoder.py:9-62)."""
    out = {}
    for i, ti in enumerate((0, 2, 4, 6)):
        out[f"trunk{i}"] = _dense(sd, f"{p}.feature_layers.{ti}")
    for ours, theirs in (("color", "color_layers"), ("opacity", "opacity_layers"),
                         ("scale", "scale_layers"), ("rotation", "rotation_layers")):
        out[f"{ours}0"] = _dense(sd, f"{p}.{theirs}.0")
        out[f"{ours}1"] = _dense(sd, f"{p}.{theirs}.2")
    return out


def convert_uv_decoder(sd: dict, p: str = "uv_point_decoder") -> dict:
    """UV_Point_GS_Decoder (ref: feature_decoder.py:64-137)."""
    out = {}
    for i, ti in enumerate((0, 2, 4)):
        out[f"trunk{i}"] = _conv(sd, f"{p}.feature_conv.{ti}")
    for ours, theirs in (("color", "color_head"), ("opacity", "opacity_head"),
                         ("scale", "scale_head"), ("rotation", "rot_head")):
        out[f"{ours}0"] = _conv(sd, f"{p}.{theirs}.0")
        out[f"{ours}1"] = _conv(sd, f"{p}.{theirs}.2")
    for i, ti in enumerate((0, 2, 4)):
        out[f"localpos{i}"] = _conv(sd, f"{p}.local_pos_head.{ti}")
    return out


# ---------------------------------------------------------------------------
# full checkpoint
# ---------------------------------------------------------------------------


def convert_guava_state(
    model_sd: dict,
    render_sd: dict,
    uvmap_size: int = 512,
    image_size: int = 512,
    num_mlp: int = 8,
    channel_scale: float = 1.0,
) -> dict:
    """Map the released GUAVA checkpoint's two state_dicts onto our
    {"inferer": ..., "renderer": ...} tree. Asset buffers baked into the
    torch module (ehm.*, smplx.*, v_template, laplacian_matrix,
    xy_image_coord, mesh_renderer.*, uv_mask_flat, noises.*) are static data
    owned by our asset layer and are intentionally not converted."""
    inferer: dict = {}
    inferer["dino_encoder"] = convert_dpt_encoder(model_sd, "dino_encoder")
    for i, ti in enumerate((0, 2, 4)):
        inferer[f"global_map{i}"] = _dense(model_sd, f"global_feature_mapping.{ti}")
        inferer[f"uv_style_map{i}"] = _dense(model_sd, f"uv_style_mapping.{ti}")
    inferer["vertex_base_feature"] = np.asarray(model_sd["vertex_base_feature"])
    # (32, U, U) -> (U, U, 32)
    inferer["uv_base_feature"] = np.transpose(
        np.asarray(model_sd["uv_base_feature"]), (1, 2, 0)
    )
    inferer["vertex_gs_decoder"] = convert_vertex_decoder(model_sd)
    inferer["uv_point_decoder"] = convert_uv_decoder(model_sd)
    inferer["uv_feature_decoder"] = convert_styleunet(
        model_sd, "uv_feature_decoder",
        in_size=uvmap_size, out_size=uvmap_size,
        channel_scale=channel_scale, small=False, extra_style=True,
        num_mlp=num_mlp,
    )

    renderer = {
        "neural_refiner": {
            "refiner": convert_styleunet(
                render_sd, "nerual_refiner",
                in_size=image_size, out_size=image_size,
                channel_scale=channel_scale, small=True, extra_style=False,
                num_mlp=num_mlp,
            )
        }
    }
    return {"inferer": inferer, "renderer": renderer}


# ---------------------------------------------------------------------------
# the port's state dicts
# ---------------------------------------------------------------------------


def guava_state_dict(model_sd: dict, render_sd: dict, **kwargs) -> dict[str, torch.Tensor]:
    """The released checkpoint's two state_dicts -> one state dict of the
    port's {"inferer", "renderer"} modules (`Runtime.model`). `kwargs` are
    `convert_guava_state`'s sizes."""
    from ..convert import model_state_dict_from_flax

    return model_state_dict_from_flax(convert_guava_state(model_sd, render_sd, **kwargs))


def dinov2_state_dict(state: Mapping, depth: int | None = None) -> dict[str, torch.Tensor]:
    """A torch-hub DINOv2 state_dict -> the port's `models.vit.VisionTransformer`
    state dict (ref names -> flax names; the layouts are torch's on both
    sides). Keys the ViT has no use for (e.g. mask_token) are dropped."""
    if depth is None:
        depth = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("blocks."))
    names = {"patch_embed.weight": "patch_embed.proj.weight",
             "patch_embed.bias": "patch_embed.proj.bias",
             "cls_token": "cls_token", "pos_embed": "pos_embed",
             "norm.weight": "norm.weight", "norm.bias": "norm.bias"}
    for i in range(depth):
        for ours, theirs in (("norm1", "norm1"), ("attn.qkv", "attn.qkv"),
                             ("attn.proj", "attn.proj"), ("norm2", "norm2"),
                             ("mlp.Dense_0", "mlp.fc1"), ("mlp.Dense_1", "mlp.fc2")):
            for leaf in ("weight", "bias"):
                names[f"block{i}.{ours}.{leaf}"] = f"blocks.{i}.{theirs}.{leaf}"
        for ls in ("ls1", "ls2"):
            names[f"block{i}.{ls}.gamma"] = f"blocks.{i}.{ls}.gamma"
    return {ours: _tensor(state[theirs]) for ours, theirs in names.items()}


def merge_params(template: Mapping, loaded: Mapping, require_all: bool = False,
                 path: str = "") -> dict:
    """Overlay `loaded` onto `template` (nested or flat dicts of tensors or
    arrays), validating keys and shapes; leaves come back as tensors in the
    template leaf's dtype and device."""
    extra = set(loaded) - set(template)
    if extra:
        raise ValueError(f"unexpected keys at {path or '/'}: {sorted(extra)[:8]}")
    missing = set(template) - set(loaded)
    if missing and require_all:
        raise ValueError(f"missing keys at {path or '/'}: {sorted(missing)[:8]}")
    out = {}
    for k, t in template.items():
        if k not in loaded:
            out[k] = t
        elif isinstance(t, Mapping):
            out[k] = merge_params(t, loaded[k], require_all, f"{path}/{k}")
        else:
            lv = _tensor(loaded[k])
            if tuple(t.shape) != tuple(lv.shape):
                raise ValueError(f"shape mismatch at {path}/{k}: {tuple(t.shape)} vs "
                                 f"{tuple(lv.shape)}")
            tt = torch.as_tensor(t)
            out[k] = lv.to(dtype=tt.dtype, device=tt.device)
    return out


def save_converted_params(path: str, state_dict: Mapping) -> None:
    """`torch.save` of a state dict, its tensors on the CPU."""
    torch.save({k: _tensor(v).detach().cpu().contiguous() for k, v in state_dict.items()}, path)


def load_converted_params(path: str, template: Mapping) -> dict:
    """A saved state dict checked against `template` (every key, every shape)."""
    return merge_params(template, torch.load(path, map_location="cpu", weights_only=True),
                        require_all=True)


def load_state_file(path: str, module: torch.nn.Module) -> torch.nn.Module:
    """Load a saved state dict into `module` in place; raises on a stray,
    missing or misshapen entry."""
    module.load_state_dict(load_converted_params(path, module.state_dict()))
    return module


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
