"""LPIPS perceptual distance (counterpart of `guava_renderer_tpu/train/lpips.py`).

A frozen AlexNet or VGG16 feature stack, per-layer unit normalisation over
channels, 1x1 linear heads, spatial mean, summed over layers. As in the
reference, the caller's [0, 1] images are z-scored as they are (no map to
[-1, 1]). The module's parameter names follow the flax tree (`backbone.conv{i}`,
`lin{i}`), so `convert.lpips_from_flax` is a per-leaf transpose.

Without the official weight files the stack is random (`init_lpips_`): the
loss's mechanism, shapes and gradients are those of the real one. The
weights are frozen; the distance is differentiable in its inputs.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import resize_bilinear

IMAGENET_SHIFT = (-0.030, -0.088, -0.188)   # the LPIPS scaling layer's constants
IMAGENET_SCALE = (0.458, 0.448, 0.450)
CHANNELS = {"alex": (64, 192, 384, 256, 256), "vgg": (64, 128, 256, 512, 512)}
_VGG_STAGES = (2, 2, 3, 3, 3)               # convolutions a stage


class AlexNetFeatures(nn.Module):
    """The 5 conv stages of AlexNet (torchvision layout), NCHW."""

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv2d(3, 64, 11, stride=4, padding=2)
        self.conv1 = nn.Conv2d(64, 192, 5, padding=2)
        self.conv2 = nn.Conv2d(192, 384, 3, padding=1)
        self.conv3 = nn.Conv2d(384, 256, 3, padding=1)
        self.conv4 = nn.Conv2d(256, 256, 3, padding=1)

    def forward(self, x):
        feats = [F.relu(self.conv0(x))]
        feats.append(F.relu(self.conv1(F.max_pool2d(feats[-1], 3, 2))))
        feats.append(F.relu(self.conv2(F.max_pool2d(feats[-1], 3, 2))))
        feats.append(F.relu(self.conv3(feats[-1])))
        feats.append(F.relu(self.conv4(feats[-1])))
        return feats


class VGG16Features(nn.Module):
    """VGG16 relu1_2 .. relu5_3 feature stages, NCHW."""

    def __init__(self):
        super().__init__()
        cin, li = 3, 0
        for ch, n in zip(CHANNELS["vgg"], _VGG_STAGES):
            for _ in range(n):
                self.add_module(f"conv{li}", nn.Conv2d(cin, ch, 3, padding=1))
                cin, li = ch, li + 1

    def forward(self, x):
        feats, li = [], 0
        for stage, n in enumerate(_VGG_STAGES):
            for _ in range(n):
                x = F.relu(getattr(self, f"conv{li}")(x))
                li += 1
            feats.append(x)
            if stage < 4:
                x = F.max_pool2d(x, 2, 2)
        return feats


class LPIPS(nn.Module):
    def __init__(self, net_type: str = "alex"):
        super().__init__()
        if net_type not in CHANNELS:
            raise ValueError(f"net_type must be 'alex' or 'vgg', got {net_type!r}")
        self.net_type = net_type
        self.backbone = AlexNetFeatures() if net_type == "alex" else VGG16Features()
        for i, ch in enumerate(CHANNELS[net_type]):
            self.add_module(f"lin{i}", nn.Conv2d(ch, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(IMAGENET_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(IMAGENET_SCALE).view(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y (B, H, W, 3) in [0, 1] -> the mean LPIPS distance (scalar)."""
        x = x.permute(0, 3, 1, 2)
        y = y.permute(0, 3, 1, 2)
        # AlexNet's stride-4 stem and pools collapse inputs under 32 pixels
        # to empty maps; small configurations are upsampled to that floor
        if x.shape[2] < 32 or x.shape[3] < 32:
            size = (max(32, x.shape[2]), max(32, x.shape[3]))
            x = resize_bilinear(x, size)
            y = resize_bilinear(y, size)
        fx = self.backbone((x - self.shift) / self.scale)
        fy = self.backbone((y - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-10)
            total = total + getattr(self, f"lin{i}")((a - b) ** 2).mean()
        return total


@torch.no_grad()
def init_lpips_(module: LPIPS, generator: torch.Generator) -> LPIPS:
    """Seeded random weights: backbone kernels N(0, 1/fan_in), biases 0,
    linear heads uniform in [0, 0.1) (the official heads are non-negative,
    which keeps the distance non-negative)."""
    for name, p in module.named_parameters():
        if name.startswith("lin"):
            p.copy_(torch.rand(p.shape, generator=generator) * 0.1)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(p[0].numel()))
    return module


def lpips_state_dict(torch_state: dict) -> dict[str, torch.Tensor]:
    """A torch LPIPS state_dict (a torchvision-style backbone and the `lin`
    heads) -> this module's names (counterpart of the JAX
    `train/lpips.py:load_torch_state`; the layouts are torch's on both
    sides). Backbone convolutions are numbered by the first number in their
    key, the heads likewise."""
    def layer_index(key: str) -> int:
        nums = re.findall(r"\d+", key)
        return int(nums[0]) if nums else 0

    def tensor(x):
        return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))

    out = {}
    conv_keys = sorted((k for k in torch_state
                        if "lin" not in k and k.endswith("weight")
                        and np.ndim(torch_state[k]) == 4), key=layer_index)
    for i, k in enumerate(conv_keys):
        out[f"backbone.conv{i}.weight"] = tensor(torch_state[k])
        bk = k[:-len("weight")] + "bias"
        if bk in torch_state:
            out[f"backbone.conv{i}.bias"] = tensor(torch_state[bk])
    lin_keys = sorted((k for k in torch_state if "lin" in k and k.endswith("weight")),
                      key=layer_index)
    for i, k in enumerate(lin_keys):
        out[f"lin{i}.weight"] = tensor(torch_state[k])
    return out


def load_torch_state(module: LPIPS, torch_state: dict) -> LPIPS:
    """Load a torch LPIPS state_dict into `module` in place. Entries the state
    dict lacks keep their values; a stray or misshapen one raises."""
    from .weights import merge_params

    module.load_state_dict(merge_params(module.state_dict(), lpips_state_dict(torch_state)))
    return module
