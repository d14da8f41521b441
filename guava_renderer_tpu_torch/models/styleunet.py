"""StyleUNet: a UNet encoder + StyleGAN2-CSFT generator (counterpart of
`guava_renderer_tpu/models/styleunet.py:StyleUNet`, in_size == out_size),
and SimpleUNet, the refiner family without the style path.

A bilinear ResBlock UNet produces a style code (4x4 bottleneck -> linear,
optionally fused with an extra style vector) and per-scale SFT scale/shift
conditions; a StyleGAN2 generator with weight (de)modulation consumes
them, with two style convs per scale, or one style conv and one plain conv
in the `small` variant (the refiner). Modulation scales the inputs, one
shared conv runs, and demodulation scales the outputs. Inference injects
no noise.

Internally NCHW; submodules carry the flax names so convert.py maps a flax
tree leaf by leaf. The style code flattens the bottleneck in NHWC order, as
the flax `final_linear` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ResBlock, conv, leaky_relu, resize_bilinear, upsample2x

_CHANNELS = {4: 256, 8: 256, 16: 256, 32: 256, 64: 128, 128: 64, 256: 32, 512: 16, 1024: 8}


def _chan(size: int, scale: float) -> int:
    return int(_CHANNELS[size] / scale)


class ModulatedConv(nn.Module):
    """StyleGAN2 modulated conv (input-scale / output-demodulate form)."""

    def __init__(self, in_channels, out_channels, kernel, style_dim, demodulate=True,
                 upsample=False):
        super().__init__()
        self.kernel, self.demodulate, self.upsample = kernel, demodulate, upsample
        self.modulation = nn.Linear(style_dim, in_channels)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel))

    def forward(self, x, style):
        s = self.modulation(style)                         # (B, C)
        if self.upsample:
            x = upsample2x(x)
        out = F.conv2d(x * s[:, :, None, None], self.weight, padding=self.kernel // 2)
        if self.demodulate:
            w2 = (s * s) @ (self.weight * self.weight).sum((2, 3)).T   # (B, O)
            out = out * torch.rsqrt(w2 + 1e-8)[:, :, None, None]
        return out


class StyleConv(nn.Module):
    def __init__(self, in_channels, out_channels, style_dim, upsample=False):
        super().__init__()
        self.mod = ModulatedConv(in_channels, out_channels, 3, style_dim, True, upsample)
        self.noise_weight = nn.Parameter(torch.zeros(()))   # noise is off at inference
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, style):
        out = self.mod(x, style) * (2 ** 0.5)
        return leaky_relu(out + self.bias[None, :, None, None])


class ToRGB(nn.Module):
    def __init__(self, in_channels, out_dim, style_dim, upsample=True):
        super().__init__()
        self.upsample = upsample
        self.mod = ModulatedConv(in_channels, out_dim, 1, style_dim, False, False)
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x, style, skip=None):
        out = self.mod(x, style) + self.bias[None, :, None, None]
        if skip is not None:
            out = out + (upsample2x(skip) if self.upsample else skip)
        return out


class StyleMLP(nn.Module):
    def __init__(self, style_dim, num_mlp):
        super().__init__()
        self.num_mlp = num_mlp
        for i in range(num_mlp):
            self.add_module(f"mlp{i}", nn.Linear(style_dim, style_dim))

    def forward(self, x):
        x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-8)
        for i in range(self.num_mlp):
            x = leaky_relu(getattr(self, f"mlp{i}")(x))
        return x


class StyleGAN2GeneratorCSFT(nn.Module):
    """Per scale: an upsampling style conv, the SFT, then a second style
    conv (`conv_same{li}`) or, when `small`, a plain conv (`conv_plain{li}`)."""

    def __init__(self, out_size, out_dim=3, style_dim=512, num_mlp=8, channel_scale=1.0,
                 small=False):
        super().__init__()
        cs = channel_scale
        self.small = small
        self.n_levels = int(math.log2(out_size)) - 2
        self.style_mlp = StyleMLP(style_dim, num_mlp)
        c4 = _chan(4, cs)
        self.constant_input = nn.Parameter(torch.empty(1, c4, 4, 4))
        self.conv1 = StyleConv(c4, c4, style_dim)
        self.to_rgb1 = ToRGB(c4, out_dim, style_dim, upsample=False)
        prev = c4
        for li in range(self.n_levels):
            ch = _chan(2 ** (li + 3), cs)
            self.add_module(f"conv_up{li}", StyleConv(prev, ch, style_dim, upsample=True))
            if small:
                self.add_module(f"conv_plain{li}", conv(ch, ch, 3))
            else:
                self.add_module(f"conv_same{li}", StyleConv(ch, ch, style_dim))
            self.add_module(f"to_rgb_up{li}", ToRGB(ch, out_dim, style_dim))
            prev = ch

    def forward(self, style, conditions):
        style = self.style_mlp(style)
        out = self.constant_input.expand(style.shape[0], -1, -1, -1)
        out = self.conv1(out, style)
        skip = self.to_rgb1(out, style)
        for li in range(self.n_levels):
            out = getattr(self, f"conv_up{li}")(out, style)
            out = out * conditions[2 * li] + conditions[2 * li + 1]   # SFT
            if self.small:
                out = leaky_relu(getattr(self, f"conv_plain{li}")(out))
            else:
                out = getattr(self, f"conv_same{li}")(out, style)
            skip = getattr(self, f"to_rgb_up{li}")(out, style, skip)
        return skip


class StyleUNet(nn.Module):
    """StyleUNet with in_size == out_size. Input/output NCHW; an input
    smaller than `size` is resized up first. With `extra_style_dim > 0`,
    `forward` fuses an extra style vector into the style code."""

    def __init__(self, size, in_dim, out_dim, style_dim=512, num_mlp=8, channel_scale=1.0,
                 small=False, activation=True, extra_style_dim=-1):
        super().__init__()
        cs = channel_scale
        self.size, self.activation = size, activation
        self.n_levels = int(math.log2(size)) - 2
        self.first = conv(in_dim, _chan(size, cs), 1)
        prev = _chan(size, cs)
        for li in range(self.n_levels):
            ch = _chan(size >> (li + 1), cs)
            self.add_module(f"down{li}", ResBlock(prev, ch, "down"))
            prev = ch
        c4 = _chan(4, cs)
        self.final_conv = conv(c4, c4, 3)
        self.final_linear = nn.Linear(c4 * 16, style_dim)
        if extra_style_dim > 0:
            self.style_fuse0 = nn.Linear(style_dim + extra_style_dim, style_dim)
            self.style_fuse1 = nn.Linear(style_dim, style_dim)
        for li in range(self.n_levels):
            ch = _chan(2 ** (li + 3), cs)
            self.add_module(f"up{li}", ResBlock(prev, ch, "up"))
            self.add_module(f"cond_a{li}", conv(ch, 2 * ch, 3))   # scale|shift first convs
            self.add_module(f"cond_scale{li}b", conv(ch, ch, 3))
            self.add_module(f"cond_shift{li}b", conv(ch, ch, 3))
            prev = ch
        self.generator = StyleGAN2GeneratorCSFT(size, out_dim, style_dim, num_mlp, cs, small)

    def forward(self, x, extra_style=None):
        if x.shape[-2] < self.size:
            x = resize_bilinear(x, (self.size, self.size))
        feat = leaky_relu(self.first(x))
        skips = []
        for li in range(self.n_levels):
            feat = getattr(self, f"down{li}")(feat)
            skips.insert(0, feat)
        feat = leaky_relu(self.final_conv(feat))
        style = self.final_linear(feat.permute(0, 2, 3, 1).reshape(feat.shape[0], -1))
        if extra_style is not None and hasattr(self, "style_fuse0"):
            h = leaky_relu(self.style_fuse0(torch.cat([style, extra_style], dim=-1)))
            style = self.style_fuse1(h)

        conditions = []
        for li in range(self.n_levels):
            feat = getattr(self, f"up{li}")(feat + skips[li])
            ab = getattr(self, f"cond_a{li}")(feat)
            ch = ab.shape[1] // 2
            conditions.append(getattr(self, f"cond_scale{li}b")(leaky_relu(ab[:, :ch])))
            conditions.append(getattr(self, f"cond_shift{li}b")(leaky_relu(ab[:, ch:])))
        image = self.generator(style, conditions)
        return torch.sigmoid(image) if self.activation else image


class SimpleUNet(nn.Module):
    """Bilinear ResBlock UNet with a 1x1 RGB head and no style path (counterpart
    of the JAX `SimpleUNet`, ref: styleunet.py:9-84). Input/output NCHW; an
    input smaller than `out_size` is resized up first."""

    def __init__(self, in_size, out_size, in_dim, out_dim, channel_scale=1.0):
        super().__init__()
        cs = channel_scale
        self.out_size = out_size
        log_size = int(math.log2(out_size))
        if in_size <= out_size:
            self.first = conv(in_dim, _chan(out_size, cs), 1)
        else:
            self.first = conv(in_dim, _chan(in_size, cs), 1)
            self.first_down = ResBlock(_chan(in_size, cs), _chan(out_size, cs), "down")
        prev = _chan(out_size, cs)
        self.n_levels = log_size - 2
        for li, res in enumerate(range(log_size, 2, -1)):
            ch = _chan(2 ** (res - 1), cs)
            self.add_module(f"down{li}", ResBlock(prev, ch, "down"))
            prev = ch
        self.final_conv = conv(prev, _chan(4, cs), 3)
        prev = _chan(4, cs)
        for li, res in enumerate(range(3, log_size + 1)):
            ch = _chan(2 ** res, cs)
            self.add_module(f"up{li}", ResBlock(prev, ch, "up"))
            prev = ch
        self.to_rgb = conv(prev, out_dim, 1)

    def forward(self, x):
        if x.shape[-2] < self.out_size:
            x = resize_bilinear(x, (self.out_size, self.out_size))
        feat = leaky_relu(self.first(x))
        if hasattr(self, "first_down"):
            feat = self.first_down(feat)
        skips = []
        for li in range(self.n_levels):
            feat = getattr(self, f"down{li}")(feat)
            skips.insert(0, feat)
        feat = leaky_relu(self.final_conv(feat))
        for li in range(self.n_levels):
            feat = getattr(self, f"up{li}")(feat + skips[li])
        return self.to_rgb(feat)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator, gain: float = 1.0) -> nn.Module:
    """Seeded random weights with the flax initializers' scales: kernels and
    dense weights N(0, gain^2 / fan_in), biases 0, modulation biases 1,
    constant input and the inferer's base features N(0, 1), noise weights 0;
    LayerNorm scales and LayerScale gammas 1, position embeddings
    N(0, 0.02), the CLS token 0.

    gain 1 is the flax scale, which the serving benches take. At the full
    model's depth it is an exploding start (the residual sums double the
    variance block by block: UV offsets of 1e4 and colours of 4e4), from
    which the first Adam steps at the configured learning rate overflow
    float32. Training from random weights takes gain 0.5, near PyTorch's own
    default of 1/sqrt(3 fan_in), which starts at offsets of 0.01."""
    norms = {n for n, m in module.named_modules() if isinstance(m, nn.LayerNorm)}
    for name, p in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        if name.endswith("modulation.bias") or leaf == "gamma" or \
                (owner in norms and leaf == "weight"):
            p.fill_(1.0)
        elif leaf in ("bias", "noise_weight", "cls_token"):
            p.zero_()
        elif leaf == "pos_embed":
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        elif leaf in ("constant_input", "vertex_base_feature", "uv_base_feature"):
            p.copy_(torch.randn(p.shape, generator=generator))
        else:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=generator) * gain / math.sqrt(fan_in))
    return module
