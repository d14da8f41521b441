"""The inputs the benchmark makes from `--seed` and hands to both sides, the
port and the reference: module weights and the avatar's splats.

Both are drawn on the device by a `torch.Generator` there, in a few large
calls, so set-up does not wait on the host's random numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the parts of one run's inputs, each drawn from its own generator
WEIGHTS, AVATAR, COLOURS = 1, 2, 3


def generator(seed: int, part: int, device) -> torch.Generator:
    """A generator on `device` for one part of a run's inputs. The run's
    seed may exceed 64 bits' worth of parts; it is folded into 63 bits."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + part) % (2 ** 63))


@torch.no_grad()
def fill_weights(module: torch.nn.Module, seed: int, gain: float = 1.0, part: int = 0) -> int:
    """Seeded weights for `module`, by the rules of the port's flax-scale
    initializer (`models/styleunet.py:init_params_`) read off the parameter
    names: kernels and dense weights N(0, gain^2 / fan_in), biases and noise
    weights 0, modulation biases, LayerNorm scales and LayerScale gammas 1,
    position embeddings N(0, 0.02), constant inputs and base features
    N(0, 1). One normal draw on the device covers
    every parameter, taken in `named_parameters` order, so two modules with
    the same names and shapes get the same values; `part` tells apart the
    networks of one run. -> parameters filled."""
    norms = {n for n, m in module.named_modules() if isinstance(m, torch.nn.LayerNorm)}
    params = list(module.named_parameters())
    total = sum(p.numel() for _, p in params)
    dev = params[0][1].device
    gen = generator(seed, WEIGHTS if part == 0 else 100 + part, dev)
    draw = torch.randn(total, generator=gen, device=dev)
    at = 0
    for name, p in params:
        owner, _, leaf = name.rpartition(".")
        x = draw[at:at + p.numel()].view(p.shape)
        at += p.numel()
        if name.endswith("modulation.bias") or leaf == "gamma" or \
                (owner in norms and leaf == "weight"):
            p.fill_(1.0)
        elif leaf in ("bias", "noise_weight", "cls_token"):
            p.zero_()
        elif leaf == "pos_embed":
            p.copy_(x * 0.02)
        elif leaf in ("constant_input", "vertex_base_feature", "uv_base_feature"):
            p.copy_(x)
        else:
            p.copy_(x * (gain / math.sqrt(p[0].numel())))
    return total


@torch.no_grad()
def avatar_draws(geometry_seed: int, colour_seed: int, n_vtx: int, n_uv: int, device) -> dict:
    """The splats of a trained avatar, by the statistics of the port's bench
    scene (`benchscene.make_bench_scene`): opacities sigmoid(N(-1, 1.5));
    scales mostly sub-tile with a fat tail of multi-tile splats
    (lognormal(-4.2, 0.3) for 85%, (-3.0, 0.3) for 10%, (-1.9, 0.4) for 5%,
    times 0.7 on vertices and 40 on the UV chart, each axis then times
    lognormal(0, 0.2) but the first); rotations uniform unit quaternions
    (wxyz); UV offsets U(-0.5, 0.5); colours U(0, 1). The geometry, which
    sets the work a frame takes, comes from `geometry_seed`, the colours,
    which do not, from `colour_seed`. -> {name: tensor with a leading batch
    of 1}, the vertex set first, then the UV set."""
    g = generator(geometry_seed, AVATAR, device)
    n = n_vtx + n_uv

    def uniform(*shape):
        return torch.rand(shape, generator=g, device=device)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    pick, z = uniform(n), normal(n, 3)
    mu = torch.where(pick < 0.85, -4.2, torch.where(pick < 0.95, -3.0, -1.9))
    sd = torch.where(pick < 0.95, 0.3, 0.4)
    s = torch.exp(mu + sd * z[:, 0])
    s = s * torch.cat([torch.full((n_vtx,), 0.7, device=device),
                       torch.full((n_uv,), 40.0, device=device)])
    scales = torch.stack([s, s * torch.exp(0.2 * z[:, 1]), s * torch.exp(0.2 * z[:, 2])], -1)
    opacity = torch.sigmoid(-1.0 + 1.5 * normal(n, 1))
    quats = normal(n, 4)
    quats = quats / quats.norm(dim=-1, keepdim=True)
    local = uniform(n_uv, 3) - 0.5
    colors = torch.rand((n, 32), generator=generator(colour_seed, COLOURS, device), device=device)
    v, u = slice(0, n_vtx), slice(n_vtx, n)
    return {
        "vtx_colors": colors[v][None], "vtx_opacity": opacity[v][None],
        "vtx_scales": scales[v][None], "vtx_rotations": quats[v][None],
        "uv_local_xyz": local[None], "uv_colors": colors[u][None],
        "uv_opacity": opacity[u][None], "uv_scales": scales[u][None],
        "uv_rotations": quats[u][None],
    }


def on_rig(draws: dict, smplx, extras, device) -> dict:
    """The draws on a body-model rig (its template vertices and its UV
    chart's binding faces, barycentres and mask), unpruned:
    {GaussianAvatar field: tensor}. Each side passes its own rig."""
    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return dict(draws,
                vtx_positions=t(smplx.v_template)[None],
                uv_binding_face=t(extras.uvmap_f_idx.reshape(-1), torch.int64),
                uv_face_bary=t(extras.uvmap_f_bary.reshape(-1, 3)),
                uv_valid=t(extras.uvmap_mask.reshape(-1), torch.bool))
