"""Avatar state: Gaussians bound to the EHM mesh (counterpart of
`guava_renderer_tpu/avatar/state.py`)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class GaussianAvatar(NamedTuple):
    """One identity's Gaussians (batch dim B kept, usually 1)."""

    vtx_positions: torch.Tensor     # (B, V, 3)
    vtx_colors: torch.Tensor        # (B, V, 32)
    vtx_opacity: torch.Tensor       # (B, V, 1)
    vtx_scales: torch.Tensor        # (B, V, 3)
    vtx_rotations: torch.Tensor     # (B, V, 4) wxyz
    uv_local_xyz: torch.Tensor      # (B, N, 3)
    uv_colors: torch.Tensor         # (B, N, 32)
    uv_opacity: torch.Tensor        # (B, N, 1) - 0 outside chart
    uv_scales: torch.Tensor         # (B, N, 3)
    uv_rotations: torch.Tensor      # (B, N, 4)
    uv_binding_face: torch.Tensor   # (N,) int64
    uv_face_bary: torch.Tensor      # (N, 3)
    uv_valid: torch.Tensor          # (N,) bool - chart mask


class GaussianSet(NamedTuple):
    """Deformed, render-ready Gaussians (vertex + uv concatenated)."""

    xyz: torch.Tensor         # (B, P, 3)
    rotation: torch.Tensor    # (B, P, 4)
    scaling: torch.Tensor     # (B, P, 3)
    opacity: torch.Tensor     # (B, P, 1)
    colors: torch.Tensor      # (B, P, 32)


_UV_KEYS = ("uv_local_xyz", "uv_colors", "uv_opacity", "uv_scales", "uv_rotations")
_PAD_MULTIPLE = 4096   # bucketed UV counts, as the JAX package pads them


def prune_avatar(avatar: GaussianAvatar, opacity_threshold: float = 0.001) -> GaussianAvatar:
    """Offline compaction (batch-1, on the host).

    Keeps UV Gaussians above the opacity threshold on the chart, then pads
    the kept set to a multiple of 4096 (never beyond the unpruned count)
    with zero-opacity invalid rows carrying identity quats and tiny scales,
    so the pad stays NaN-free."""
    device = avatar.uv_local_xyz.device
    a = {k: v.detach().cpu().numpy() for k, v in avatar._asdict().items()}
    keep = (a["uv_opacity"][0, :, 0] > opacity_threshold) & a["uv_valid"]
    out = dict(a)
    for k in _UV_KEYS:
        out[k] = a[k][:, keep]
    out["uv_binding_face"] = a["uv_binding_face"][keep]
    out["uv_face_bary"] = a["uv_face_bary"][keep]
    n = int(keep.sum())
    out["uv_valid"] = np.ones(n, bool)
    target = min(-(-max(n, 1) // _PAD_MULTIPLE) * _PAD_MULTIPLE, a["uv_local_xyz"].shape[1])
    pad = max(0, target - n)
    if pad:
        for k in _UV_KEYS:
            w = [(0, 0)] * out[k].ndim
            w[1] = (0, pad)
            out[k] = np.pad(out[k], w)
        out["uv_rotations"][:, n:, 0] = 1.0
        out["uv_scales"][:, n:] = 1e-6
        out["uv_binding_face"] = np.pad(out["uv_binding_face"], (0, pad))
        out["uv_face_bary"] = np.pad(out["uv_face_bary"], ((0, pad), (0, 0)))
        out["uv_valid"] = np.pad(out["uv_valid"], (0, pad))
    return GaussianAvatar(**{k: torch.as_tensor(v, device=device) for k, v in out.items()})
