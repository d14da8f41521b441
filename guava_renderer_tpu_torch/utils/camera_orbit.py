"""Novel-view orbit camera sampling in numpy (counterpart of
`guava_renderer_tpu/utils/camera_orbit.py`, the same arithmetic).

Parity with the reference's LookAtPoseSampler / generate_novel_view_poses
(ref: utils/camera_utils.py:33-97): spherical camera origins orbiting a
look-at point (default [0, 0.75, 0]) with sinusoidal yaw/pitch sweeps
(yaw range 0.35, pitch range 0.3) at the source camera's radius.
"""

from __future__ import annotations

import numpy as np


def _normalize(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-8)


def look_at_w2c(horizontal: float, vertical: float, lookat: np.ndarray, radius: float) -> np.ndarray:
    """Single w2c (4, 4) per the reference sampler's math."""
    theta = horizontal
    v = np.clip(vertical, 1e-5, np.pi - 1e-5) / np.pi
    phi = np.arccos(1 - 2 * v)
    origin = np.array(
        [
            radius * np.sin(phi) * np.cos(np.pi - theta),
            radius * np.cos(phi),
            radius * np.sin(phi) * np.sin(np.pi - theta),
        ],
        np.float32,
    )
    forward = _normalize(lookat - origin)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    right = -_normalize(np.cross(up, forward))
    cam_up = _normalize(np.cross(forward, right))
    c2w = np.eye(4, dtype=np.float32)
    # columns: right, up, forward (ref create_cam2world_matrix, camera_utils.py:12-31)
    c2w[:3, 0] = right
    c2w[:3, 1] = cam_up
    c2w[:3, 2] = forward
    c2w[:3, 3] = origin
    # exact transcription of the reference: w2c = inv(c2w) @ diag(1,-1,-1,1)
    # (camera_utils.py:61-64)
    w2c = np.linalg.inv(c2w)
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    return (w2c @ flip).astype(np.float32)


def generate_novel_view_poses(
    source_c2w: np.ndarray,
    num_keyframes: int = 120,
    pitch_range: float = 0.3,
    yaw_range: float = 0.35,
    lookat=(0.0, 0.75, 0.0),
) -> list[np.ndarray]:
    """List of w2c (4, 4) matrices orbiting at the source camera radius."""
    radius = float(np.linalg.norm(source_c2w[:3, 3]))
    lookat = np.asarray(lookat, np.float32)
    out = []
    for i in range(num_keyframes):
        h = np.pi / 2 + yaw_range * np.sin(2 * np.pi * i / num_keyframes)
        v = np.pi / 2 - 0.05 + pitch_range * np.cos(2 * np.pi * i / num_keyframes)
        out.append(look_at_w2c(h, v, lookat, radius))
    return out
