"""A seeded motion sequence for a body-model avatar: a smooth random walk of
the body pose, the FLAME expression and the jaw, with a static camera.

Each channel is an Ornstein-Uhlenbeck walk x[t] = r x[t-1] + sqrt(1 - r^2)
sd e[t] (r the traffic's `persistence`, stationary with standard deviation
`sd`, starting at 0, the rest pose), then a moving average over `smoothing`
frames. The walk is drawn from the traffic's own `motion_seed`, so every
run renders the same set of poses, whose work differs from pose to pose;
the run's seed picks the frame the loop starts at, so two seeds send that
set in another order.
"""

from __future__ import annotations

import numpy as np


def _walk(rng, frames, shape, sd, persistence, smoothing):
    e = rng.standard_normal((frames + smoothing - 1, *shape))
    x = np.zeros_like(e)
    k = np.sqrt(1.0 - persistence ** 2) * sd
    for t in range(1, e.shape[0]):
        x[t] = persistence * x[t - 1] + k * e[t]
    kernel = np.ones(smoothing) / smoothing
    return np.apply_along_axis(lambda c: np.convolve(c, kernel, mode="valid"), 0, x)


def generate(traffic: dict, seed: int, n_shape: int, n_exp: int) -> list[dict]:
    """-> `traffic["frames"]` target records {"params": {key: unbatched float32
    array}, "w2c": (4, 4) float32}, as `FramePipeline.render_frame` takes them,
    starting at frame `seed` mod the frames."""
    rng = np.random.default_rng(int(traffic["motion_seed"]))
    n, r, m = int(traffic["frames"]), float(traffic["persistence"]), int(traffic["smoothing"])
    body = _walk(rng, n, (21, 3), float(traffic["body_pose_sd"]), r, m)
    exp = _walk(rng, n, (n_exp,), float(traffic["expression_sd"]), r, m)
    jaw = _walk(rng, n, (3,), float(traffic["jaw_sd"]), r, m)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = float(traffic["camera_z"])
    zeros = np.zeros(n_shape, np.float32)
    return [{"params": {"shape": zeros, "body_pose": body[t].astype(np.float32),
                        "flame_shape": zeros, "flame_exp": exp[t].astype(np.float32),
                        "flame_jaw": jaw[t].astype(np.float32)},
             "w2c": w2c} for t in np.roll(np.arange(n), -(int(seed) % n))]
