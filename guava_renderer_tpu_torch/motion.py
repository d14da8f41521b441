"""External motion ingestion: EMAGE/SMPL-X npz and ARTalk/FLAME sequences
(counterpart of `guava_renderer_tpu/motion.py`; numpy only, the same
arithmetic, so the two give equal arrays).

Covers the reference's render_motion.py motion loading + convert_motion.py /
resample_motion.py utilities (ref: render_motion.py:20-82,232-299,
convert_motion.py, resample_motion.py): axis-angle SMPL-X pose tracks are
split into body/hand/jaw channels, FLAME expression tracks ride alongside,
and fps resampling is linear interpolation over frames.
"""

from __future__ import annotations

import numpy as np

# SMPL-X 165-dof pose layout (55 joints x 3 axis-angle)
_BODY = slice(3, 66)       # joints 1..21
_JAW = slice(66, 69)
_EYES = slice(69, 75)
_LHAND = slice(75, 120)
_RHAND = slice(120, 165)


def load_smplx_motion(path: str) -> dict:
    """EMAGE-style npz: poses (T, 165) axis-angle [+ expressions (T, E),
    trans (T, 3)] -> per-frame channel dict of float32 arrays."""
    data = np.load(path, allow_pickle=True)
    poses = np.asarray(data["poses"], np.float32)
    T = poses.shape[0]
    out = {
        "global_pose": poses[:, 0:3].reshape(T, 1, 3),
        "body_pose": poses[:, _BODY].reshape(T, 21, 3),
        "jaw": poses[:, _JAW].reshape(T, 3),
        "eyes": poses[:, _EYES].reshape(T, 6),
        "left_hand_pose": poses[:, _LHAND].reshape(T, 15, 3),
        "right_hand_pose": poses[:, _RHAND].reshape(T, 15, 3),
    }
    if "expressions" in data:
        out["exp"] = np.asarray(data["expressions"], np.float32)
    if "trans" in data:
        out["trans"] = np.asarray(data["trans"], np.float32)
    if "mocap_frame_rate" in data:
        out["fps"] = float(np.asarray(data["mocap_frame_rate"]).reshape(-1)[0])
    return out


def load_flame_motion(path: str) -> dict:
    """ARTalk-style FLAME track: npy/npz with (T, 53+) rows
    [exp(50) | jaw(3)...] or a dict of named arrays."""
    data = np.load(path, allow_pickle=True)
    if isinstance(data, np.lib.npyio.NpzFile):
        out = {k: np.asarray(data[k], np.float32) for k in data.files}
        if "expression_params" in out:
            out["exp"] = out.pop("expression_params")
        if "jaw_params" in out:
            out["jaw"] = out.pop("jaw_params")
        return out
    arr = np.asarray(data, np.float32)
    if arr.ndim == 2 and arr.shape[1] >= 53:
        return {"exp": arr[:, :50], "jaw": arr[:, 50:53]}
    raise ValueError(f"unrecognized flame motion layout {arr.shape}")


def resample_motion(motion: dict, src_fps: float, dst_fps: float) -> dict:
    """Linear-interp fps conversion (ref: resample_motion.py, 25<->30 fps)."""
    if src_fps == dst_fps:
        return motion
    out = {}
    for k, v in motion.items():
        if not isinstance(v, np.ndarray) or v.ndim < 1 or k == "fps":
            out[k] = v
            continue
        T = v.shape[0]
        duration = (T - 1) / src_fps
        n_out = int(np.floor(duration * dst_fps)) + 1
        t_out = np.arange(n_out) / dst_fps * src_fps  # source frame positions
        lo = np.clip(np.floor(t_out).astype(int), 0, T - 1)
        hi = np.clip(lo + 1, 0, T - 1)
        w = (t_out - lo).reshape((-1,) + (1,) * (v.ndim - 1)).astype(np.float32)
        out[k] = (1 - w) * v[lo] + w * v[hi]
    out["fps"] = dst_fps
    return out


def motion_frame_params(
    smplx_motion: dict,
    flame_motion: dict | None,
    frame: int,
    identity: dict | None = None,
    n_shape: int = 50,
    n_exp: int = 20,
    hand_pose_scale: float = 1.0,
    keep_global: bool = False,
) -> dict:
    """Per-frame batch['params'] dict for the deformer.

    Mirrors render_motion.py:232-299: EHM ignores global translation by
    design (renders in a canonical frame with camera motion instead);
    `keep_global` forwards the track's global rotation when wanted.
    `hand_pose_scale` reproduces the hand-motion scaling flags (:236-258).
    """
    t = min(frame, smplx_motion["body_pose"].shape[0] - 1)
    params = {
        "shape": np.zeros((1, n_shape), np.float32),
        "body_pose": smplx_motion["body_pose"][t : t + 1],
        "left_hand_pose": smplx_motion["left_hand_pose"][t : t + 1] * hand_pose_scale,
        "right_hand_pose": smplx_motion["right_hand_pose"][t : t + 1] * hand_pose_scale,
        "flame_shape": np.zeros((1, n_shape), np.float32),
        "flame_exp": np.zeros((1, n_exp), np.float32),
        "flame_jaw": smplx_motion["jaw"][t : t + 1],
        "flame_eyes": smplx_motion["eyes"][t : t + 1],
    }
    if keep_global and "global_pose" in smplx_motion:
        params["global_pose"] = smplx_motion["global_pose"][t : t + 1]
    if flame_motion is not None:
        tf = min(frame, flame_motion["exp"].shape[0] - 1)
        e = flame_motion["exp"][tf : tf + 1]
        params["flame_exp"] = e[:, :n_exp].astype(np.float32)
        if "jaw" in flame_motion:
            params["flame_jaw"] = flame_motion["jaw"][tf : tf + 1].astype(np.float32)
    if identity:
        for k in ("shape", "joints_offset", "head_scale", "hand_scale", "flame_shape"):
            if k in identity:
                params[k] = np.asarray(identity[k], np.float32)[None]
    return params
