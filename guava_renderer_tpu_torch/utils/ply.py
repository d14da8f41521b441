"""PLY export for Gaussian sets (the port's own copy of
`guava_renderer_tpu/utils/ply.py`; numpy only): a colored point cloud and
the 3DGS-standard attribute PLY (RGB -> SH DC via (c - 0.5) / C0) that
standard Gaussian-splatting viewers read. Callers pass numpy arrays
(`tensor.cpu().numpy()`).
"""

from __future__ import annotations

import numpy as np

SH_C0 = 0.28209479177387814


def save_point_ply(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None) -> None:
    """Binary little-endian PLY point cloud. xyz (P, 3); rgb (P, 3) in [0, 1]."""
    xyz = np.asarray(xyz, np.float32)
    P = xyz.shape[0]
    props = ["property float x", "property float y", "property float z"]
    cols = None
    if rgb is not None:
        cols = np.clip(np.asarray(rgb) * 255.0, 0, 255).astype(np.uint8)
        props += ["property uchar red", "property uchar green", "property uchar blue"]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {P}\n" + "\n".join(props) + "\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if cols is None:
            f.write(xyz.tobytes())
        else:
            dt = np.dtype(
                [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                 ("r", "u1"), ("g", "u1"), ("b", "u1")]
            )
            rec = np.empty(P, dt)
            rec["x"], rec["y"], rec["z"] = xyz.T
            rec["r"], rec["g"], rec["b"] = cols.T
            f.write(rec.tobytes())


def save_gaussian_ply(
    path: str,
    xyz: np.ndarray,
    rgb: np.ndarray,
    opacity: np.ndarray,
    scales: np.ndarray,
    rotations: np.ndarray,
) -> None:
    """3DGS-standard PLY: positions, normals(0), SH DC, opacity logit,
    log scales, wxyz quaternion — loadable by standard splat viewers."""
    xyz = np.asarray(xyz, np.float32)
    P = xyz.shape[0]
    dc = (np.asarray(rgb, np.float32) - 0.5) / SH_C0
    op = np.asarray(opacity, np.float32).reshape(P, 1)
    op = np.log(np.clip(op, 1e-7, 1 - 1e-7) / (1 - np.clip(op, 1e-7, 1 - 1e-7)))
    log_s = np.log(np.maximum(np.asarray(scales, np.float32), 1e-9))
    rot = np.asarray(rotations, np.float32)

    names = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {P}\n"
        + "\n".join(f"property float {n}" for n in names)
        + "\nend_header\n"
    )
    data = np.concatenate(
        [xyz, np.zeros((P, 3), np.float32), dc, op, log_s, rot], axis=1
    ).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(data.tobytes())


def load_gaussian_ply(path: str) -> dict:
    """Minimal reader for round-trip tests."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode().splitlines()
        count = int(next(l for l in lines if l.startswith("element")).split()[-1])
        names = [l.split()[-1] for l in lines if l.startswith("property")]
        data = np.frombuffer(f.read(), "<f4").reshape(count, len(names))
    return {n: data[:, i] for i, n in enumerate(names)}
