"""Convert external motion files (EMAGE SMPL-X npz, ARTalk FLAME tracks) into
the framework's motion npz (counterpart of `convert_motion.py`; numpy only,
the same keys and arrays).

    python -m guava_renderer_tpu_torch.cli.convert_motion --smplx_motion <npz>
        [--flame_motion <npy|npz>] -o <out.npz> [--src_fps F] [--dst_fps 30]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..motion import load_flame_motion, load_smplx_motion, resample_motion


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--smplx_motion", type=str, default=None)
    parser.add_argument("--flame_motion", type=str, default=None)
    parser.add_argument("--output", "-o", type=str, required=True)
    parser.add_argument("--src_fps", type=float, default=None)
    parser.add_argument("--dst_fps", type=float, default=30.0)
    args = parser.parse_args(argv)

    out = {}
    if args.smplx_motion:
        m = load_smplx_motion(args.smplx_motion)
        fps = args.src_fps or m.get("fps", args.dst_fps)
        m = resample_motion(m, fps, args.dst_fps)
        out.update({f"smplx/{k}": v for k, v in m.items() if isinstance(v, np.ndarray)})
    if args.flame_motion:
        f = load_flame_motion(args.flame_motion)
        if args.src_fps:
            f = resample_motion(f, args.src_fps, args.dst_fps)
        out.update({f"flame/{k}": v for k, v in f.items() if isinstance(v, np.ndarray)})
    out["fps"] = np.asarray(args.dst_fps)
    np.savez(args.output, **out)
    print(f"wrote {args.output}: " + ", ".join(f"{k}{v.shape}" for k, v in out.items()))
    return args.output


if __name__ == "__main__":
    main()
