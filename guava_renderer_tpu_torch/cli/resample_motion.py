"""Resample a motion npz between frame rates (counterpart of
`resample_motion.py`; linear interpolation, e.g. 25 <-> 30 fps, numpy only).

    python -m guava_renderer_tpu_torch.cli.resample_motion -i <in.npz> -o <out.npz>
        --src_fps 25 --dst_fps 30
"""

from __future__ import annotations

import argparse

import numpy as np

from ..motion import resample_motion


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--input", "-i", type=str, required=True)
    parser.add_argument("--output", "-o", type=str, required=True)
    parser.add_argument("--src_fps", type=float, required=True)
    parser.add_argument("--dst_fps", type=float, required=True)
    args = parser.parse_args(argv)

    data = np.load(args.input, allow_pickle=True)
    motion = {k: np.asarray(data[k]) for k in data.files}
    out = resample_motion(motion, args.src_fps, args.dst_fps)
    np.savez(args.output, **{k: v for k, v in out.items() if isinstance(v, np.ndarray)})
    print(f"resampled {args.src_fps} -> {args.dst_fps} fps: {args.output}")
    return args.output


if __name__ == "__main__":
    main()
