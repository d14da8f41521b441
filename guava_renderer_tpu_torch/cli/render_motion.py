"""Render a saved avatar with external motion (counterpart of
`render_motion.py`).

    python -m guava_renderer_tpu_torch.cli.render_motion -a <avatar file>
        -m <model dir or config> --smplx_motion <npz> [--flame_motion <npy|npz>]
        [--image_size 512] [--fps 30] [--max_frames N] [-o out.mp4]
        [--synthetic_assets] [--device cuda|cpu]

A saved avatar (`cli/create_avatar.py`) and the model's weights, an
EMAGE-style SMPL-X npz and optionally an ARTalk FLAME track, resampled to
--fps, rendered from a fixed look-at camera into an MP4
(`utils/video.py`). --image_size rasterizes at that size while the refiner
runs at its trained size (`MODEL.styleunet.out_size`, through the
renderer's `refiner_size`); a size the raster tile does not divide is
refused by the blend. With --audio the track is muxed by `ffmpeg` when it is
on PATH, and skipped with a message when it is not. The run is on the card
unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import subprocess


def render_motion(args):
    import numpy as np

    from ..motion import load_flame_motion, load_smplx_motion, motion_frame_params, resample_motion
    from ..train.checkpoints import load_avatar
    from ..utils.camera_orbit import look_at_w2c
    from .context import build_runtime, load_model_params, resolve_config
    from .inference import _pipeline, _write_video

    cfg = resolve_config(args.model_path)
    if int(args.image_size) != int(cfg.MODEL.image_size) or args.bf16:
        cfg.set_readonly(False)
        cfg.MODEL.image_size = int(args.image_size)
        if args.bf16:
            cfg.MODEL.bf16_refiner = True
        cfg.set_readonly(True)
    rt = build_runtime(cfg, synthetic_assets=args.synthetic_assets, device=args.device)
    params, source = load_model_params(
        rt, args.model_path, allow_random=args.allow_random_weights or args.synthetic_assets)
    print(f"[render_motion] weights: {source}")

    smplx_motion = load_smplx_motion(args.smplx_motion) if args.smplx_motion else None
    flame_motion = load_flame_motion(args.flame_motion) if args.flame_motion else None
    if smplx_motion is None:
        raise SystemExit("--smplx_motion is required")
    src_fps = smplx_motion.get("fps", args.src_fps)
    if src_fps != args.fps:
        smplx_motion = resample_motion(smplx_motion, src_fps, args.fps)

    w2c = look_at_w2c(np.pi / 2, np.pi / 2 - 0.05, np.asarray([0.0, 0.75, 0.0]),
                      radius=args.cam_radius)

    pipe = _pipeline(rt, params)
    # the saved avatar is pruned already; this re-plans it for the planned gather
    avatar = pipe.prepare_avatar(load_avatar(args.avatar_path, pipe.device))
    n = smplx_motion["body_pose"].shape[0]
    if args.max_frames:
        n = min(n, args.max_frames)
    frames = []
    for t in range(n):
        p = motion_frame_params(smplx_motion, flame_motion, t, n_shape=rt.smplx.n_shape,
                                n_exp=rt.smplx.n_exp, hand_pose_scale=args.hand_pose_scale)
        # motion_frame_params returns batched (1, ...) arrays; the pipeline batches records
        p = {k: np.asarray(v)[0] for k, v in p.items()}
        out = pipe.render_frame(avatar, {"params": p, "w2c": w2c})
        frames.append(out["render"].cpu().numpy())
    out_path = args.output or "motion_render.mp4"
    _write_video(out_path, frames, fps=int(args.fps))
    print(f"wrote {len(frames)} frames to {out_path} at {args.image_size}px")

    if args.audio and os.path.exists(args.audio):
        muxed = os.path.splitext(out_path)[0] + "_audio.mp4"
        try:
            subprocess.run(
                ["ffmpeg", "-y", "-i", out_path, "-i", args.audio,
                 "-c:v", "copy", "-c:a", "aac", "-shortest", muxed],
                check=True, capture_output=True)
            print(f"audio muxed -> {muxed}")
        except (FileNotFoundError, subprocess.CalledProcessError) as e:
            print(f"audio mux skipped ({e})")
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--avatar_path", "-a", type=str, required=True)
    parser.add_argument("--model_path", "-m", type=str, default="assets/GUAVA")
    parser.add_argument("--smplx_motion", type=str, default=None,
                        help="EMAGE-style npz with poses (T,165)")
    parser.add_argument("--flame_motion", type=str, default=None,
                        help="ARTalk-style FLAME exp/jaw track")
    parser.add_argument("--audio", type=str, default=None)
    parser.add_argument("--output", "-o", type=str, default=None)
    parser.add_argument("--fps", type=float, default=30.0)
    parser.add_argument("--src_fps", type=float, default=30.0)
    parser.add_argument("--cam_radius", type=float, default=5.0)
    parser.add_argument("--hand_pose_scale", type=float, default=1.0)
    parser.add_argument("--image_size", type=int, default=512,
                        help="output resolution (rasterized natively; the refiner runs at "
                             "its trained size)")
    parser.add_argument("--no_refiner", action="store_true",
                        help="kept for CLI parity (the reference flag is a no-op)")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--bf16", action="store_true",
                        help="run the neural refiner in bfloat16")
    parser.add_argument("--allow_random_weights", action="store_true")
    parser.add_argument("--synthetic_assets", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return render_motion(parser.parse_args(argv))


if __name__ == "__main__":
    main()
