"""Single-image avatar creation (counterpart of `create_avatar.py`).

    python -m guava_renderer_tpu_torch.cli.create_avatar -m <model dir or config>
        --data_path <tracked data> [--source_video_id ID] --output_avatar_path <file>
        [--synthetic_assets] [--device cuda|cpu]

Config and weights -> a warm-up creation, then the timed one (printed as
`avatar inference: X ms`) -> the pruned avatar written by
`train/checkpoints.py:save_avatar` (one torch.save file, where the JAX
package writes an orbax directory), and `<stem>.ply` of its canonical
Gaussians. The run is on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os


def create_avatar(args):
    from ..data.tracked import TrackedVideoDataset
    from ..train.checkpoints import save_avatar
    from ..utils.logging_utils import SpeedMeter
    from .context import build_runtime, load_model_params, resolve_config
    from .inference import _export_ply, _pipeline, _timed_creation

    cfg = resolve_config(args.model_path)
    rt = build_runtime(cfg, synthetic_assets=args.synthetic_assets, device=args.device)
    params, source = load_model_params(
        rt, args.model_path, allow_random=args.allow_random_weights or args.synthetic_assets)
    print(f"[create_avatar] weights: {source}")

    ds = TrackedVideoDataset(
        args.data_path, "test",
        image_size=cfg.MODEL.image_size,
        feature_img_size=cfg.MODEL.feature_img_size,
        origin_image_size=cfg.DATASET.origin_image_size)
    idx = 0
    if args.source_video_id:
        idx = next((i for i, key in enumerate(ds.frames)
                    if key.startswith(args.source_video_id)), 0)
    rec = ds[idx]

    # warm-up, then timed (the "sub-second" claim's measurement)
    pipe = _pipeline(rt, params)
    speed = SpeedMeter(pipe.device)
    avatar = _timed_creation(pipe, speed, rec["source"])
    print(f"avatar inference: {speed.infer_time_ms:.1f} ms")

    save_avatar(args.output_avatar_path, avatar)
    _export_ply(os.path.splitext(args.output_avatar_path)[0] + ".ply", avatar, pipe.faces)
    print(f"saved avatar to {args.output_avatar_path}")
    return avatar


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model_path", "-m", type=str, default="assets/GUAVA")
    parser.add_argument("--data_path", type=str,
                        default="assets/example/tracked_video/6gvP8f5WQyo__056")
    parser.add_argument("--source_video_id", type=str, default="6gvP8f5WQyo__056")
    parser.add_argument("--output_avatar_path", type=str, default="my_avatar")
    parser.add_argument("--allow_random_weights", action="store_true")
    parser.add_argument("--synthetic_assets", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return create_avatar(parser.parse_args(argv))


if __name__ == "__main__":
    main()
