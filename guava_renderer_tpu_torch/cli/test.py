"""Inference and evaluation entry point (counterpart of `main/test.py`).

    python -m guava_renderer_tpu_torch.cli.test -c <config> -m <model dir>
        --data_path <tracked data> [-s <save dir>] [--max_frames N]
        [--render_cross_act | --render_static_novel_views | --render_dynamic_novel_views]
        [--dp_render [-d N]] [--synthetic_assets] [--device cuda|cpu]

Modes: self-reenactment (default; `cli/inference.py:render_set`),
--render_cross_act, --render_dynamic_novel_views and
--render_static_novel_views. Weights are found as
`cli/context.py:load_model_params` finds them: `-b` (a checkpoint file),
the port's checkpoints under <model dir>/checkpoints (best, then latest),
then <model dir>/converted_params.pt; random weights only with
--allow_random_weights or --synthetic_assets. The run is on the card unless
`--device cpu`.

`-d` picks the devices as `cli/train.py:parse_devices` reads it (default
'0', card 0; a lone number under 8 is that card, a '0,1' list those cards;
with `--device cpu` a number is a count of gloo ranks, the counterpart of
the JAX `--host_devices`). `--dp_render` renders the self-reenactment's
frames data-parallel over them, one rank spawned a device (NCCL on the
cards), and rank 0 writes every file. The other modes, and `--dp_render` on
one device, render on the first.
"""

from __future__ import annotations

import argparse
import os


def test(args):
    from ..parallel.mesh import current_group, launch
    from .train import parse_devices

    devices = parse_devices(args.devices, args.device)
    if args.dp_render and len(devices) > 1 and current_group() is None:
        return launch(len(devices), _test_rank, args, device=args.device, devices=devices)[0]
    return _test(args, None if current_group() else devices[0])


def _test_rank(group, args):
    return _test(args, group.device)


def _test(args, device=None):
    from ..data.tracked import TrackedVideoDataset
    from ..utils.logging_utils import profiler_trace
    from .context import build_runtime, load_model_params, resolve_config
    from .inference import render_cross_set, render_novel_views, render_set

    cfg = resolve_config(args.config_name or args.model_path)
    if args.bf16:
        cfg.set_readonly(False)
        cfg.MODEL.bf16_refiner = True
        cfg.set_readonly(True)
    rt = build_runtime(cfg, synthetic_assets=args.synthetic_assets,
                       device=device or args.device)
    params, source = load_model_params(
        rt, args.model_path, args.basemodel,
        allow_random=args.allow_random_weights or args.synthetic_assets)
    print(f"[test] weights: {source}")

    def make_ds(path):
        return TrackedVideoDataset(
            path, "test",
            image_size=cfg.MODEL.image_size,
            feature_img_size=cfg.MODEL.feature_img_size,
            origin_image_size=cfg.DATASET.origin_image_size,
            test_full=args.non_test_full)

    save_path = args.save_path or os.path.join(args.model_path or ".", "test_results")
    ds = make_ds(args.data_path)
    results = None
    with profiler_trace(args.profile_dir):
        if args.render_cross_act:
            src_ds = make_ds(args.source_data_path or args.data_path)
            render_cross_set(rt, params, src_ds, ds, os.path.join(save_path, "cross"),
                             keep_source_cam=args.keep_source_cam, max_frames=args.max_frames)
        elif args.render_dynamic_novel_views or args.render_static_novel_views:
            for idx in args.render_snovel_idx:
                render_novel_views(rt, params, ds, os.path.join(save_path, f"novel_{idx}"),
                                   static=args.render_static_novel_views, frame_idx=idx)
        elif not args.skip_self_act:
            results = render_set(rt, params, ds, save_path, saving_name=args.saving_name,
                                 max_frames=args.max_frames, dp_frames=args.dp_render,
                                 group_frames=args.group_frames)
            if results:         # rank 0 of a --dp_render run, or the one process
                print(results)
    return results


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config_name", "-c", default=None, type=str)
    parser.add_argument("--devices", "-d", default="0", type=str,
                        help="a card index or a 0,1 list (default card 0); with --device cpu a "
                             "count")
    parser.add_argument("--dp_render", action="store_true",
                        help="render frames data-parallel over -d devices, a rank each "
                             "(one device: sequential)")
    parser.add_argument("--group_frames", type=int, default=0,
                        help="render G frames per call of FramePipeline.render_frames")
    parser.add_argument("--bf16", action="store_true",
                        help="run the neural refiner in bfloat16")
    parser.add_argument("--basemodel", "-b", default=None, type=str,
                        help="explicit checkpoint path to restore")
    parser.add_argument("--data_path", type=str)
    parser.add_argument("--model_path", "-m", type=str)
    parser.add_argument("--save_path", "-s", type=str, default=None)
    parser.add_argument("--saving_name", "-n", type=str, default="render")
    parser.add_argument("--non_test_full", action="store_true", default=False,
                        help="render every frame instead of the testing_split tail")
    parser.add_argument("--skip_self_act", action="store_true", default=False)
    parser.add_argument("--render_dynamic_novel_views", action="store_true", default=False)
    parser.add_argument("--render_static_novel_views", action="store_true", default=False)
    parser.add_argument("--render_snovel_idx", nargs="+", type=int, default=[0])
    parser.add_argument("--render_cross_act", action="store_true", default=False)
    parser.add_argument("--keep_source_cam", action="store_true", default=False)
    parser.add_argument("--source_data_path", type=str, default=None,
                        help="source info for cross_reenactment")
    parser.add_argument("--synthetic_assets", action="store_true")
    parser.add_argument("--allow_random_weights", action="store_true",
                        help="permit inference from random init (debug only)")
    parser.add_argument("--max_frames", default=None, type=int)
    parser.add_argument("--profile_dir", default=None, type=str,
                        help="write a torch.profiler trace of the run here")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser


def main(argv=None):
    return test(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
