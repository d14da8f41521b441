"""Training entry point (counterpart of `main/train.py`).

    python -m guava_renderer_tpu_torch.cli.train -c <config> [--basemodel CKPT] [--debug]
        [--synthetic_assets] [--max_iters N] [--profile_dir DIR] [--device cuda|cpu]

`-c` is a config name (configs/train/<name>.yaml), a yaml path or a run
directory holding config.yaml. The run goes to
`$GUAVA_OUTPUT_DIR/<TRAIN.exp_str>` (GUAVA_OUTPUT_DIR defaults to
`outputs`). `--basemodel` is a checkpoint of this package to start from;
`--profile_dir` traces one iteration with torch.profiler. The run is on the
card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os


def train(config_name: str, basemodel: str | None = None, debug: bool = False,
          synthetic_assets: bool = False, max_iters: int | None = None,
          profile_dir: str | None = None, device: str = "cuda"):
    from .context import build_runtime, resolve_config
    from .trainer_loop import run_training
    from ..data.tracked import build_dataset

    cfg = resolve_config(config_name)
    rt = build_runtime(cfg, synthetic_assets=synthetic_assets, device=device)
    train_ds = build_dataset(cfg, "train")
    valid_ds = build_dataset(cfg, "valid")
    run_dir = os.path.join(os.environ.get("GUAVA_OUTPUT_DIR", "outputs"), cfg.TRAIN.exp_str)
    return run_training(rt, train_ds, valid_ds, run_dir, basemodel=basemodel, debug=debug,
                        max_iters=max_iters, profile_dir=profile_dir)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config_name", "-c", required=True, type=str)
    parser.add_argument("--basemodel", default=None, type=str)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--synthetic_assets", action="store_true")
    parser.add_argument("--max_iters", default=None, type=int)
    parser.add_argument("--profile_dir", default=None, type=str,
                        help="write a torch.profiler trace of one steady-state iteration here")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    print(f"Command Line Args: {args}", flush=True)
    return train(args.config_name, args.basemodel, args.debug, args.synthetic_assets,
                 args.max_iters, args.profile_dir, args.device)


if __name__ == "__main__":
    main()
