"""Training entry point (counterpart of `main/train.py`).

    python -m guava_renderer_tpu_torch.cli.train -c <config> [-d auto|N|0,1,..]
        [--basemodel CKPT] [--debug] [--synthetic_assets] [--max_iters N]
        [--profile_dir DIR] [--device cuda|cpu]

`-c` is a config name (configs/train/<name>.yaml), a yaml path or a run
directory holding config.yaml. The run goes to
`$GUAVA_OUTPUT_DIR/<TRAIN.exp_str>` (GUAVA_OUTPUT_DIR defaults to
`outputs`). `--basemodel` is a checkpoint of this package to start from;
`--profile_dir` traces one iteration with torch.profiler. The run is on the
card unless `--device cpu`.

`-d`/`--devices` picks the devices to train on, data-parallel, as
`main/train.py` reads it on the card: 'auto' every visible card, the
reference's '0,1' list those cards, a lone number under 8 that one card (a
device index), a larger number that many cards. The CPU has no device
indices, so with `--device cpu` a lone number, or a list's length, is how
many gloo ranks train (the counterpart of the JAX `--host_devices`), and
'auto' is one. With more than one device, one rank is spawned a device
(NCCL on the cards, gloo on the CPU).
"""

from __future__ import annotations

import argparse
import os


def parse_devices(spec: str, device: str = "cuda") -> list:
    """-d -> the devices, one rank each (see the module's docstring)."""
    import torch

    cpu = torch.device(device).type == "cpu"
    if spec in ("auto", "") or not any(c.isdigit() for c in spec):
        return [torch.device("cpu")] if cpu else [
            torch.device("cuda", i) for i in range(max(1, torch.cuda.device_count()))]
    if "," in spec:
        ids = [int(s) for s in spec.split(",") if s != ""]
    elif cpu:
        ids = range(max(1, int(spec)))
    else:       # a bare index like '3' is that one card (reference semantics)
        ids = [int(spec)] if int(spec) < 8 else range(int(spec))
    return [torch.device("cpu") if cpu else torch.device("cuda", i) for i in ids]


def train(config_name: str, basemodel: str | None = None, debug: bool = False,
          synthetic_assets: bool = False, max_iters: int | None = None,
          profile_dir: str | None = None, device: str = "cuda", devices: list | None = None):
    """-> the train state; over several `devices` (`parse_devices`), rank 0's
    state dict. With one, the run is on it; with none, on `device`."""
    from .context import build_runtime, resolve_config
    from .trainer_loop import run_training
    from ..data.tracked import build_dataset
    from ..parallel.mesh import current_group, launch

    group = current_group()
    if group is None and devices and len(devices) > 1:
        return launch(len(devices), _train_rank, config_name, basemodel, debug,
                      synthetic_assets, max_iters, profile_dir, device=device,
                      devices=devices)[0]
    if group is not None:
        device = group.device
    elif devices:
        device = devices[0]
    cfg = resolve_config(config_name)
    rt = build_runtime(cfg, synthetic_assets=synthetic_assets, device=device)
    train_ds = build_dataset(cfg, "train")
    valid_ds = build_dataset(cfg, "valid")
    run_dir = os.path.join(os.environ.get("GUAVA_OUTPUT_DIR", "outputs"), cfg.TRAIN.exp_str)
    return run_training(rt, train_ds, valid_ds, run_dir, basemodel=basemodel, debug=debug,
                        max_iters=max_iters, profile_dir=profile_dir,
                        n_devices=None if group is None else group.size)


def _train_rank(group, *args):
    state = train(*args)
    return state.state_dict() if group.rank == 0 else None


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config_name", "-c", required=True, type=str)
    parser.add_argument("--devices", "-d", default="auto", type=str,
                        help="data-parallel devices: auto, a card index, a count from 8, or a 0,1 list; "
                             "with --device cpu a count")
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
                 args.max_iters, args.profile_dir, args.device,
                 parse_devices(args.devices, args.device))


if __name__ == "__main__":
    main()
