"""Offline metrics entry point (counterpart of `main/metrics.py`).

    python -m guava_renderer_tpu_torch.cli.metrics -m <results dir> [...]
        [--pretrained_dir assets/pretrained] [--device cuda|cpu]

Walks each results directory's scenes (render/ and gt/ PNG dumps of
`cli/test.py`), computes PSNR, SSIM, LPIPS and MAE per view, and writes
per_view.json and results.json per scene and an aggregate results.json
(`train/metrics.py:evaluate_tree`).

LPIPS is the VGG variant, as the reference reports it. Its weights come
from `<pretrained_dir>/lpips_vgg.pt`, the file `python -m
guava_renderer_tpu_torch.tools.convert_weights --net_type vgg` writes;
without it the LPIPS column is skipped (a random backbone's numbers would
mean nothing). LPIPS runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os


def build_lpips(pretrained_dir: str, device="cuda"):
    """LPIPS-vgg from the converted file as fn(render, gt) -> float, or None."""
    import torch

    from ..device import resolve_device
    from ..train.lpips import LPIPS, load_torch_state

    dev = resolve_device(device)
    path = os.path.join(pretrained_dir, "lpips_vgg.pt")
    if not os.path.isfile(path):
        print(f"[metrics] no converted LPIPS-vgg at {path} — skipping LPIPS")
        return None
    m = LPIPS("vgg")
    load_torch_state(m, torch.load(path, map_location="cpu", weights_only=True))
    m = m.to(dev).eval()
    print(f"[metrics] LPIPS-vgg loaded from {path}")

    @torch.no_grad()
    def fn(a, b):
        return float(m(a.to(dev), b.to(dev)))

    return fn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Offline render metrics")
    ap.add_argument("--model_paths", "-m", required=True, nargs="+", type=str)
    ap.add_argument("--pretrained_dir", default="assets/pretrained")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from ..train.metrics import evaluate_tree

    lpips_fn = build_lpips(args.pretrained_dir, args.device)
    outs = {}
    for root in args.model_paths:
        out = outs[root] = evaluate_tree(root, lpips_fn=lpips_fn)
        print(f"--- {root} ---")
        print(json.dumps(out["aggregate"], indent=2))
    return outs


if __name__ == "__main__":
    main()
