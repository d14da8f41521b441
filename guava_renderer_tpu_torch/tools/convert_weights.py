"""Pretrained backbone weights -> the port's state dicts.

    python -m guava_renderer_tpu_torch.tools.convert_weights \
        --dinov2 dinov2_vitb14_pretrain.pth --out assets/pretrained/dinov2_vitb14.pt
    python -m guava_renderer_tpu_torch.tools.convert_weights \
        --lpips alex.pth --net_type alex --out assets/pretrained/lpips_alex.pt

The reference pulls DINOv2 ViT-B/14 from torch.hub and LPIPS from its
package; where those files exist, this tool renames their entries onto the
port's modules (`train/weights.py:dinov2_state_dict`,
`train/lpips.py:lpips_state_dict`), loads the result into the module to
check every name and shape, and writes it with `torch.save`.
`cli/context.py:load_pretrained_backbones` reads the two files from
MODEL.pretrained_dir.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--dinov2", type=str, default=None)
    src.add_argument("--lpips", type=str, default=None)
    ap.add_argument("--net_type", type=str, default="alex", choices=["alex", "vgg"])
    ap.add_argument("--out", type=str, required=True)
    args = ap.parse_args(argv)

    from ..train.weights import save_converted_params

    if args.dinov2:
        from ..models.vit import VisionTransformer
        from ..train.weights import dinov2_state_dict

        state = torch.load(args.dinov2, map_location="cpu", weights_only=True)
        sd = dinov2_state_dict(state)
        dim = sd["patch_embed.weight"].shape[0]
        depth = 1 + max(int(k.split(".")[0][5:]) for k in sd if k.startswith("block"))
        grid = round((sd["pos_embed"].shape[1] - 1) ** 0.5)
        # heads do not change a shape; ViT-B/14 has 12 of 64 channels
        vit = VisionTransformer(dim=dim, depth=depth, num_heads=max(1, dim // 64), pos_grid=grid)
        vit.load_state_dict(sd)
        print(f"dinov2: {len(sd)} tensors onto a ViT of width {dim}, depth {depth}")
    else:
        from ..train.lpips import LPIPS, lpips_state_dict

        state = torch.load(args.lpips, map_location="cpu", weights_only=True)
        sd = lpips_state_dict(state)
        LPIPS(args.net_type).load_state_dict(sd)
        print(f"lpips ({args.net_type}): {len(sd)} tensors")
    save_converted_params(args.out, sd)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
