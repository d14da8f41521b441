"""The released GUAVA checkpoint (best_*.pt) -> the port's weights.

    python -m guava_renderer_tpu_torch.tools.convert_guava_checkpoint -m assets/GUAVA \
        [--ckpt path/to/best_160000.pt] [--out .../converted_params.pt]

Discovery follows the reference's find_pt_file (best* before latest*,
ref: utils/general_utils.py:310-314). The checkpoint holds {'model':
inferer state_dict, 'render_model': renderer state_dict, 'meta_cfg',
'global_iter'}; the sizes come from <model_path>/config.yaml when it
exists. The mapping is `train/weights.py:guava_state_dict`; the output is
`torch.save` of the port's {"inferer", "renderer"} state dict, which
`cli/context.py:load_model_params` finds as <model_path>/converted_params.pt.
"""

from __future__ import annotations

import argparse
import glob
import os


def find_pt_file(model_dir: str) -> str | None:
    """best_* preferred, then latest* (ref: utils/general_utils.py:310-314)."""
    for pat in ("best_*.pt", "best*.pt", "latest*.pt", "*.pt"):
        hits = sorted(glob.glob(os.path.join(model_dir, pat)))
        if hits:
            return hits[-1]
    return None


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model_path", "-m", type=str, required=True,
                    help="dir holding best_*.pt + config.yaml (e.g. assets/GUAVA)")
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    import torch

    from ..train.weights import guava_state_dict, save_converted_params
    from ..utils.config import load_config

    ckpt_path = args.ckpt or find_pt_file(args.model_path)
    if not ckpt_path or not os.path.isfile(ckpt_path):
        raise SystemExit(f"no .pt checkpoint found under {args.model_path}")

    print(f"loading {ckpt_path} ...")
    # the released file pickles its config beside the tensors
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    model_sd = {k: v.numpy() for k, v in ckpt["model"].items()}
    render_sd = {k: v.numpy() for k, v in ckpt["render_model"].items()}
    print(f"  model: {len(model_sd)} tensors; render_model: {len(render_sd)} "
          f"tensors; global_iter={ckpt.get('global_iter')}")

    cfg_path = os.path.join(args.model_path, "config.yaml")
    uv, size, num_mlp, cs = 512, 512, 8, 1.0
    if os.path.isfile(cfg_path):
        m = load_config(cfg_path).MODEL
        uv, size = int(m.uvmap_size), int(m.image_size)
        st = m.get("styleunet", None)
        if st:
            num_mlp = int(st.get("num_mlp", 8))
            cs = float(st.get("channel_scale", 1))

    sd = guava_state_dict(model_sd, render_sd, uvmap_size=uv, image_size=size,
                          num_mlp=num_mlp, channel_scale=cs)
    out = args.out or os.path.join(args.model_path, "converted_params.pt")
    save_converted_params(out, sd)
    print(f"wrote {out} ({len(sd)} tensors)")
    return out


if __name__ == "__main__":
    main()
