"""A tracked-video training store, written once a checkout by the frozen copy
of the port's dataset writer (`data/synthetic.py:write_synthetic_dataset`
with its JPEG and PNG encoders) from the traffic's own `store_seed`.

The store lands in `build/perfbench/data/<digest of the traffic>/` of the
checkout, written under a temporary name and renamed when whole, so a run
cut short leaves nothing that a later run would take. The run's seed does
not change the store: it draws the loader's sample order.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
KEYS = ("store_seed", "videos", "frames_per_video", "image_size", "n_shape", "n_exp")


def store_dir(traffic: dict) -> Path:
    spec = json.dumps({k: traffic[k] for k in KEYS}, sort_keys=True).encode()
    return ROOT / "build" / "perfbench" / "data" / hashlib.sha256(spec).hexdigest()[:16]


def generate(traffic: dict, seed: int = 0) -> str:
    """-> the store's directory, written first if this checkout lacks it."""
    from perfbench.reference.frozen.data.synthetic import write_synthetic_dataset

    out = store_dir(traffic)
    if not out.is_dir():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=".partial-", dir=out.parent)
        try:
            write_synthetic_dataset(
                tmp, n_videos=int(traffic["videos"]), n_frames=int(traffic["frames_per_video"]),
                image_size=int(traffic["image_size"]), n_shape=int(traffic["n_shape"]),
                n_exp=int(traffic["n_exp"]), seed=int(traffic["store_seed"]))
            os.replace(tmp, out)
        except OSError:
            if out.is_dir():            # another run renamed its copy first
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                raise
        finally:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
    return str(out)
