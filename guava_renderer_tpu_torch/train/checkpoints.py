"""Checkpoints with best/latest semantics (counterpart of
`guava_renderer_tpu/train/checkpoints.py`).

`latest` at every check interval, `best_{iter}_{ssim:.4f}` keyed on the
validation SSIM with the old best deleted, named snapshots, and a resume
that restores the iteration. Files are `torch.save` of the train state's
`state_dict()` under `<run_dir>/checkpoints/<name>.pt`; the format is this
package's own.

`save_avatar` / `load_avatar` keep a created avatar (the counterpart of the
JAX `save_pytree` / `load_pytree`, which write an orbax directory): one
`torch.save` file of the avatar's fields as CPU tensors, read back with
`weights_only=True`.
"""

from __future__ import annotations

import os
import re

import torch

from ..avatar.state import GaussianAvatar

_SUFFIX = ".pt"


class CheckpointManager:
    def __init__(self, run_dir: str):
        self.dir = os.path.abspath(os.path.join(run_dir, "checkpoints"))
        os.makedirs(self.dir, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save_latest(self, state, iteration: int) -> str:
        return self._save("latest", state, iteration)

    def save_named(self, name: str, state, iteration: int) -> str:
        return self._save(name, state, iteration)

    def save_best(self, state, iteration: int, ssim: float) -> str:
        for old in self._list("best_"):
            os.remove(os.path.join(self.dir, old))
        return self._save(f"best_{iteration}_{ssim:.4f}", state, iteration)

    def _save(self, name: str, state, iteration: int) -> str:
        path = os.path.join(self.dir, name + _SUFFIX)
        tmp = path + ".tmp"
        torch.save({"state": state.state_dict(), "iteration": int(iteration)}, tmp)
        os.replace(tmp, path)
        return path

    # -- load ---------------------------------------------------------------
    def find_checkpoint(self) -> str | None:
        """The best checkpoint if there is one, else the latest."""
        best = self._list("best_")
        if best:
            return os.path.join(self.dir, sorted(best)[-1])
        latest = os.path.join(self.dir, "latest" + _SUFFIX)
        return latest if os.path.isfile(latest) else None

    def restore(self, state, path: str | None = None):
        """Load a checkpoint into `state` (in place) -> (state, iteration)."""
        path = path or self.find_checkpoint()
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        state.load_state_dict(payload["state"])
        return state, int(payload["iteration"])

    def _list(self, prefix: str) -> list[str]:
        if not os.path.isdir(self.dir):
            return []
        return [f for f in os.listdir(self.dir)
                if f.startswith(prefix) and f.endswith(_SUFFIX)]

    def best_ssim(self) -> float:
        vals = [float(m.group(1)) for m in
                (re.match(r"best_\d+_(-?[\d.]+)\.pt$", b) for b in self._list("best_")) if m]
        return max(vals) if vals else -1.0


def save_avatar(path: str, avatar: GaussianAvatar) -> None:
    """Write the avatar's fields as CPU tensors to one file (whole, or not at all)."""
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in avatar._asdict().items()}, tmp)
    os.replace(tmp, path)


def load_avatar(path: str, device="cpu") -> GaussianAvatar:
    """The avatar `save_avatar` wrote, on `device`."""
    fields = torch.load(path, map_location="cpu", weights_only=True)
    return GaussianAvatar(**{k: fields[k].to(device) for k in GaussianAvatar._fields})
