"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """Entry-point device: "cuda" unless the caller names another one.

    Raises when a CUDA device is asked for (the default) and none is
    present: the port never falls back to the CPU on its own. On a CUDA
    device, float32 convolutions and matrix products are computed in float32
    (TF32 off, where PyTorch leaves cuDNN's on): the port is held against
    float32 references, and TF32 keeps a 10-bit mantissa of each operand.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
