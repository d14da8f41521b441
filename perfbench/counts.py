"""The work that a cell's inputs need, counted from the inputs and the
reference's shapes, and the card's published peaks.

Whatever implements the work, these counts stay the same, so a kernel that
does less than the inputs need shows as a share above its roofline and not
as a lower bound.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12          # float32 outside the tensor cores (TF32 is off)
PEAK_HBM_BYTES_PER_S = 3.35e12

ROW_BYTES = 44 * 4               # a Gaussian's blend row: geometry, 32 colours, inverse depth
CHANNELS = 32
# Operations of one contributing (pixel, Gaussian) pair in the forward blend:
# the offset (2), the quadratic form (6), exp and the opacity product (2),
# the 1/255 and power tests and the clamp (3), the transmittance test (2),
# the weight (1), 32 colours and the inverse depth accumulated (2 x 33).
BLEND_FWD_OPS_PER_PAIR = 2 + 6 + 2 + 3 + 2 + 1 + 2 * (CHANNELS + 1)
# Operations of one contributing pair in the backward blend (K3's replay):
# alpha again (13: the offset, the quadratic form, exp, the product, the
# tests), the transmittance (2), the colours' dot product with the output
# gradient (2 x 33), the running prefix (2), d alpha (6), d G (1), the two
# offsets' factors (2), the six geometry gradients (16), the 33 colour and
# inverse-depth gradients (2 x 33).
BLEND_BWD_OPS_PER_PAIR = 13 + 2 + 2 * (CHANNELS + 1) + 2 + 6 + 1 + 2 + 16 + 2 * (CHANNELS + 1)
# Adam's update of one parameter: both moments (7), the bias corrections and
# the square root (3), the step (4).
ADAM_OPS_PER_PARAM = 14


def least_time(ops: float, bytes_: float) -> tuple[float, str]:
    """-> (the least seconds the card could take, "ops" or "bytes", whichever bounds it)."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, bytes_ / PEAK_HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def blend_fwd(pairs: int, n_gaussians: int, instances: int, height: int, width: int,
              tile: int) -> tuple[float, float]:
    """(ops, bytes) of one forward blend: the operations of the contributing
    pairs, and each input row, instance id, tile range and output value
    (32 colours, the inverse depth, the final transmittance) moved once."""
    n_tiles = (height // tile) * (width // tile)
    bytes_ = (n_gaussians * ROW_BYTES + instances * 4 + (n_tiles + 1) * 4
              + height * width * (CHANNELS + 2) * 4)
    return float(pairs * BLEND_FWD_OPS_PER_PAIR), float(bytes_)


def blend_bwd(pairs: float, n_gaussians: float, instances: float, images: float, height: int,
              width: int, tile: int) -> tuple[float, float]:
    """(ops, bytes) of the backward blends of `images` images: the
    contributing pairs' operations, and each input row, instance id, tile
    range, forward output read (32 colours, the inverse depth, the final
    transmittance), output gradient read (33 values) and row gradient
    written (44 values) once."""
    n_tiles = (height // tile) * (width // tile)
    px = height * width
    bytes_ = (n_gaussians * ROW_BYTES * 2 + instances * 4 + images * (n_tiles + 1) * 4
              + images * px * ((CHANNELS + 2) + (CHANNELS + 1)) * 4)
    return float(pairs * BLEND_BWD_OPS_PER_PAIR), float(bytes_)


def bilinear_taps_flops(channels: int, size_in: int, size_out: int) -> float:
    """Operations of a separable bilinear resize of a square image, as its
    taps: each output pixel weighs 2 taps a side (an antialiased downscale
    by f weighs 2f), a multiply and an add each, along each axis."""
    taps = 2 * max(1, size_in // size_out)
    # rows first (out x in columns), then columns (out x out)
    return float(2 * taps * channels * (size_out * size_in + size_out * size_out))


def module_flops(module: torch.nn.Module, *shapes) -> float:
    """Operations of the module's matrix products and convolutions on inputs
    of these shapes, counted by `torch.utils.flop_counter` on meta tensors
    (shapes only, no arithmetic)."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = module.to("meta") if next(module.parameters()).device.type != "meta" else module
    inputs = [torch.zeros(s, device="meta") for s in shapes]
    counter = FlopCounterMode(display=False)
    with counter:
        meta(*inputs)
    return float(counter.get_total_flops())
