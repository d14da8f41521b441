"""The whole training step's share of the card's float32 peak, in %: the
networks' convolutions and matrix products forward and backward (the
inferer, the refiner and LPIPS, counted by torch.utils.flop_counter over
the reference's first step), the blend's operations on the contributing
pairs forward and backward (`counts.BLEND_FWD_OPS_PER_PAIR` and
`BLEND_BWD_OPS_PER_PAIR`) and Adam's update (`counts.ADAM_OPS_PER_PARAM`),
a step, times the steps the window completed, over the window, over 67
TFLOP/s (H100 SXM, float32, TF32 off; the card's power limit is printed
beside the run). The binning, deform, EHM and the loss's elementwise terms
are not counted."""

from perfbench import counts


def read(run):
    c, s = run.counts, run.summary
    if s is None or s.n_ops == 0 or not c.get("network_flops") or not s.window_s:
        return None
    blend = c["pairs_per_step"] * (counts.BLEND_FWD_OPS_PER_PAIR + counts.BLEND_BWD_OPS_PER_PAIR)
    flops = c["network_flops"] + blend + counts.ADAM_OPS_PER_PARAM * c["params"]
    return 100.0 * flops * run.attempted / s.window_s / counts.PEAK_FP32_FLOPS
