"""The whole frame's share of the card's float32 peak, in %: the refiner's
convolutions and matrix products (counted on the reference's shapes), the
two bilinear resizes' taps and the forward blend's operations on the
contributing pairs (counted by the reference on the compared frames), a
frame, times the frames the window completed, over the window, over 67
TFLOP/s (H100 SXM, float32, TF32 off; the card's power limit is printed
beside the run). The EHM, deform and projection are elementwise or tiny
and not counted."""

from perfbench import counts


def read(run):
    c, s = run.counts, run.summary
    if s is None or s.n_ops == 0 or "pairs_per_frame" not in c:
        return None
    blend_ops, _ = counts.blend_fwd(c["pairs_per_frame"], c["gaussians"],
                                    c["instances_per_frame"], c["size"], c["size"], c["tile"])
    flops = c["refiner_flops"] + c["resize_flops"] + blend_ops
    return 100.0 * flops * run.attempted / s.window_s / counts.PEAK_FP32_FLOPS
