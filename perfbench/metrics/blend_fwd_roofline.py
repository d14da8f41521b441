"""Kernel K1's (the forward blend, `csrc/blend.cu`) share of its roofline,
in %: the least time of the window's blends (the larger of the contributing
pairs' operations over the float32 peak and each input row, instance id
and output value once over the memory's peak, `counts.blend_fwd`, from the
reference's counts on the compared frames, a frame, times the frames) over
K1's device time in the trace."""

import re

from perfbench import counts

K1 = re.compile(r"blend_fwd_kernel<(guava_blend::)?PlainRows,")


def read(run):
    c, s = run.counts, run.summary
    if s is None or "pairs_per_frame" not in c:
        return None
    k1_s, k1_n = s.seconds_of(lambda name: K1.search(name) is not None)
    if k1_n == 0 or k1_s <= 0:
        return None
    ops, bytes_ = counts.blend_fwd(c["pairs_per_frame"], c["gaussians"],
                                   c["instances_per_frame"], c["size"], c["size"], c["tile"])
    least, _ = counts.least_time(ops, bytes_)
    return 100.0 * least * k1_n / k1_s
