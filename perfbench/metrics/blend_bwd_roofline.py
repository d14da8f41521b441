"""Kernel K3's (the blend's backward, `csrc/blend_bwd.cu`) share of its
roofline, in %: the least time of a step's backward blends (the larger of
the contributing pairs' operations over the float32 peak and the bytes each
launch moves once over the memory's peak, `counts.blend_bwd`, from the
reference's counts on the job's first steps) over K3's device time a step
in the trace."""

import re

from perfbench import counts

K3 = re.compile(r"blend_bwd_kernel")


def read(run):
    c, s = run.counts, run.summary
    if s is None or "pairs_per_step" not in c or not run.attempted:
        return None
    k3_s, k3_n = s.seconds_of(lambda name: K3.search(name) is not None)
    if k3_n == 0 or k3_s <= 0:
        return None
    ops, bytes_ = counts.blend_bwd(c["pairs_per_step"], c["gaussians_per_step"],
                                   c["instances_per_step"], c["items_per_step"], c["size"],
                                   c["size"], c["tile"])
    least, _ = counts.least_time(ops, bytes_)
    return 100.0 * least * run.attempted / k3_s
