"""(Gaussian, tile) instances binned a frame: the port's `instances` counter
(`ops/gsplat.py:bin_gaussians`, counted while the window's profiler records,
`utils/logging_utils.py:count`) over the frames the window completed. None
where the port keeps no counters."""


def read(run):
    from guava_renderer_tpu_torch.utils import logging_utils

    counters = getattr(logging_utils, "counters", None)
    if counters is None or not run.attempted:
        return None
    n = counters().get("instances")
    return None if n is None else n / run.attempted
