"""Host ms a training step spent waiting on the card: the host seconds
inside the port's `guava.sync.*` spans (each around a place where the host
waits on the device; `utils/logging_utils.py:span`, recorded while the
window's profiler records) over the steps the window completed. None where
the port keeps no spans."""


def read(run):
    from guava_renderer_tpu_torch.utils import logging_utils

    seconds = getattr(logging_utils, "span_seconds", None)
    if seconds is None or not run.attempted:
        return None
    return 1e3 * sum(s for k, s in seconds().items() if k.startswith("guava.sync.")) / run.attempted
