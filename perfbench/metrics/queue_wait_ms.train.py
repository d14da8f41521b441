"""Host ms a training step waited on the loader's queue: the host seconds
inside the port's `guava.loader.wait` span (`data/loader.py:PrefetchLoader`,
the consumer's `q.get()`, recorded while the window's profiler records)
over the steps the window completed. None where the port keeps no spans."""


def read(run):
    from guava_renderer_tpu_torch.utils import logging_utils

    seconds = getattr(logging_utils, "span_seconds", None)
    if seconds is None or not run.attempted:
        return None
    wait = seconds().get("guava.loader.wait")
    return None if wait is None else 1e3 * wait / run.attempted
