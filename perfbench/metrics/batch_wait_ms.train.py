"""Mean host ms a training step waits on the loader's `next()` (the pinned
batch's copies to the card are queued there too)."""


def read(run):
    return run.counts.get("batch_wait_ms")
