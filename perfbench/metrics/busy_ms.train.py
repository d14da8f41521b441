"""Device time a training step, in ms: the union of the trace's
device-operation intervals over the steps the window completed."""


def read(run):
    s = run.summary
    if s is None or s.n_ops == 0 or not run.attempted:
        return None
    return 1e3 * s.busy_s / run.attempted
