"""Device time a frame, in ms: the union of the trace's device-operation
intervals over the frames the window completed. Steadier than the host's
frame rate, which the launches and the host's copies pace."""


def read(run):
    s = run.summary
    if s is None or s.n_ops == 0 or not run.attempted:
        return None
    return 1e3 * s.busy_s / run.attempted
