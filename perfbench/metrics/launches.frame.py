"""Device operations a frame: the trace's device operations in the window
over the frames the window completed."""


def read(run):
    s = run.summary
    if s is None or s.n_ops == 0 or not run.attempted:
        return None
    return s.n_ops / run.attempted
