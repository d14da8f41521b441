"""Share of the window in which no operation ran on the card: 1 - the union
of the trace's device-operation intervals / the window, in %."""


def read(run):
    s = run.summary
    if s is None or s.n_ops == 0 or not s.window_s:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
