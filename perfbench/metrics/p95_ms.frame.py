"""95th percentile of the window's frames, each timed on the host from the
`render_frame` call to its RGB on the host, in ms. Read in the traced run,
whose profiler slows the host; it spreads too widely from run to run to
bound as an end-to-end metric (PERF.md)."""


def read(run):
    return run.counts.get("frame_p95_ms")
