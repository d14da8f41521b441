"""The device trace of a run's measured window, and what the per-layer
metrics read from it.

`torch.profiler` records the window (host operations and the card's
operations, CUPTI). The card's busy time is the union of its operations'
intervals (kernels, copies, sets; not the host's annotations mirrored on
its timeline), so operations that overlap on two streams count once. The idle
gaps are the stretches between those intervals, each named by the
innermost host operation that was running at its middle.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class TraceSummary:
    busy_s: float                        # union of device-operation intervals
    window_s: float                      # the traced window, host clock
    n_ops: int                           # device operations in the window
    by_name: dict = field(default_factory=dict)     # name -> [seconds, count]
    idle_gaps: list = field(default_factory=list)   # [[host operation, seconds], ...]

    def device_ops(self, n: int = 10) -> list:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name, secs] for name, (secs, _) in top]

    def seconds_of(self, match) -> tuple[float, int]:
        """(device seconds, operations) of the operations whose name `match` accepts."""
        hits = [v for k, v in self.by_name.items() if match(k)]
        return sum(s for s, _ in hits), sum(c for _, c in hits)


def _events(prof):
    """(device [(name, start_ns, end_ns)], host [(name, start_ns, end_ns)]).

    A host annotation (`record_function`, `Optimizer.step#...`) is mirrored
    on the device's timeline, where it spans operations and the gaps
    between them: no operation itself. It is known by its kind where the
    profiler gives one, and by its name, which a host event bears too."""
    dev_type = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        annotation = "annotation" in kind or bool(
            getattr(e, "is_user_annotation", lambda: False)())
        if e.device_type() == dev_type:
            if not annotation:
                device.append((e.name(), start, end))
        elif kind in ("cpu_op", "user_annotation", ""):
            host.append((e.name(), start, end))
    host_names = {n for n, _, _ in host}
    return [d for d in device if d[0] not in host_names], host


def _innermost(host, points) -> list[str]:
    """For each of the ascending `points`, the name of the latest-starting
    host operation that contains it (the innermost, where operations nest),
    or "(host between operations)". One sweep with a stack of open operations."""
    events = sorted(host, key=lambda e: (e[1], -e[2]))
    out, stack, k = [], [], 0
    for p in points.tolist():
        while k < len(events) and events[k][1] <= p:
            stack.append(events[k])
            k += 1
        while stack and stack[-1][2] < p:
            stack.pop()
        if len(stack) > 256:
            stack = [e for e in stack if e[2] >= p]
        # an operation that ended before p can hide under a later one; skip it
        j = len(stack) - 1
        while j >= 0 and stack[j][2] < p:
            j -= 1
        out.append(stack[j][0] if j >= 0 else "(host between operations)")
    return out


def summarize(prof, window_s: float) -> TraceSummary:
    return summarize_events(*_events(prof), window_s)


def summarize_events(device: list, host: list, window_s: float) -> TraceSummary:
    """Device and host operations as (name, start_ns, end_ns) -> the summary."""
    by_name: dict = {}
    for name, s, e in device:
        slot = by_name.setdefault(name, [0.0, 0])
        slot[0] += (e - s) * 1e-9
        slot[1] += 1
    if not device:
        return TraceSummary(0.0, window_s, 0, by_name, [])
    iv = np.array(sorted((s, e) for _, s, e in device), dtype=np.int64)
    # merge the intervals: a new block starts where a start passes every earlier end
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    block_ends = np.append(ends[np.flatnonzero(new)[1:] - 1], ends[-1])
    busy_s = float((block_ends - starts).sum()) * 1e-9
    gaps = starts[1:] - block_ends[:-1]
    mids = (block_ends[:-1] + starts[1:]) // 2
    named: dict = {}
    for g, name in zip(gaps.tolist(), _innermost(host, mids)):
        named[name] = named.get(name, 0.0) + g * 1e-9
    idle = sorted(([k, v] for k, v in named.items()), key=lambda kv: -kv[1])[:10]
    return TraceSummary(busy_s, window_s, len(device), by_name, idle)


@contextlib.contextmanager
def profiled(enabled: bool):
    """torch.profiler over the block when `enabled` (CPU and CUDA); yields
    the profiler or None."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
