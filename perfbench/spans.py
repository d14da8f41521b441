"""The device time of a traced window by the program's own spans.

The port marks its layers with `guava.*` spans (`record_function`
annotations, `guava_renderer_tpu_torch/utils/logging_utils.py:span`). This
module reads the same torch.profiler trace as `tracing.py` and gives each
span its calls, its host seconds, the device seconds it owns, forward and
backward, and the device's idle seconds under it:

- A device operation goes, through its correlation id, to the host call
  that launched it. The innermost `guava.*` span open on that call's thread
  at the launch owns it, as its forward part.
- A launch inside an autograd node (`autograd::engine::evaluate_function:
  ...`, on autograd's device thread) belongs to the span that was open when
  the forward operation the node differentiates ran: the node's sequence
  number and forward thread name that operation. That span owns it as its
  backward part. A span opened inside the node itself (a kernel's backward
  wrapper) owns it instead. A node with no forward operation leaves it to
  `guava.backward`.
- The idle gaps are those of `tracing.py` (between the union of the device
  intervals); each goes to the innermost span open at its middle on the
  thread that launched most of the window's work.

A span's `fwd_s`, `bwd_s` and `idle_s` are its own (innermost); `total_s`
adds the device seconds of the spans inside it. The operations no span owns
are `UNATTRIBUTED`'s, so the owned and the unattributed seconds sum to the
window's device-operation seconds (`TraceSummary.by_name`).

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s> [--out <json>]

runs one traced run of the cell (`run.py --trace 1`, whose result line it
prints) and writes its span table to standard error and to `--out`.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import re
import sys
from pathlib import Path
from typing import NamedTuple

PREFIX = "guava."
BACKWARD = "guava.backward"
UNATTRIBUTED = "(no span)"
NODE = "autograd::engine::evaluate_function: "


class HostEvent(NamedTuple):
    """A host operation or annotation of the trace (times in ns)."""

    name: str
    start: int
    end: int
    thread: int = 0
    seq: int = -1           # autograd's sequence number (forward operations and nodes)
    fwd_thread: int = 0     # a node's: the thread its forward operation ran on


class DeviceOp(NamedTuple):
    """A device operation and the host thread and time of its launch (None: not found)."""

    name: str
    start: int
    end: int
    thread: int | None = None
    launch: int | None = None


class _Innermost:
    """The innermost of one thread's nesting intervals open at a time."""

    def __init__(self, events: list):
        self.events = sorted(events, key=lambda e: (e.start, -e.end))
        self.starts = [e.start for e in self.events]
        # parent[i]: the innermost event that contains event i, or -1
        self.parent, stack = [], []
        for i, e in enumerate(self.events):
            while stack and self.events[stack[-1]].end < e.start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: int) -> int:
        """Index of the innermost event with start <= t <= end, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.events[i].end < t:
            i = self.parent[i]
        return i


def _by_thread(events: list) -> dict:
    out: dict = {}
    for e in events:
        out.setdefault(e.thread, []).append(e)
    return {t: _Innermost(evs) for t, evs in out.items()}


def _idle_gaps(device: list) -> list:
    """[(gap ns, gap middle ns)] between the union of the device intervals."""
    iv = sorted((d.start, d.end) for d in device)
    gaps, end = [], None
    for s, e in iv:
        if end is not None and s > end:
            gaps.append((s - end, (s + end) // 2))
        end = e if end is None else max(end, e)
    return gaps


def span_table(device: list, host: list, match=None) -> dict:
    """DeviceOps and HostEvents -> {span name: {"calls", "host_s", "fwd_s",
    "bwd_s", "idle_s", "total_s"}}, with UNATTRIBUTED's row for the
    operations no span owns. With `match` (a compiled pattern), each row also has "match_s" and
    "match_bwd_s": its own device seconds of the operations whose name the
    pattern finds, in all and in its backward part."""
    spans = _by_thread([h for h in host if h.name.startswith(PREFIX)])
    nodes = _by_thread([h for h in host if h.name.startswith(NODE)])
    table: dict = {}

    def row(name):
        return table.setdefault(name, {"calls": 0, "host_s": 0.0, "fwd_s": 0.0, "bwd_s": 0.0,
                                       "idle_s": 0.0, "total_s": 0.0, "match_s": 0.0,
                                       "match_bwd_s": 0.0})

    for idx in spans.values():
        for e in idx.events:
            r = row(e.name)
            r["calls"] += 1
            r["host_s"] += (e.end - e.start) * 1e-9

    def chain(thread, i):
        """The names of span i of `thread` and of the spans around it."""
        idx, names = spans[thread], set()
        while i >= 0:
            names.add(idx.events[i].name)
            i = idx.parent[i]
        return names

    # the forward operation each node differentiates: (thread, seq) -> its first op's span
    wanted = {(n.fwd_thread, n.seq) for idx in nodes.values() for n in idx.events if n.seq >= 0}
    first: dict = {}
    for h in host:
        key = (h.thread, h.seq)
        if key in wanted and not h.name.startswith((NODE, PREFIX)):
            if key not in first or h.start < first[key].start:
                first[key] = h
    fwd_owner = {k: (h.thread, spans[h.thread].at(h.start) if h.thread in spans else -1)
                 for k, h in first.items()}
    backward_spans = [(t, i) for t, idx in spans.items()
                      for i, e in enumerate(idx.events) if e.name == BACKWARD]

    def owner(op):
        """-> (thread, span index or -1, part)."""
        t, when = op.thread, op.launch
        s = spans[t].at(when) if t in spans else -1
        n = nodes[t].at(when) if t in nodes else -1
        if n < 0:
            return t, s, "fwd_s"
        node = nodes[t].events[n]
        if s >= 0 and spans[t].events[s].start >= node.start:
            return t, s, "bwd_s"
        ft, fs = fwd_owner.get((node.fwd_thread, node.seq), (None, -1))
        if fs >= 0:
            return ft, fs, "bwd_s"
        for bt, bi in backward_spans:
            b = spans[bt].events[bi]
            if b.start <= when <= b.end:
                return bt, bi, "bwd_s"
        return None, -1, "bwd_s"

    for op in device:
        secs = (op.end - op.start) * 1e-9
        t, i, part = owner(op) if op.thread is not None else (None, -1, "fwd_s")
        r = row(UNATTRIBUTED if i < 0 else spans[t].events[i].name)
        r[part] += secs
        if match is not None and match.search(op.name):
            r["match_s"] += secs
            if part == "bwd_s":
                r["match_bwd_s"] += secs
        if i < 0:
            continue
        for name in chain(t, i):
            table[name]["total_s"] += secs

    if spans:
        # the thread of the longest span: the one whose loop launches the window's work
        main = max(spans, key=lambda t: max(e.end - e.start for e in spans[t].events))
        for gap, mid in _idle_gaps(device):
            i = spans[main].at(mid)
            if i >= 0:
                row(spans[main].events[i].name)["idle_s"] += gap * 1e-9
    return table


def events_of(prof) -> tuple[list, list]:
    """A torch.profiler profile -> (DeviceOps, HostEvents). The device
    operations are those `tracing._events` keeps. Each is found its launch:
    the runtime call with its correlation id gives the time, and the host
    operation that call links to gives the thread (runtime calls carry the
    system's thread id, host operations the profiler's). Runtime calls are
    the host-side events that link to a host operation; host operations and
    annotations link to none."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host, runtime, by_id, host_names = [], [], {}, {}, set()
    for e in prof.profiler.kineto_results.events():
        kind = getattr(e, "activity_type", lambda: "")()
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == cuda:
            annotation = "annotation" in kind or bool(
                getattr(e, "is_user_annotation", lambda: False)())
            if not annotation:
                device.append((name, start, end, e.correlation_id(), e.linked_correlation_id()))
            continue
        if kind in ("cpu_op", "user_annotation", ""):
            host_names.add(name)
        link = e.linked_correlation_id()
        if link > 0:
            runtime[e.correlation_id()] = (start, e.start_thread_id(), link)
            continue
        thread, seq = e.start_thread_id(), e.sequence_nr()
        by_id[e.correlation_id()] = (thread, start)
        if seq >= 0 or name.startswith((PREFIX, NODE)):
            host.append(HostEvent(name, start, end, thread, seq, e.fwd_thread_id()))
    # system thread id -> the profiler's, from the runtime calls that link to a host operation
    tids = {tid: by_id[link][0] for _, tid, link in runtime.values() if link in by_id}
    ops = []
    for name, start, end, corr, link in device:
        if name in host_names:
            continue
        thread = launch = None
        if corr in runtime:
            launch, tid, rlink = runtime[corr]
            linked = by_id.get(rlink) or by_id.get(link)
            thread = linked[0] if linked is not None else tids.get(tid)
        elif link in by_id:
            thread, launch = by_id[link]
        ops.append(DeviceOp(name, start, end, thread, launch))
    return ops, host


def device_seconds(table: dict) -> float:
    """Device seconds of the table: owned and unattributed."""
    return sum(r["fwd_s"] + r["bwd_s"] for r in table.values())


def format_table(table: dict) -> str:
    """The table, one span a line by its total device time, in ms."""
    k = 1e3
    lines = [f"{'span (ms)':32s} {'calls':>7s} {'host':>9s} {'fwd':>9s} {'bwd':>9s} "
             f"{'total':>9s} {'idle':>9s} {'match':>9s} {'of bwd':>9s}"]
    for name, r in sorted(table.items(), key=lambda kv: -kv[1]["total_s"]):
        lines.append(f"{name:32s} {r['calls']:7d} {k * r['host_s']:9.3f} "
                     f"{k * r['fwd_s']:9.3f} {k * r['bwd_s']:9.3f} {k * r['total_s']:9.3f} "
                     f"{k * r['idle_s']:9.3f} {k * r['match_s']:9.3f} "
                     f"{k * r['match_bwd_s']:9.3f}")
    return "\n".join(lines)


@contextlib.contextmanager
def splitting(match=None):
    """While open, every `tracing.summarize` of a run also splits the
    profile by span: yields a dict that gains "table" (`span_table`) and
    "device_s" (the summary's device-operation seconds). The summary itself
    is `tracing.summarize`'s. `match` as `span_table`'s."""
    from perfbench import tracing

    summarize, got = tracing.summarize, {}

    def summarize_and_split(prof, window_s):
        s = summarize(prof, window_s)
        got["table"] = span_table(*events_of(prof), match)
        got["device_s"] = sum(v[0] for v in s.by_name.values())
        return s

    tracing.summarize = summarize_and_split
    try:
        yield got
    finally:
        tracing.summarize = summarize


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="one traced run of a cell and its span table")
    ap.add_argument("--out", default=None, help="write the table here as JSON")
    ap.add_argument("--match", default=None,
                    help="a regular expression: each span's device seconds of the "
                         "operations whose name it finds (the table's match column)")
    args, rest = ap.parse_known_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path[0] = str(Path(__file__).resolve().parent.parent)
    from perfbench import run

    with splitting(re.compile(args.match) if args.match else None) as got:
        rc = run.main(rest + ["--trace", "1"])
    if "table" in got:
        print(format_table(got["table"]), file=sys.stderr, flush=True)
        print(f"[spans] device seconds: table {device_seconds(got['table'])!r}, "
              f"trace {got['device_s']!r}", file=sys.stderr, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(got, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
