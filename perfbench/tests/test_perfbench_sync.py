"""On the card, at the cells' own configurations: every host sync of the
port's frame and step lies inside a `guava.sync.*` span; the span table's
device seconds and the unattributed ones sum to the trace's; a span owns
95% or more of them (the client's RGB copy left out); the step's FFT
convolutions go to their forward spans.

`torch.cuda.set_sync_debug_mode("warn")` warns at every call that makes the
host wait on the device. Each warning raised under the port's code drops a
marker into the profile; each marker must lie inside a `guava.sync.*` span
on its thread. The client's own waits (the motion cell's copy of the RGB to
the host, the training cell's `float(loss)`) are the benchmark's and carry
no port frame."""

from __future__ import annotations

import re
import traceback
import warnings

import pytest

from perfbench import harness, spans, tracing

MARK = "perfbench.sync_warning"
FFT = r"fft|cf32"          # cuDNN's FFT convolutions: FFTs and complex GEMMs
PORT = "guava_renderer_tpu_torch"


def traced_syncs(fn):
    """Run fn() under the sync warnings and the profiler -> (profile, the
    port's innermost frame of each warning raised under the port's code)."""
    import torch

    found = []

    def hook(message, category, filename, lineno, file=None, line=None):
        port = [f"{fr.filename.rpartition(PORT)[2]}:{fr.lineno} {fr.name}"
                for fr in traceback.extract_stack()[:-1] if PORT in fr.filename]
        if port:
            found.append(port[-1])
            with torch.profiler.record_function(f"{MARK} {port[-1]}"):
                pass

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        with tracing.profiled(True) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    return prof, found


def outside_sync_spans(prof) -> list:
    """The markers (each named by its site) that lie inside no `guava.sync.*`
    span of their thread."""
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
              for e in prof.profiler.kineto_results.events()]
    syncs = [e for e in events if e[0].startswith("guava.sync.")]
    return [m[0] for m in events if m[0].startswith(MARK)
            and not any(s[3] == m[3] and s[1] <= m[1] and m[2] <= s[2] for s in syncs)]


def check(prof, found, match: str) -> dict:
    """The syncs all in sync spans; the table's seconds those of the trace;
    95% or more of them owned by a span, leaving out the client's copy of the
    RGB to the host. -> the table, with `match`'s column."""
    bad = outside_sync_spans(prof)
    assert len(found) >= 1, "no sync warning at all: the port's binning waits on the card"
    assert not bad, "host syncs outside guava.sync spans:\n" + "\n".join(bad)
    table = spans.span_table(*spans.events_of(prof), re.compile(match))
    summary = tracing.summarize(prof, 1.0)
    total = sum(s for s, _ in summary.by_name.values())
    assert spans.device_seconds(table) == pytest.approx(total, rel=1e-9)
    free = table.get(spans.UNATTRIBUTED, {"fwd_s": 0.0, "bwd_s": 0.0, "match_s": 0.0})
    client_copy = summary.seconds_of(lambda n: "Memcpy DtoH" in n)[0]
    assert free["fwd_s"] + free["bwd_s"] - min(client_copy, free["fwd_s"]) <= 0.05 * total
    return table


@pytest.mark.card
def test_frame_syncs_lie_in_sync_spans(card):
    import torch

    from perfbench.drivers import motion

    cell = harness.find_cell("out2048.motion")
    run = harness.Run(cell, 3_000_000_019, 0.0, False, card)
    rt, pipe = motion.build(run)
    avatar, targets = motion.seeded(run, rt, pipe, run.seed)
    size = int(cell.config["config"]["MODEL"]["image_size"])
    rgb = torch.empty((size, size, 3), pin_memory=True)
    rgb.copy_(pipe.render_frame(avatar, targets[0])["render"])
    check(*traced_syncs(lambda: rgb.copy_(pipe.render_frame(avatar, targets[1])["render"])),
          "Memcpy DtoH")


@pytest.mark.card
def test_step_syncs_lie_in_sync_spans(card):
    from perfbench.drivers import train

    cell = harness.find_cell("ubody512.train")
    job = train.build(harness.Run(cell, 3_000_000_019, 0.0, False, card))
    loss, _ = job["step"](next(job["batches"]))
    float(loss)

    def step():
        loss, _ = job["step"](next(job["batches"]))
        float(loss)

    table = check(*traced_syncs(step), FFT)
    fft = sum(r["match_s"] for r in table.values())
    # cuDNN's FFT convolutions run in the backward: each goes to its forward span
    assert table.get(spans.BACKWARD, {"match_s": 0.0})["match_s"] <= 0.05 * fft
    assert table.get(spans.UNATTRIBUTED, {"match_s": 0.0})["match_s"] <= 0.05 * fft
