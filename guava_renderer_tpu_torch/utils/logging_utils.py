"""Run logging and observability (counterpart of
`guava_renderer_tpu/utils/logging_utils.py`).

Covers the reference's logger + moving-average loss lines + speed_info
persistence (ref: utils/general_utils.py:294-308, main/trainer.py:234-255,
main/test.py:46-50,90-94), plus a torch.profiler trace hook that writes a
Chrome trace (the reference has no profiler integration at all — SURVEY
§5.1).

Spans and counters. `span(name)` marks a layer of the frame or the step
(`guava.render_frame`, `guava.bin`, `guava.sync.<site>` around a place
where the host waits on the device, ...) as a `record_function`
annotation: it shares the device trace's clock and shows in every
torch.profiler trace, `profiler_trace`'s included. `count(name, n)` adds to
an in-memory counter. Both record only while a torch profiler records;
otherwise a span or a count costs one test of the profiler's flag, with no
dispatcher call and no allocation. While they record, each span also adds
its host seconds to `span_seconds()`, and `counters()` holds the counts.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import threading
import time
from collections import defaultdict, deque

from torch.autograd import profiler as _profiler


def build_logger(name: str, dump_dir: str | None = None) -> logging.Logger:
    """File (DEBUG) + console (INFO) logger (ref 'biuld_logger')."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    con = logging.StreamHandler()
    con.setLevel(logging.INFO)
    con.setFormatter(logging.Formatter("[%(asctime)s] %(message)s", "%H:%M:%S"))
    logger.addHandler(con)
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(dump_dir, "train_log.txt"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(
            logging.Formatter("[%(asctime)s][%(levelname)s] %(message)s")
        )
        logger.addHandler(fh)
    return logger


class MovingAverageMeter:
    """100-iteration moving averages (ref: trainer.py:234-255)."""

    def __init__(self, window: int = 100):
        self._values: dict[str, deque] = defaultdict(lambda: deque(maxlen=window))

    def update(self, metrics: dict) -> None:
        for k, v in metrics.items():
            self._values[k].append(float(v))

    def averages(self) -> dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self._values.items() if v}

    def format(self) -> str:
        return " ".join(f"{k}={v:.4f}" for k, v in sorted(self.averages().items()))


class SpeedMeter:
    """Accumulates per-stage wall times; writes speed_info.json
    ({'infer_time' ms, 'render_speed' fps}, ref: main/test.py:90-94).

    On a CUDA `device` each timed region synchronizes the device when it
    starts and before it reads the clock at its end (the JAX package's
    `block_until_ready`): kernels are launched asynchronously, and without
    the wait the clock measures how fast the host queues them."""

    def __init__(self, device=None):
        self.infer_time_ms: float | None = None
        self._render_times: list[float] = []
        self._device = device

    def _sync(self) -> None:
        if self._device is not None:
            import torch

            dev = torch.device(self._device)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    @contextlib.contextmanager
    def time_infer(self):
        self._sync()
        t0 = time.time()
        yield
        self._sync()
        self.infer_time_ms = (time.time() - t0) * 1000.0

    @contextlib.contextmanager
    def time_frame(self):
        self._sync()
        t0 = time.time()
        yield
        self._sync()
        self._render_times.append(time.time() - t0)

    @contextlib.contextmanager
    def time_frames(self, n: int):
        """Time one region that produces n frames (a grouped render)."""
        self._sync()
        t0 = time.time()
        yield
        self._sync()
        self.add_frames(n, time.time() - t0)

    def add_frames(self, n: int, total_seconds: float) -> None:
        """Record n frames produced by ONE batched device call
        (frames-data-parallel rendering)."""
        if n > 0:
            self._render_times.extend([total_seconds / n] * n)

    @property
    def render_fps(self) -> float:
        if not self._render_times:
            return 0.0
        return len(self._render_times) / sum(self._render_times)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "infer_time": self.infer_time_ms,
                    "render_speed": self.render_fps,
                },
                f,
                indent=2,
            )


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Optional torch.profiler trace around a region, written to
    `<log_dir>/trace.json` in the Chrome trace format; device activity is
    recorded when a CUDA device is present.

    The trace carries the port's spans (`span`) beside torch's operations:
    `guava.render_frame` (a frame), `guava.train_step` (a step) and, inside
    them, `guava.deform`, `guava.bin`, `guava.blend`, `guava.resize`,
    `guava.refine`, `guava.create`, `guava.loss`, `guava.backward`,
    `guava.update`; the loader's `guava.loader.wait` and
    `guava.loader.to_device`; and `guava.sync.<site>` around each place
    where the host waits on the device."""
    if not log_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


# -- spans and counters ---------------------------------------------------------

_lock = threading.Lock()
_counters: dict[str, float] = {}
_span_seconds: dict[str, float] = {}
_OFF = contextlib.nullcontext()


class _Span:
    """A recording span: the profiler's annotation and the host seconds inside it."""

    __slots__ = ("_name", "_annotation", "_t0")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        self._annotation = _profiler.record_function(self._name)
        self._annotation.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        self._annotation.__exit__(*exc)
        with _lock:
            _span_seconds[self._name] = _span_seconds.get(self._name, 0.0) + seconds
        return False


def span(name: str):
    """A context manager marking the layer `name` (`guava.` and the layer)
    while a torch profiler records; a shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n) -> None:
    """Add `n` to the counter `name` while a torch profiler records."""
    if _profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """{counter: its sum} since the last `reset_counters()`."""
    with _lock:
        return dict(_counters)


def span_seconds() -> dict:
    """{span: host seconds inside it, summed over its calls} since the last
    `reset_counters()`."""
    with _lock:
        return dict(_span_seconds)


def reset_counters() -> None:
    """Clear the counters and the spans' host seconds."""
    with _lock:
        _counters.clear()
        _span_seconds.clear()
