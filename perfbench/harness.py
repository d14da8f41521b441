"""The harness: the manifest, the files it names, the run's clock, its
window, its checks, and the result line.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is a file of its own, found by its name in
`BENCHMARK.json`:

    perfbench/configs/<config>.json       the configuration as run
    perfbench/traffic/<traffic>.json      the mix; its "generator" names
                                          perfbench/generators/<generator>.py
    perfbench/workloads/<cell>.json       the cell's driver
                                          (perfbench/drivers/<driver>.py) and
                                          the limits of its checks
    perfbench/metrics/<metric>.py         a per-layer metric's reader
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
MANIFEST = ROOT / "BENCHMARK.json"
# what may not be loaded in a run, by the top-level name of each module
FORBIDDEN = ("jax", "jaxlib", "flax", "guava_renderer_tpu")


def process_start() -> float:
    """time.time() at which this process started (from /proc; the time of
    this call where /proc is not there)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rpartition(")")[2].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.partition(".")[0] in FORBIDDEN})


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def entry(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in {MANIFEST.name}")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file found by name (file names may hold dots), loaded
    once a process under `name`."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise SystemExit(f"missing {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


@dataclass
class Cell:
    """One cell of the manifest with the files its names lead to."""

    name: str
    chips: int
    config: dict           # perfbench/configs/<config>.json
    traffic: dict          # perfbench/traffic/<traffic>.json
    workload: dict         # perfbench/workloads/<cell>.json
    end_to_end: list       # the manifest's end-to-end metrics this cell reports
    per_layer: list        # the manifest's per-layer metrics this cell reports

    def generator(self):
        g = self.traffic["generator"]
        return load_module(PKG / "generators" / f"{g}.py", f"perfbench.generators.{g}")

    def driver(self):
        d = self.workload["driver"]
        return load_module(PKG / "drivers" / f"{d}.py", f"perfbench.drivers.{d}")


def find_cell(name: str, manifest: dict | None = None) -> Cell:
    man = load_manifest() if manifest is None else manifest
    w = entry(man["workloads"], name, "workload")
    config = read_json(PKG / "configs" / f"{w['config']}.json")
    traffic = read_json(PKG / "traffic" / f"{w['traffic']}.json")
    workload = read_json(PKG / "workloads" / f"{name}.json")
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return Cell(name, int(w["chips"]), config, traffic, workload, e2e, per_layer)


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit   # NaN fails


@dataclass
class Run:
    """What a driver hands back and the metric readers read."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object                     # torch.device
    started: float = field(default_factory=process_start)
    setup_parts: dict = field(default_factory=dict)
    setup_s: float | None = None
    window_s: float | None = None
    memory_peak_bytes: int | None = None
    attempted: int = 0
    failed: int = 0
    values: dict = field(default_factory=dict)      # end-to-end metric -> value
    counts: dict = field(default_factory=dict)      # what the readers read besides the trace
    checks: list = field(default_factory=list)
    summary: object = None                          # tracing.TraceSummary with --trace 1

    @contextlib.contextmanager
    def part(self, name: str):
        """Time one part of set-up (host clock, the device synchronised)."""
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        self.setup_parts[name] = self.setup_parts.get(name, 0.0) + time.perf_counter() - t0

    @contextlib.contextmanager
    def window(self):
        """The measured window: set-up ends where it starts; with --trace 1
        the profiler records it. The peak of device memory is read at its end."""
        from . import tracing

        _sync(self.device)
        self.setup_s = self.values["setup_s"] = time.time() - self.started
        with tracing.profiled(self.trace) as prof:
            t0 = time.perf_counter()
            yield
            _sync(self.device)
            self.window_s = time.perf_counter() - t0
        if prof is not None:
            self.summary = tracing.summarize(prof, self.window_s)
        if self.device.type == "cuda":
            import torch

            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def power_limit() -> str | None:
    """nvidia-smi's "name, power.limit" of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def per_layer_values(run: Run) -> dict:
    """{metric: {"value", "unit"}} of the cell's per-layer metrics whose readers found something."""
    out = {}
    for m in run.cell.per_layer:
        reader = load_module(PKG / "metrics" / f"{m['name']}.py", f"perfbench.metrics.{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)
