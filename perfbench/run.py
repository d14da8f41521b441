"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. With --trace 0 the result carries the
cell's end-to-end metrics, with --trace 1 its per-layer metrics, read from
a torch.profiler trace of the window. The last line of standard output is
the result, one JSON object; the numbers that decided `correct` close
standard error and the result. The run exits non-zero and prints no result
without enough CUDA devices for the cell, when the port is missing, or when
a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds its
    own CUDA kernels into build/torch_kernels/ there)."""
    base = ROOT / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, cell=None,
             setup_parts=None):
    """Set up, measure and check one cell on `device` (no look for a card) ->
    (harness.Run, the result's dict). `cell` replaces the manifest's (tests);
    `setup_parts` are the parts of set-up timed before the cell's own."""
    from perfbench import harness

    cell = harness.find_cell(name) if cell is None else cell
    run = harness.Run(cell, seed, seconds, trace, device)
    run.setup_parts.update(setup_parts or {})
    cell.driver().run(run)
    return run, result(run)


def result(run) -> dict:
    from perfbench import harness

    correct = all(c.ok for c in run.checks) and bool(run.checks) and run.failed == 0
    if run.trace:
        metrics = harness.per_layer_values(run)
    else:
        metrics = {m["name"]: {"value": float(run.values[m["name"]]), "unit": m["unit"]}
                   for m in run.cell.end_to_end if m["name"] in run.values}
    dev = run.device
    if dev.type == "cuda":
        import torch

        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                  "count": run.cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": None}
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.summary is not None:
        device["busy_s"] = run.summary.busy_s
        device["window_s"] = run.summary.window_s
        out["breakdown"] = {"device_ops": run.summary.device_ops(),
                            "idle_gaps": run.summary.idle_gaps}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return out


def main(argv=None) -> int:
    import time

    entered = time.time()
    args = parse_args(argv)
    # the package by its name, and not this directory's files as top-level modules
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path[0] = str(ROOT)
    else:
        sys.path.insert(0, str(ROOT))
    cache_dirs()
    from perfbench import harness

    cell = harness.find_cell(args.workload)
    parts = {"interpreter": entered - harness.process_start()}
    t0 = time.time()
    import torch

    parts["torch_import"] = time.time() - t0
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"{args.workload} needs {cell.chips} CUDA device(s); found {n}")
        return 2
    t0 = time.time()
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    parts["cuda_init"] = time.time() - t0
    run, out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device, cell,
                        parts)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}")
        return 3
    harness.log(f"card: {harness.power_limit()}")
    for c in run.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
