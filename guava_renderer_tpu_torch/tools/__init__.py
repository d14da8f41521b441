"""The port's probe tools, counterparts of the JAX package's `tools/`
instruments for its hot kernel, each run as a module:

    python -m guava_renderer_tpu_torch.tools.ee_probe            K1p: the blend's tile exit
    python -m guava_renderer_tpu_torch.tools.dma_bench           T2: row-gather rates
    python -m guava_renderer_tpu_torch.tools.sort_payload_bench  T3: stream + payload sort
    python -m guava_renderer_tpu_torch.tools.mosaic_probe        T1: copy probes

Each runs on the card unless given `--device cpu`, where it runs the plain
kernels and measures no time. `main(argv)` prints the tool's lines and
returns what it measured.
"""

from __future__ import annotations

import statistics

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
# ~1 ms of device spinning queued ahead of each timed call, doubled (up to 8x) while the
# host takes longer than that to enqueue the call's launches
SLEEP_CYCLES = 2_000_000
MAX_SLEEP_CYCLES = 8 * SLEEP_CYCLES


def device_ms(fn, device: torch.device, iters: int, warmup: int = 2) -> float | None:
    """Median device time of fn() in ms over `iters` runs (CUDA events); None
    on the CPU, where there is no device time to measure.

    Each run is queued behind a device spin, so the start event fires only
    once fn's launches are queued: the time is the device's alone, without
    the host's time to reach the launch (which is the whole time of a
    kernel of a few microseconds). A run whose spin ended before the host
    had queued fn is dropped and the spin doubled, up to MAX_SLEEP_CYCLES: a
    fn that waits for the device outlasts any spin, and is timed at the cap."""
    if device.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    times = []
    spin = SLEEP_CYCLES
    while len(times) < iters:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        host_late = start.query()
        end.synchronize()
        if host_late and spin < MAX_SLEEP_CYCLES:
            spin *= 2
            continue
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fmt_ms(ms: float | None) -> str:
    return "not measured (cpu)" if ms is None else f"{ms:.4f} ms"
