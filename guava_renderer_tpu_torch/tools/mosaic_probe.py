"""Copy probes (counterpart of tools/mosaic_probe.py).

Each probe copies an index slice or table rows at an offset given at run
time into shared memory and writes what landed back out
(`kernels/copy_probe.py`, `csrc/copy_probe.cu`): idx32, idx1024, idx2d,
row1, row1_loop, row8, row64, with the JAX probes' shapes and dtypes. The
JAX tool only compiles its probes, to learn which DMA shapes Mosaic takes;
these compile and run, and say which copy the card took: the bulk copy
engine where offsets and sizes are multiples of 16 bytes, else 4-byte
cp.async. One line a probe:

    EXP <name> OK route=<bulk|async4> err=<max abs vs plain> launches=<n> ms=<ms> plain_ms=<ms>
        library_ms=<ms> bytes=<B> library_bytes=<B> floor_ms=<ms>
    EXP <name> FAIL <reason>

(on one line; library_ms is one PyTorch call that writes the same values,
`library_call`, timed in turns with the probe; bytes and library_bytes are
what each must move, `moved_bytes`; floor_ms is the launch floor, one
near-empty kernel, `torch.cuda._sleep(1)`, timed in the same turns, so that
a time splits into launch and copy).

Each probe runs in a subprocess of its own, since a copy that faults
poisons the process's CUDA context, and the subprocesses run one after
another: a probe timed while other processes hold the card is timed on a
card that time-slices between their contexts. --unaligned moves the index
slices' starts off a 16-byte boundary (the async4 route).

    python -m guava_renderer_tpu_torch.tools.mosaic_probe [--device cuda] [--exp NAME]
"""

from __future__ import annotations

import argparse
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from ..device import resolve_device
from ..kernels import build
from ..kernels.copy_probe import (LOOP_ROWS, PROBES, SOURCES, copy_probe, copy_probe_plain, plan,
                                  route)
from . import device_ms

ROOT = Path(__file__).resolve().parents[2]
# each probe's start or index; --unaligned adds 1 (index slices then start off 16 bytes)
OFFSETS = {"idx32": 4096, "idx1024": 8192, "idx2d": 1000, "row1": 123457, "row8": 123457,
           "row64": 123457}


def probe_inputs(name: str, device, unaligned: bool = False):
    """(src, at): the probe's source, every element distinct where the dtype
    allows, and its offset (row1_loop: 32 row ids)."""
    shape, dtype = SOURCES[name]
    n = 1
    for d in shape:
        n *= d
    src = (torch.arange(n, device=device) % 16_777_213).to(dtype).reshape(shape)
    if name == "row1_loop":
        at = (torch.arange(LOOP_ROWS, device=device, dtype=torch.int64) * 9_371 + 17) % shape[0]
        return src, at.to(torch.int32)
    return src, OFFSETS[name] + int(unaligned)


def library_call(name: str, src: torch.Tensor, at):
    """A function of no arguments making one PyTorch call that writes what
    the probe writes (flattened for the index probes): `narrow_copy` of the
    element or row, `index_select` of row1_loop's rows."""
    if name == "row1_loop":
        ids = at.long()
        return lambda: torch.index_select(src, 0, ids)
    at = int(at)
    if name == "idx2d":           # order.flat[p + 31], the flat element it reads
        flat = src.reshape(-1)
        return lambda: flat.narrow_copy(0, at + 31, 1)
    first = at // 8 * 8 if name == "row8" else at
    return lambda: src.narrow_copy(0, first, 1)


def moved_bytes(name: str, at) -> tuple[int, int]:
    """(probe, library call): the bytes each must move. The probe reads its
    copied segments (and row1_loop its 32 int32 ids) and writes its output;
    the library call reads and writes the output's bytes (index_select also
    reads its 32 int64 ids)."""
    c = plan(name, at)
    out = 4 * math.prod(c.out_shape)
    if c.ids is not None:
        return c.n_seg * c.seg_bytes + 4 * c.n_seg + out, 2 * out + 8 * c.n_seg
    return c.n_seg * c.seg_bytes + out, 2 * out


def launch_floor() -> None:
    """One near-empty kernel: the device time of a launch that does no work."""
    torch.cuda._sleep(1)


def run_probe(name: str, device, unaligned: bool = False, iters: int = 20) -> dict:
    """One probe in this process: kernel against plain version, and times;
    the probe, its library call and the launch floor in turns (probe,
    library, floor, floor, library, probe, twice; medians), so that drift
    favours none."""
    src, at = probe_inputs(name, device, unaligned)
    got = copy_probe(name, src, at)
    want = copy_probe_plain(name, src, at)
    lib = library_call(name, src, at)
    if not torch.equal(lib().reshape(want.shape), want):
        raise ValueError(f"{name}: the library call writes other values than the plain version")
    err = float((got.double() - want.double()).abs().max())
    res = {"name": name, "route": route(name, at), "err": err,
           "equal": bool(torch.equal(got, want))}
    res["bytes"], res["library_bytes"] = moved_bytes(name, at)
    probe = (("ms", lambda: copy_probe(name, src, at)), ("library_ms", lib),
             ("floor_ms", launch_floor))
    turns = {key: [] for key, _ in probe}
    for _ in range(2):
        for key, fn in probe + probe[::-1]:
            turns[key].append(device_ms(fn, device, iters))
    for key, times in turns.items():
        res[key] = None if None in times else statistics.median(times)
    res["plain_ms"] = device_ms(lambda: copy_probe_plain(name, src, at).clone(), device, iters)
    return res


def _child(name: str, device: str, unaligned: bool, iters: int) -> int:
    from ..kernels import copy_probe as kcp

    try:
        r = run_probe(name, resolve_device(device), unaligned, iters)
    except Exception as e:  # noqa: BLE001 -- the line reports any failure of the probe
        first = (str(e).splitlines() or [type(e).__name__])[0]
        print(f"EXP {name} FAIL {first[:300]}", flush=True)
        return 1
    if not r["equal"]:
        print(f"EXP {name} FAIL differs from its plain version: max abs {r['err']}", flush=True)
        return 1
    print(f"EXP {name} OK route={r['route']} err={r['err']:g} launches={kcp.launches} "
          f"ms={r['ms']} plain_ms={r['plain_ms']} library_ms={r['library_ms']} "
          f"bytes={r['bytes']} library_bytes={r['library_bytes']} floor_ms={r['floor_ms']}",
          flush=True)
    return 0


def parse_line(line: str) -> dict:
    """An `EXP` line -> {name, ok, route, err, launches, ms, plain_ms, library_ms, bytes,
    library_bytes, floor_ms} (or reason)."""
    parts = line.split()
    res = {"name": parts[1], "ok": parts[2] == "OK"}
    if not res["ok"]:
        res["reason"] = " ".join(parts[3:])
        return res
    for kv in parts[3:]:
        k, v = kv.split("=", 1)
        res[k] = v if k == "route" else (None if v == "None" else float(v))
    for k in ("launches", "bytes", "library_bytes"):
        res[k] = int(res[k])
    return res


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--exp", default=None,
                    help=f"comma list of probes (default: all of {', '.join(PROBES)})")
    ap.add_argument("--unaligned", action="store_true",
                    help="start the index slices off a 16-byte boundary")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.child:
        sys.exit(_child(args.child, args.device, args.unaligned, args.iters))
    if dev.type == "cuda":
        build.library()        # build once, before the probes load it

    names = args.exp.split(",") if args.exp else list(PROBES)
    unknown = set(names) - set(PROBES)
    if unknown:
        ap.error(f"unknown probes {sorted(unknown)}; choose from {PROBES}")
    flags = ["--device", args.device, "--iters", str(args.iters)] + \
        (["--unaligned"] if args.unaligned else [])
    # one subprocess a probe, so that a faulting copy cannot sink the rest, one at a time, so
    # that each is timed alone on the card
    results = []
    for name in names:
        p = subprocess.Popen(
            [sys.executable, "-m", "guava_renderer_tpu_torch.tools.mosaic_probe", "--child", name,
             *flags], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith("EXP ")]
        if lines:
            line = lines[-1]
        else:
            tail = (err or out).strip().splitlines()
            line = f"EXP {name} FAIL crashed (exit {p.returncode}): {tail[-1][:200] if tail else ''}"
        print(line, flush=True)
        results.append(parse_line(line))
    return results


if __name__ == "__main__":
    main()
