"""Payload-carrying instance sort and contiguous stream (counterpart of
tools/sort_payload_bench.py).

The blend gathers one row per instance. The alternative is to carry each
Gaussian's payload through the instance sort, so that the blend streams
contiguous rows instead. This tool prices both halves on the card:

  key_gid     (key, gid)                        the sort the binning does
  key_6f      + 6 f32 geometry                  x, y, conic a/b/c, alpha
  key_full    + 6 f32 + 17 i32                  colors and invdepth as bf16 pairs
  key_24f     + 23 f32                          unpacked f32 colors
  presort_pay a P-row sort carrying the same 23 payloads
  stream      (M, 128) f32 read in 512-row blocks (T3, `csrc/stream_sum.cu`)

A sort is `torch.sort(stable=True)` of the keys and a gather of each payload
by the permutation (the JAX tool's `jax.lax.sort` with payload operands).

Decision rule: the payload sort wins if
    sort(key_full) - sort(key_gid) + stream  <  rows x (ns/row of a row gather),
with the row gather's ns/row measured here by T2's rows_pipe
(`tools/dma_bench.py`), not taken from the TPU.

    python -m guava_renderer_tpu_torch.tools.sort_payload_bench [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.rowcopy import row_copy, variant_table
from ..kernels.stream_sum import BLOCK, stream_sum
from . import device_ms, fmt_ms
from .dma_bench import build as gather_data

GATHER_ROWS = 262144   # the T2 rows_pipe measurement behind the decision rule (its default)
# variant -> (rows: "M" or "P", f32 payloads, i32 payloads)
SORTS = {"key_gid": ("M", 0, 0), "key_6f": ("M", 6, 0), "key_full": ("M", 6, 17),
         "key_24f": ("M", 23, 0), "presort_pay": ("P", 23, 1)}


def payload_sort(key: torch.Tensor, *payloads: torch.Tensor):
    """-> (keys ascending, each payload carried with its key); ties keep the input order."""
    key_s, perm = torch.sort(key, stable=True)
    return (key_s, *(p[perm] for p in payloads))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=809984)   # parity M (0.81M)
    ap.add_argument("--p", type=int, default=272384)      # parity P
    ap.add_argument("--variants", default="key_gid,key_6f,key_full,key_24f,presort_pay,stream")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    M, P = args.rows, args.p
    want = set(args.variants.split(","))
    result = {"sorts": {}, "sorted": {}, "stream": None}

    def t(x):
        return torch.as_tensor(x, device=dev)

    for name, (n_of, nf32, ni32) in SORTS.items():
        if name not in want:
            continue
        n = M if n_of == "M" else P
        # the JAX tool's draws, in its order
        key = t(rng.integers(0, 1 << 30, n).astype(np.int32))
        gid = t(rng.integers(0, P, n).astype(np.int32))
        f32s = [t(rng.uniform(0, 1, n).astype(np.float32)) for _ in range(nf32)]
        i32s = [t(rng.integers(0, 1 << 30, n).astype(np.int32)) for _ in range(ni32)]
        out = payload_sort(key, gid, *f32s, *i32s)
        ok = bool((out[0][1:] >= out[0][:-1]).all())
        ms = device_ms(lambda: payload_sort(key, gid, *f32s, *i32s), dev, args.iters)
        result["sorts"][name], result["sorted"][name] = ms, ok
        print(f"[{name:12s}] n={n} payloads={1 + nf32 + ni32}: steady={fmt_ms(ms)} "
              f"sorted={ok}", flush=True)
        del key, gid, f32s, i32s, out

    if "stream" in want:
        nblk = M // BLOCK
        table = t(rng.uniform(0, 1, (nblk * BLOCK, 128)).astype(np.float32))
        out = stream_sum(table)
        ms = device_ms(lambda: stream_sum(table), dev, args.iters)
        nb = table.numel() * 4
        result["stream"] = {"ms": ms, "bytes": nb, "checksum": float(out.sum()),
                            "table": table, "out": out}
        rate = "" if ms is None else (f" -> {nb / (ms * 1e-3) / 1e9:.0f} GB/s "
                                      f"({ms * 1e6 / (nblk * BLOCK):.4f} ns/row)")
        print(f"[stream      ] {nb / 1e6:.1f} MB: steady={fmt_ms(ms)}{rate} "
              f"checksum={result['stream']['checksum']:.1f}", flush=True)

    have = all(result["sorts"].get(k) is not None for k in ("key_full", "key_gid")) \
        and result["stream"] is not None and result["stream"]["ms"] is not None
    if have:
        tab, idx2d = gather_data(GATHER_ROWS, GATHER_ROWS, dev)
        idx = idx2d.reshape(-1)
        tab = variant_table(tab, "rows_pipe")
        g_ms = device_ms(lambda: row_copy(tab, idx, "rows_pipe", 1, GATHER_ROWS, total=False),
                         dev, args.iters)
        ns_row = g_ms * 1e6 / GATHER_ROWS
        lhs = result["sorts"]["key_full"] - result["sorts"]["key_gid"] + result["stream"]["ms"]
        rhs = M * ns_row * 1e-6
        result["decision"] = {"payload_ms": lhs, "gather_ms": rhs, "gather_ns_row": ns_row}
        print(f"[decision    ] sort(key_full) - sort(key_gid) + stream = {lhs:.4f} ms vs "
              f"rows x {ns_row:.4f} ns/row (T2 rows_pipe here) = {rhs:.4f} ms: the payload "
              f"sort {'wins' if lhs < rhs else 'loses'}", flush=True)
    else:
        print("[decision    ] not measured (needs key_full, key_gid and stream timed on a "
              "card)", flush=True)
    return result


if __name__ == "__main__":
    main()
