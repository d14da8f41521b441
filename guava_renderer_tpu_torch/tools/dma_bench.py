"""Row-gather copy rates (counterpart of tools/dma_bench.py).

The forward blend gathers one table row per instance. This bench isolates
that gather: per chunk of 32 instances each variant copies the chunk's rows
into shared memory (`kernels/rowcopy.py`, `csrc/dma_bench.cu`) and reads one
value of them:

  contig           one copy of 32 contiguous rows (the lower bound)
  rows             one bulk copy a row, on `banks` barriers (name:banks)
  rows_pipe        rows, two chunks in flight
  contig_pipe      contig, two chunks in flight
  rows_pipe_bf16   rows_pipe on 256-byte bf16 rows
  rows_pipe_2rows  one copy per two rows (half the copies, the same bytes)

    python -m guava_renderer_tpu_torch.tools.dma_bench [--device cuda] [--rows 262144]

Each prints ms, ns/row and GB/s against the card's 3.35 TB/s (CUDA events,
median of --iters, of the copies alone: the in-order sum that makes the
(1, 1) result exact is left out of the time), and the (1, 1) result. GB/s
counts every staged row; contig stages 32,768 distinct rows (16.8 MB, which
the H100's L2 holds), so it can pass the memory's rate.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.rowcopy import G, row_copy, variant_table
from . import HBM_BYTES_PER_S, device_ms, fmt_ms


def build(rows: int, p_rows: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX tool's data from default_rng(0): table (p_rows, 128) f32 and
    idx2d (M, 128) i32 whose first `rows` entries are the row ids."""
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.uniform(0, 1, (p_rows, 128)).astype(np.float32), device=device)
    # -2: the rows_pipe_2rows variant reads (idx, idx+1) pairs
    idx = rng.integers(0, p_rows - 2, rows).astype(np.int32)
    M = -(-rows // 128) + 2
    idx2d = np.zeros((M, 128), np.int32)
    idx2d.reshape(-1)[:rows] = idx
    return table, torch.as_tensor(idx2d, device=device)


# the rows the contig variants read: 1024 chunk starts of G rows, 16.8 MB of f32
# rows, which the H100's 50 MB L2 holds
HOT_ROWS = 1024 * G


def yardstick_ids(rows: int, p_rows: int, device, seed: int = 1) -> dict[str, torch.Tensor]:
    """Row ids (rows,) i32 of the two yardsticks that the `rows` variant
    reads: `perm`, the first `rows` of a seeded permutation of the table's
    rows (at rows = p_rows every row once: each staged byte comes from
    memory once), and `hot`, uniform over the first HOT_ROWS rows (the rows
    stay in L2 after their first read, as the contig variants' do)."""
    if rows > p_rows:
        raise ValueError(f"a permutation of {p_rows} rows has no {rows} distinct rows")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(p_rows)[:rows]
    hot = rng.integers(0, min(HOT_ROWS, p_rows), rows)
    return {k: torch.as_tensor(v.astype(np.int32), device=device)
            for k, v in (("perm", perm), ("hot", hot))}


def parse_variants(spec: str) -> list[tuple[str, int]]:
    return [(v.split(":")[0], int(v.split(":")[1])) for v in spec.split(",") if v]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=262144)
    ap.add_argument("--p-rows", type=int, default=262144)
    ap.add_argument("--variants",
                    default="rows_pipe:1,rows_pipe_bf16:1,rows_pipe_2rows:1,contig_pipe:1",
                    help="comma list of name:banks")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    table, idx2d = build(args.rows, args.p_rows, dev)
    idx = idx2d.reshape(-1)
    results = []
    for name, banks in parse_variants(args.variants):
        t = variant_table(table, name)
        out, _ = row_copy(t, idx, name, banks, args.rows)
        ms = device_ms(lambda: row_copy(t, idx, name, banks, args.rows, total=False), dev,
                       args.iters)
        row_bytes = t.element_size() * 128
        res = {"name": name, "banks": banks, "rows": args.rows, "p_rows": args.p_rows,
               "row_bytes": row_bytes, "value": float(out[0, 0]), "ms": ms, "ns_row": None,
               "gbps": None}
        rate = ""
        if ms is not None:
            res["ns_row"] = ms * 1e6 / args.rows
            res["gbps"] = args.rows * row_bytes / (ms * 1e-3) / 1e9
            rate = (f"  {res['ns_row']:.4f} ns/row  {res['gbps']:.1f} GB/s "
                    f"({res['gbps'] * 1e9 / HBM_BYTES_PER_S:.1%} of 3.35 TB/s)")
        results.append(res)
        print(f"[{name:15s} banks={banks}] chunks={args.rows // G} rows of {row_bytes} B: "
              f"steady={fmt_ms(ms)}{rate}  out={res['value']:.6f}", flush=True)
    return results


if __name__ == "__main__":
    main()
