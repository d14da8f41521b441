"""T2: the row-gather bench's copies (`tools/dma_bench.py`). Per chunk of
G = 32 instances a variant copies table rows, reads the first value of the
chunk's first row, and sums those values over the chunks in chunk order.

Variants (the JAX tool's names; rows = G * n_chunks):
  contig          G contiguous rows from row (c*7 mod 1024)*G, a chunk at a time
  rows            rows idx[c*G : c*G + G], a chunk at a time, on `banks`
                  barriers (the JAX tool's rows1 and rowsB<k>)
  rows_pipe       rows, two chunks in flight
  contig_pipe     contig, two chunks in flight
  rows_pipe_bf16  rows_pipe on the table rounded to bf16 (256-byte rows)
  rows_pipe_2rows rows (idx, idx + 1) for every even g, two chunks in flight

For CUDA tensors `row_copy` launches `csrc/dma_bench.cu`; for CPU tensors it
runs `row_copy_plain`; nothing else. Both return the JAX tool's (1, 1)
output and, with check=True, the rows as staged. With total=False the
wrapper runs only the copies and returns no output: the bench times that,
without the in-order sum's chain of dependent adds.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

G = 32
CONTIG, ROWS, PAIRS = 0, 1, 2
# name -> (source, pipelined, table dtype)
VARIANTS = {
    "contig": (CONTIG, False, torch.float32),
    "rows": (ROWS, False, torch.float32),
    "rows_pipe": (ROWS, True, torch.float32),
    "contig_pipe": (CONTIG, True, torch.float32),
    "rows_pipe_bf16": (ROWS, True, torch.bfloat16),
    "rows_pipe_2rows": (PAIRS, True, torch.float32),
}
launches = 0       # T2 kernel launches so far in this process


def variant_table(table: torch.Tensor, name: str) -> torch.Tensor:
    """The (p_rows, 128) table a variant reads: f32, or rounded to bf16 (to
    nearest even, as `.astype(bfloat16)`) for rows_pipe_bf16."""
    return table.to(VARIANTS[name][2]).contiguous()


def staged_ids(name: str, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows,) int64: the table row each staged row of the variant is."""
    source = VARIANTS[name][0]
    n_chunks = rows // G
    g = torch.arange(G, device=idx.device)
    if source == CONTIG:
        start = (torch.arange(n_chunks, device=idx.device) * 7 % 1024) * G
        return (start[:, None] + g).reshape(-1)
    ids = idx[:n_chunks * G].long().reshape(n_chunks, G)
    if source == PAIRS:
        ids = ids[:, g - g % 2] + g % 2
    return ids.reshape(-1)


def _check(table, idx, name, banks, rows):
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; one of {sorted(VARIANTS)}")
    source, _, dtype = VARIANTS[name]
    if table.dim() != 2 or table.shape[1] != 128 or table.dtype != dtype:
        raise ValueError(f"{name} reads a (p_rows, 128) {dtype} table, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if rows % G or rows < 0:
        raise ValueError(f"rows ({rows}) must be a multiple of {G}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or idx.shape[0] < rows:
        raise ValueError(f"idx must be (>= {rows},) int32, got {tuple(idx.shape)} {idx.dtype}")
    if table.device != idx.device or table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"table on {table.device}, idx on {idx.device}")
    if banks < 1 or G % banks:
        raise ValueError(f"banks ({banks}) must divide the chunk of {G} rows")
    n_chunks = rows // G
    if source == CONTIG and n_chunks:
        last = (max((c * 7) % 1024 for c in range(min(n_chunks, 1024))) + 1) * G
        if last > table.shape[0]:
            raise ValueError(f"{name} reads rows up to {last} of a {table.shape[0]}-row table")


def row_copy_plain(table, idx, name, rows, check=False):
    """-> (out (1, 1) f32, staged (rows, 128) or None): out is the sum, one
    f32 add at a time in chunk order, of each chunk's first staged value."""
    _check(table, idx, name, 1, rows)
    ids = staged_ids(name, idx, rows)
    vals = table[ids[::G], 0].float().cpu()
    acc = torch.zeros((), dtype=torch.float32)
    for v in vals:
        acc = acc + v
    out = acc.reshape(1, 1).to(table.device)
    return out, (table[ids] if check else None)


@functools.cache
def occupancy(pipelined: bool) -> dict:
    """Resident CTAs an SM of the kernel with the pipelined variants' ring
    (pipelined) or one slot, and its dynamic shared memory a CTA
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor; fixed by the build, so
    asked once)."""
    ctas, smem = ctypes.c_int(0), ctypes.c_int(0)
    build.check(build.library().guava_row_copy_occupancy(int(pipelined), ctypes.addressof(ctas),
                                                         ctypes.addressof(smem)),
                "guava_row_copy_occupancy")
    return {"ctas_per_sm": ctas.value, "smem_bytes": smem.value}


def grid_ctas(n_chunks: int, sms: int, ctas_per_sm: int) -> int:
    """The persistent grid: as many CTAs as are resident at once, at most
    one a chunk."""
    return max(1, min(n_chunks, sms * ctas_per_sm))


def row_copy(table, idx, name, banks, rows, check=False, total=True):
    """The variant's copies on CUDA tensors (`row_copy_plain` on CPU ones):
    table (p_rows, 128) as `variant_table` gives it, idx (>= rows,) i32 row
    ids in [0, p_rows) ([0, p_rows - 1) for rows_pipe_2rows), `banks`
    barriers a chunk for `rows` (the others use one) -> as `row_copy_plain`,
    with out None when total=False (the copies alone)."""
    global launches
    _check(table, idx, name, banks, rows)
    if table.device.type == "cpu":
        out, staged = row_copy_plain(table, idx, name, rows, check)
        return (out if total else None), staged
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    source, pipelined, _ = VARIANTS[name]
    n_chunks = rows // G
    vals = torch.empty(n_chunks, dtype=torch.float32, device=table.device)
    out = torch.empty((1, 1), dtype=torch.float32, device=table.device) if total else None
    staged = torch.empty((rows, 128), dtype=table.dtype, device=table.device) if check else None
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().guava_row_copy(
            table.data_ptr(), idx.data_ptr(), table.element_size() * 128, source,
            int(pipelined), banks if name == "rows" else 1, n_chunks,
            grid_ctas(n_chunks, sms, occupancy(pipelined)["ctas_per_sm"]), vals.data_ptr(),
            staged.data_ptr() if check else None, out.data_ptr() if total else None, stream)
    build.check(err, "guava_row_copy")
    launches += 1
    return out, staged
