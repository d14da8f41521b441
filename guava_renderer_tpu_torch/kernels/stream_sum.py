"""T3: the contiguous block stream of the payload-sort probe
(`tools/sort_payload_bench.py`): an (M, 128) f32 table summed over its rows
into (1, 128), read in 512-row blocks.

For CUDA tensors `stream_sum` launches `csrc/stream_sum.cu`; for CPU tensors
it runs `stream_sum_plain`; nothing else.
"""

from __future__ import annotations

import torch

from . import build

BLOCK = 512        # rows a block, as the JAX tool's
launches = 0       # T3 kernel launches so far in this process


def stream_sum_plain(table: torch.Tensor) -> torch.Tensor:
    """table (M, 128) f32, M a multiple of 512 -> (1, 128): each block's
    column sums, then the blocks' sums."""
    return table.reshape(-1, BLOCK, 128).sum(1).sum(0, keepdim=True)


def stream_sum(table: torch.Tensor) -> torch.Tensor:
    """table (M, 128) f32, M a multiple of 512 -> (1, 128) f32 column sums."""
    global launches
    if table.dim() != 2 or table.shape[1] != 128 or table.dtype != torch.float32 \
            or table.shape[0] % BLOCK:
        raise ValueError(f"table must be (M, 128) float32 with M a multiple of {BLOCK}, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if table.device.type == "cpu":
        return stream_sum_plain(table)
    if table.device.type != "cuda" or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous CPU or CUDA tensor, got {table.device}")
    n_ctas = max(1, min(table.shape[0] // BLOCK,
                        torch.cuda.get_device_properties(table.device).multi_processor_count))
    partials = torch.empty((n_ctas, 128), dtype=torch.float32, device=table.device)
    out = torch.empty((1, 128), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().guava_stream_sum(table.data_ptr(), partials.data_ptr(),
                                               out.data_ptr(), table.shape[0], n_ctas, stream)
    build.check(err, "guava_stream_sum")
    launches += 1
    return out
