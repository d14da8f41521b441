"""Process groups for the multi-device paths (counterpart of
`guava_renderer_tpu/parallel/mesh.py`).

The JAX package runs one program over a mesh of devices with a 'data' axis:
batch sharded, parameters replicated, gradients pmean'd. The port runs one
process per device under torch.distributed (NCCL between cards, gloo on the
CPU): `launch` starts the ranks and runs a function on each with its
`Group`; `shard_batch` gives rank r its contiguous slice of a global batch,
as `NamedSharding(P("data"))` gives device r; `replicate` broadcasts a
module's parameters and buffers from rank 0. The collectives the paths use
are here too: a mean by all-reduce, a gather along an axis and an object
broadcast.

Ranks meet through a `file://` store in a fresh temporary directory, never a
fixed TCP port, so several launches can run side by side. Every rank goes
through `device.resolve_device` (TF32 off on the card); a CPU rank computes
on one thread.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

TIMEOUT = datetime.timedelta(seconds=1800)      # a collective that waits longer fails


@dataclasses.dataclass(frozen=True)
class Group:
    rank: int
    size: int
    device: torch.device
    backend: str


_current: Group | None = None


def current_group() -> Group | None:
    """The group this process belongs to (`init_group`, `launch`), or None."""
    return _current


def init_group(rank: int, size: int, device, init_file: str,
               backend: str | None = None) -> Group:
    """Join the default process group as `rank` of `size`, on `device`
    (NCCL on a card, gloo on the CPU, unless `backend` names one), meeting
    the other ranks at the file `init_file`. -> this process's Group."""
    global _current
    if _current is not None:
        raise RuntimeError(f"this process is already rank {_current.rank} of a group")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=size, timeout=TIMEOUT)
    _current = Group(rank, size, dev, backend)
    return _current


def close_group() -> None:
    """Leave the default process group."""
    global _current
    if dist.is_initialized():
        dist.destroy_process_group()
    _current = None


def _rank_main(rank, size, fn, args, devices, backend, init_file, out_dir):
    dev = devices[rank]
    if dev.type == "cpu":
        torch.set_num_threads(1)
    group = init_group(rank, size, dev, init_file, backend)
    try:
        result = fn(group, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        close_group()


def launch(n: int, fn, *args, device="cuda", backend: str | None = None,
           devices: list | None = None) -> list:
    """Run `fn(group, *args)` on `n` ranks, one spawned process each, and
    return the ranks' results in rank order (each saved by torch.save in its
    rank and loaded here onto the CPU).

    Rank r runs on `devices[r]`, by default `cuda:r` for `device="cuda"` and
    the CPU for `device="cpu"`. `fn` and `args` are pickled, so `fn` is a
    module-level function. A rank that raises ends the launch with its
    error, and the other ranks are stopped."""
    import torch.multiprocessing as mp

    if devices is None:
        kind = torch.device(device).type
        devices = [torch.device("cuda", r) if kind == "cuda" else torch.device("cpu")
                   for r in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    for d in devices:                  # fail here, not in n spawned ranks
        resolve_device(d)
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"{n} ranks ask for {d}; {torch.cuda.device_count()} visible")
    work = tempfile.mkdtemp(prefix="guava_group_")
    try:
        mp.start_processes(_rank_main, nprocs=n, start_method="spawn", join=True, args=(
            n, fn, args, devices, backend, os.path.join(work, "rendezvous"), work))
        return [torch.load(os.path.join(work, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -- sharding and replication --------------------------------------------------

def local_slice(n_items: int, group: Group) -> slice:
    """Rank r's contiguous share [r·B/n, (r+1)·B/n) of B items; B must divide."""
    if n_items % group.size:
        raise ValueError(f"a batch of {n_items} does not split over {group.size} ranks")
    k = n_items // group.size
    return slice(group.rank * k, (group.rank + 1) * k)


def shard_batch(batch, group: Group):
    """Rank r's contiguous slice of every array of a nested global batch
    (tensors and numpy arrays with a leading batch axis; scalars pass)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, group) for k, v in batch.items()}
    if isinstance(batch, (torch.Tensor, np.ndarray)) and batch.ndim > 0:
        return batch[local_slice(batch.shape[0], group)]
    return batch


def _flat_apply(tensors: list[torch.Tensor], op) -> None:
    """op(flat) on one flat copy of the tensors a dtype, written back in place."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = op(torch.cat([t.reshape(-1) for t in ts]))
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def replicate(module: torch.nn.Module, group: Group) -> torch.nn.Module:
    """Broadcast every parameter and buffer of `module` from rank 0, in
    place (one broadcast a dtype). -> the module."""
    def bcast(flat):
        dist.broadcast(flat, src=0)
        return flat

    _flat_apply([t.data for t in (*module.parameters(), *module.buffers())], bcast)
    return module


# -- collectives ---------------------------------------------------------------

def all_reduce_mean_(tensors: list[torch.Tensor], group: Group) -> None:
    """Replace each tensor by its mean over the ranks, in place (one
    all-reduce a dtype; the sum, then / n, as `jax.lax.pmean`)."""
    def mean(flat):
        dist.all_reduce(flat)
        return flat / group.size

    _flat_apply(tensors, mean)


def all_gather_cat(t: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` (the same shape on each), concatenated along `dim`
    in rank order."""
    parts = [torch.empty_like(t) for _ in range(group.size)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=dim)


def broadcast_object(obj, group: Group):
    """Rank 0's picklable `obj` on every rank (tensors in it travel as they
    are: move them to the CPU first)."""
    box = [obj if group.rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(group: Group) -> None:
    dist.barrier()
