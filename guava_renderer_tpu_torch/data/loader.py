"""Batching + background prefetch loader (counterpart of
`guava_renderer_tpu/data/loader.py`).

Replaces torch DataLoader + DistributedSampler (ref: main/train.py:44-58,
main/trainer.py:52-58): per-host shard selection, shuffled epoch order,
numpy collation, and a background thread that keeps `prefetch` batches
ready so host decode overlaps device compute. With `rank` and
`world_size`, every rank draws the same epoch order from the same seed and
loads only its contiguous slice [r·B/n, (r+1)·B/n) of each global batch of B
(the 'data' sharding of the JAX package's mesh); `host_id`/`num_hosts` is
the separate multi-host stride over the epoch. With `pin_memory` (and a
CUDA device present) the producer also turns each batch into pinned
tensors, so `to_device` queues its copies without waiting on them.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..utils.logging_utils import span


def collate(records: list[dict]) -> dict:
    """Stack a list of nested dicts of numpy arrays along a new batch axis."""
    def stack(items):
        first = items[0]
        if isinstance(first, dict):
            return {k: stack([it[k] for it in items]) for k in first}
        return np.stack([np.asarray(it) for it in items])

    return stack(records)


def _host_tensors(tree, pin: bool):
    """numpy leaves -> CPU tensors with the dtypes of `testing.tree_to_torch`
    (floats as float32, ints kept), pinned when asked."""
    if isinstance(tree, dict):
        return {k: _host_tensors(v, pin) for k, v in tree.items()}
    a = np.asarray(tree)
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32) if a.dtype.kind == "f" else a)
    return t.pin_memory() if pin else t


def to_device(batch, device) -> dict:
    """A collated batch (numpy leaves, or tensors from a pinning loader) ->
    the nested dict of tensors on `device` that `train/pipeline.py:
    forward_pipeline` takes; copies from pinned memory are queued with
    non_blocking=True."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    t = batch if isinstance(batch, torch.Tensor) else _host_tensors(batch, False)
    return t.to(device, non_blocking=t.is_pinned())


class PrefetchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        host_id: int = 0,
        num_hosts: int = 1,
        drop_last: bool = True,
        pin_memory: bool = False,
        rank: int = 0,
        world_size: int = 1,
    ):
        if batch_size % world_size:
            raise ValueError(f"batch_size {batch_size} does not split over {world_size} ranks")
        if world_size > 1 and not drop_last:
            raise ValueError("a loader split over ranks drops the last partial batch")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.drop_last = drop_last
        self.pin_memory = pin_memory and torch.cuda.is_available()
        self.rank = rank
        self.world_size = world_size
        self._epoch = 0

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        # per-host shard (DistributedSampler role)
        return idx[self.host_id :: self.num_hosts]

    def load_batch(self, sel) -> dict:
        """One batch of the given dataset indices, as the producer makes it."""
        batch = collate([self.dataset[int(i)] for i in sel])
        return _host_tensors(batch, True) if self.pin_memory else batch

    def __iter__(self):
        idx = self._epoch_indices()
        self._epoch += 1
        n_batches = len(idx) // self.batch_size
        if not self.drop_last and len(idx) % self.batch_size:
            n_batches += 1
        k = self.batch_size // self.world_size
        mine = slice(self.rank * k, (self.rank + 1) * k)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            try:
                for b in range(n_batches):
                    sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
                    q.put(self.load_batch(sel[mine] if self.world_size > 1 else sel))
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            with span("guava.loader.wait"):
                item = q.get()
            if item is stop:
                break
            yield item

    def __len__(self):
        return len(self._epoch_indices()) // self.batch_size


def endless(loader: PrefetchLoader):
    """Infinite iterator (the reference's retry-on-StopIteration loop,
    ref: main/trainer.py:73-78)."""
    while True:
        yield from loader


class DeviceBatches:
    """Re-iterable view of a loader whose batches arrive on `device`; `last`
    is the batch it handed out last."""

    def __init__(self, loader, device):
        self.loader = loader
        self.device = device
        self.last = None

    def __iter__(self):
        for batch in self.loader:
            with span("guava.loader.to_device"):
                self.last = to_device(batch, self.device)
            yield self.last
