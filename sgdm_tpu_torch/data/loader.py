"""Host-side data loading: a map-style DataLoader with background prefetch.

The port's copy of `sgdm_tpu/data/loader.py`, with the same semantics:
shuffle from ``seed + epoch``, ``drop_last``, ``__iter__`` advancing the
epoch after it builds the order, a thread pool loading batches ahead into a
bounded queue (the next batch's samples queued on the pool before the
current one is collated), a producer that stops when the consumer breaks early, and
datasets with ``get_batch`` assembling whole batches.  ``batch_size`` is
the global batch; across ranks each rank passes its ``shard``
(`parallel.mesh.local_batch_slice`) and loads and collates only those rows
of every global batch, in the order every rank builds alike.

`prefetch_to_device` is the torch counterpart of the JAX device put: every
array is copied into pinned host memory and sent with ``non_blocking=True``
(`to_device`), `size` batches ahead of the consumer.

Datasets are any objects with `__len__` and `__getitem__(i) -> dict[str,
np.ndarray]`.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Mapping, Protocol, Sequence

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["MapDataset", "DataLoader", "prefetch_to_device", "to_device"]


class MapDataset(Protocol):
    def __len__(self) -> int: ...

    def __getitem__(self, index: int) -> Mapping[str, Any]: ...


def _collate(samples: Sequence[Mapping[str, Any]]) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = np.stack([np.asarray(v) for v in vals], axis=0)
    return out


class DataLoader:
    """Minimal map-style loader: shuffle / batch / drop_last / prefetch."""

    def __init__(
        self,
        dataset: MapDataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = True,
        num_workers: int = 8,
        seed: int = 23,
        collate_fn: Callable | None = None,
        prefetch_batches: int = 4,
        shard: slice | None = None,
    ):
        """``shard``: this rank's rows of each global batch (None: all);
        `__len__` stays the global step count, so ranks run in lockstep."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.collate_fn = collate_fn or _collate
        self.prefetch_batches = prefetch_batches
        self.shard = shard
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self) -> list[np.ndarray]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(len(self))]
        return batches if self.shard is None else [b[self.shard] for b in batches]

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        batches = self._index_batches()
        self._epoch += 1
        if not batches:
            return
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        # datasets with `get_batch` assemble a whole batch in one call
        batch_level = hasattr(self.dataset, "get_batch") and self.collate_fn is _collate

        def submit(batch_idx: np.ndarray) -> list:
            return [pool.submit(self.dataset.__getitem__, i) for i in batch_idx.tolist()]

        def load_batches() -> Iterator[dict[str, np.ndarray]]:
            if batch_level:
                for b in batches:
                    yield self.dataset.get_batch(b)
                return
            # the next batch's samples are queued on the pool before this
            # one is collated, so the pool does not idle while it is
            pending = submit(batches[0])
            for k in range(len(batches)):
                if stop.is_set():
                    return
                nxt = submit(batches[k + 1]) if k + 1 < len(batches) else None
                yield self.collate_fn([f.result() for f in pending])
                pending = nxt

        def put_or_stop(item) -> bool:
            """A bounded put that gives up once the consumer has left: a plain
            put on a full queue would block this thread for ever after an
            early break (limit_train_batches), pinning prefetched batches."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                for batch in load_batches():
                    if stop.is_set() or not put_or_stop(batch):
                        return
            except BaseException as e:  # handed to the consumer, which raises it
                put_or_stop(e)
            finally:
                put_or_stop(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)


def to_device(arrays: Mapping[str, Any], device: torch.device) -> dict[str, torch.Tensor]:
    """Each array as a tensor on ``device``.  On the card: copied into pinned
    host memory and sent with ``non_blocking=True``.  The pinned block is
    safe to drop at once: PyTorch's pinned-memory allocator records an event
    on the copy's stream and reuses the block only after it completes."""
    if device.type != "cuda":
        return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in arrays.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(device, non_blocking=True)
            for k, v in arrays.items()}


def prefetch_to_device(it: Iterator[Mapping[str, np.ndarray]], size: int = 2,
                       device: str | torch.device = "cuda") -> Iterator[dict[str, torch.Tensor]]:
    """Batches moved to ``device`` ``size`` ahead of the consumer
    (double-buffering the host→device copies)."""
    dev = resolve_device(device)
    buf: deque = deque()
    for batch in it:
        buf.append(to_device(batch, dev))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
