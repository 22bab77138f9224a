"""Batched, sharded, prefetching data loader (copy of
``aero_tpu/data/loader.py``).

- train: a permutation per epoch from ``default_rng(seed + epoch)``, the
  same on every rank, padded to a multiple of the world size and strided
  across ranks (DistributedSampler semantics);
- eval: unpadded strided ``range(rank, N, world)`` sharding, batch 1;
- a thread pool decodes the next batches while the device runs the
  current step.
"""

from __future__ import annotations

import collections
import typing as tp
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _stack(items):
    if isinstance(items[0], tuple):
        return tuple(_stack([it[i] for it in items])
                     for i in range(len(items[0])))
    if isinstance(items[0], np.ndarray):
        return np.stack(items, axis=0)
    return list(items)


class Loader:
    """Iterable over batches of a map-style dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, rank: int = 0,
                 world_size: int = 1, num_workers: int = 2,
                 pad_shards: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.rank = rank
        self.world_size = world_size
        self.num_workers = max(0, num_workers)
        self.pad_shards = pad_shards
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        if self.world_size > 1:
            if self.pad_shards:
                total = -(-n // self.world_size) * self.world_size
                if total > n:
                    order = np.concatenate([order, order[: total - n]])
            order = order[self.rank::self.world_size]
        return order

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self) -> tp.Iterator[np.ndarray]:
        idx = self._indices()
        for b in range(len(self)):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]

    def _build(self, batch_idx):
        return _stack([self.dataset[int(i)] for i in batch_idx])

    def __iter__(self):
        if self.num_workers == 0:
            for batch_idx in self._batches():
                yield self._build(batch_idx)
            return
        # ``num_workers`` threads build batches ahead, yielded in order,
        # with a bounded window of batches in flight
        window = self.num_workers + 2
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = collections.deque()
            try:
                for batch_idx in self._batches():
                    pending.append(pool.submit(self._build, batch_idx))
                    if len(pending) >= window:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()
