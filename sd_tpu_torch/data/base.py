"""The batch contract and its loader (port of ``Dataset``, ``collate`` and
``DataLoader`` from ``sd_tpu/data/base.py``).

Datasets yield dicts of HWC float32 images in [-1, 1] and other arrays under
string keys; the loader batches them with :func:`collate`, dropping the
last partial batch. The shuffle is a function of ``seed + epoch`` alone, so a
run resumed at (epoch, position) sees the batches of an uninterrupted one. A
background thread prefetches two batches. Sharding across processes waits
for data parallelism.
"""

from __future__ import annotations

import abc
import queue
import threading
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["Dataset", "DataLoader", "collate"]


class Dataset(abc.ABC):
    """Map-style dataset."""

    @abc.abstractmethod
    def __len__(self) -> int: ...

    @abc.abstractmethod
    def __getitem__(self, i: int) -> Dict[str, Any]: ...


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of sample dicts into a batch dict (arrays stacked,
    strings and other objects listed)."""
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], (np.ndarray, np.generic, float, int, bool)):
            out[key] = np.stack([np.asarray(v) for v in vals])
        else:
            out[key] = vals
    return out


class DataLoader:
    """Batching iterator with an epoch-deterministic shuffle and prefetch.
    ``epoch`` counts finished passes; setting it fast-forwards the shuffle."""

    def __init__(self, dataset: Dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def order(self) -> np.ndarray:
        """This epoch's order of the dataset's indices."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def batch(self, b: int, order: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Batch ``b`` of this epoch (of ``order``, where given)."""
        idx = self.order() if order is None else order
        sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
        return collate([self.dataset[int(i)] for i in sel])

    def __iter__(self):
        idx = self.order()
        q: queue.Queue = queue.Queue(maxsize=2)

        def produce():
            for b in range(len(self)):
                q.put(self.batch(b, idx))
            q.put(None)

        threading.Thread(target=produce, daemon=True).start()
        while (item := q.get()) is not None:
            yield item
        self.epoch += 1
