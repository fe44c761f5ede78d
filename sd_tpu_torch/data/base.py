"""The batch contract and its loader (port of ``Dataset``,
``Txt2ImgIterableBaseDataset``, ``collate`` and ``DataLoader`` from
``sd_tpu/data/base.py``).

Datasets yield dicts of HWC float32 images in [-1, 1] and other arrays under
string keys; the loader batches them with :func:`collate`, dropping the
last partial batch. The shuffle is a function of ``seed + epoch`` alone, so a
run resumed at (epoch, position) sees the batches of an uninterrupted one. A
background thread prefetches two batches.

Under data parallelism the loader of rank ``shard_index`` of ``num_shards``
takes ``idx[shard_index::num_shards]`` of the epoch's order, as
``sd_tpu``'s does, so batch b of the N ranks together holds the rows of
batch b of one loader at N times the batch size (rank r its rows r::N).
Every rank yields ``len(self)`` batches (``sd_tpu``'s lower shards may
yield one more where N does not divide the dataset; DDP needs every rank to
take the same number of steps). An iterable dataset is split into
contiguous blocks of its ids instead (:meth:`Txt2ImgIterableBaseDataset.shard`,
the reference's ``worker_init_fn``), whose sizes differ by one where N does
not divide the ids: every rank stops at ``len(self)`` batches there too,
the full batches of the smallest block.
"""

from __future__ import annotations

import abc
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["Dataset", "Txt2ImgIterableBaseDataset", "DataLoader", "collate"]


class Dataset(abc.ABC):
    """Map-style dataset."""

    @abc.abstractmethod
    def __len__(self) -> int: ...

    @abc.abstractmethod
    def __getitem__(self, i: int) -> Dict[str, Any]: ...


class Txt2ImgIterableBaseDataset(abc.ABC):
    """A web-scale stream of text-image records (the reference's
    ``ldm/data/base.py:5-23``): ``num_records`` and the ``valid_ids`` it may
    yield; :meth:`shard` narrows ``sample_ids`` to one worker's or rank's
    contiguous block of them."""

    def __init__(self, num_records: int = 0, valid_ids: Optional[Sequence[int]] = None,
                 size: int = 256):
        self.num_records = num_records
        self.valid_ids = list(valid_ids) if valid_ids is not None else list(range(num_records))
        self.sample_ids = self.valid_ids
        self.size = size
        print(f"{self.__class__.__name__} dataset contains {self.__len__()} examples.")

    def __len__(self) -> int:
        return self.num_records

    def shard(self, worker_id: int, num_workers: int) -> "Txt2ImgIterableBaseDataset":
        self.sample_ids = np.array_split(np.asarray(self.valid_ids),
                                         num_workers)[worker_id].tolist()
        return self

    @abc.abstractmethod
    def __iter__(self) -> Iterator[Dict[str, Any]]: ...


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
    """Batching iterator with an epoch-deterministic shuffle and prefetch,
    over rank ``shard_index``'s shard of ``num_shards`` (module docstring).
    ``epoch`` counts finished passes; setting it fast-forwards the shuffle."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 num_shards: int = 1, shard_index: int = 0):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} of {num_shards}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0

    def __len__(self) -> int:
        n = (len(self.dataset.valid_ids) if isinstance(self.dataset, Txt2ImgIterableBaseDataset)
             else len(self.dataset))
        return n // self.num_shards // self.batch_size

    def order(self) -> np.ndarray:
        """This epoch's order of the dataset's indices, this shard's alone."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx[self.shard_index::self.num_shards]

    def batch(self, b: int, order: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Batch ``b`` of this epoch (of ``order``, where given)."""
        idx = self.order() if order is None else order
        sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
        return collate([self.dataset[int(i)] for i in sel])

    def __iter__(self):
        if isinstance(self.dataset, Txt2ImgIterableBaseDataset):
            yield from self._iter_stream()
            return
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

    def _iter_stream(self):
        """Full batches of this shard's block of an iterable dataset, at
        most ``len(self)``."""
        self.dataset.shard(self.shard_index, self.num_shards)
        buf, left = [], len(self)
        if not left:
            return
        for sample in self.dataset:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield collate(buf)
                buf, left = [], left - 1
                if not left:
                    return
