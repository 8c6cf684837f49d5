"""Host-side data loader: shuffling, threaded decode, batch collation.

Counterpart of ``dmtpu/data/loader.py``, carried over as it is, so that the
torch CLI sees at every step the very batch the JAX CLI sees: numpy batches
(images HWC, as the datasets give them), a thread pool that decodes a
batch's items, a bounded queue with a stop event, a producer's error raised
in the consumer, and per-host striping with wrap-around padding (torch
``DistributedSampler`` semantics).  The caller moves a batch to the card
(pinned memory, ``non_blocking=True``).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator

import numpy as np


def _collate(items) -> Any:
    first = items[0]
    if isinstance(first, tuple):
        return tuple(np.stack([it[i] for it in items]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: np.stack([it[k] for it in items]) for k in first}
    return np.stack(items)


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, num_workers: int = 4, prefetch: int = 4, num_shards: int = 1,
                 shard_index: int = 0, **_):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(0, num_workers)
        self.prefetch = prefetch
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState((self.seed + self.epoch) % (2 ** 31))
            rng.shuffle(idx)
        # stripe across hosts, padded by wrap-around first so that every
        # shard gets the same number of batches (uneven shards would deadlock
        # lockstep multi-host training)
        if self.num_shards > 1:
            per = -(-n // self.num_shards)
            idx = np.resize(idx, per * self.num_shards)
            idx = idx[self.shard_index::self.num_shards]
        if self.drop_last:
            idx = idx[: (len(idx) // self.batch_size) * self.batch_size]
        return idx

    def __len__(self):
        n = len(self.dataset)
        per = -(-n // self.num_shards) if self.num_shards > 1 else n
        if self.drop_last:
            return per // self.batch_size
        return -(-per // self.batch_size)

    def __iter__(self) -> Iterator[Any]:
        idx = self._epoch_indices()
        self.epoch += 1
        batches = [idx[i:i + self.batch_size] for i in range(0, len(idx), self.batch_size)]

        if self.num_workers == 0:
            for b in batches:
                yield _collate([self.dataset[int(i)] for i in b])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that `stop` interrupts: a consumer that abandons
            # the iterator mid-epoch must not leave the producer blocked
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            break
                        items = list(pool.map(lambda i: self.dataset[int(i)], b))
                        if not put(_collate(items)):
                            return
                put(None)
            except Exception as e:  # noqa: BLE001 - handed to the consumer, raised there
                put(e)

        thread = threading.Thread(target=producer, name="DataLoader-producer", daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
