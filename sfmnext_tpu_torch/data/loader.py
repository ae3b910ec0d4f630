"""Threaded prefetching batch loader (host -> device feed). The port's own
copy of ``sfmnext_tpu/data/loader.py`` (numpy and threads only).

Replaces the reference's ``torch.utils.data.DataLoader(num_workers=8,
pin_memory=True)`` (trainer.py:162-171). Worker threads decode/resize
items (PIL releases the GIL for decode/resize), a collator stacks them,
and a bounded queue keeps batches ready so the card never waits on the
host. Augmentation runs on device (data/augment.py), so host work per
item is decode + one LANCZOS resize.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


def _collate(items):
    out = {}
    for k in items[0]:
        out[k] = np.stack([it[k] for it in items], 0)
    return out


class PrefetchLoader:
    """Iterable over stacked numpy batches with background workers."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 4,
        infinite: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        self.infinite = infinite

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[dict]:
        item_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch * self.batch_size)
        batch_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def index_stream():
            while True:
                for i in self._epoch_indices():
                    yield i
                if not self.infinite:
                    return

        index_iter = iter(index_stream())
        index_lock = threading.Lock()

        n_batches = len(self) if not self.infinite else None

        def put_checked(q, obj) -> bool:
            """put() that never blocks shutdown: polls the stop flag."""
            while not stop.is_set():
                try:
                    q.put(obj, timeout=1)
                    return True
                except queue.Full:
                    continue
            return False

        # ordered slots keep batch composition deterministic enough for
        # testing while letting workers run ahead
        def worker():
            while not stop.is_set():
                with index_lock:
                    try:
                        i = next(index_iter)
                    except StopIteration:
                        break
                if not put_checked(item_q, self.dataset[i]):
                    break

        workers = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]

        def collator():
            produced = 0
            while n_batches is None or produced < n_batches:
                items = []
                while len(items) < self.batch_size:
                    try:
                        items.append(item_q.get(timeout=5))
                    except queue.Empty:
                        if stop.is_set():
                            return
                        if (
                            not any(w.is_alive() for w in workers)
                            and item_q.empty()
                        ):
                            # true end of data (finite epoch exhausted)
                            if items and not self.drop_last:
                                put_checked(batch_q, _collate(items))
                            put_checked(batch_q, None)
                            return
                        # slow storage: keep waiting — never silently
                        # truncate the epoch
                        continue
                if not put_checked(batch_q, _collate(items)):
                    return
                produced += 1
            put_checked(batch_q, None)  # sentinel

        col = threading.Thread(target=collator, daemon=True)
        for w in workers:
            w.start()
        col.start()

        try:
            while True:
                batch = batch_q.get()
                if batch is None:
                    break
                yield batch
        finally:
            stop.set()
