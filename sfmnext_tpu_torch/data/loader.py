"""Threaded prefetching batch loader (host -> device feed). The port's own
copy of ``sfmnext_tpu/data/loader.py`` (numpy and threads only).

Replaces the reference's ``torch.utils.data.DataLoader(num_workers=8,
pin_memory=True)`` (trainer.py:162-171). Worker threads decode/resize
items (PIL releases the GIL for decode/resize), a collator stacks them,
and a bounded queue keeps batches ready so the card never waits on the
host. Augmentation runs on device (data/augment.py), so host work per
item is decode + one LANCZOS resize.

Unlike the JAX copy, items reach the batches in the order of their
indices whatever the number of workers, as the reference's DataLoader
delivers them (evaluation pairs the i-th prediction with the i-th
ground-truth map), and an exception the dataset raises is raised again
by the iteration instead of ending the epoch early.
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

        draws = enumerate(index_stream())  # (position in the stream, index)
        draw_lock = threading.Lock()
        # the position whose item goes into item_q next: workers decode in
        # parallel and hand their items over in stream order
        turn = threading.Condition()
        next_pos = [0]

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

        def worker():
            while not stop.is_set():
                with draw_lock:
                    try:
                        pos, i = next(draws)
                    except StopIteration:
                        break
                try:
                    item = self.dataset[i]
                except Exception as e:  # raised again in the consuming thread
                    item = _Failure(e)
                with turn:
                    while next_pos[0] != pos:
                        if stop.is_set():
                            return
                        turn.wait(timeout=1)
                delivered = put_checked(item_q, item)
                with turn:
                    next_pos[0] += 1
                    turn.notify_all()
                if not delivered or isinstance(item, _Failure):
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
                        item = item_q.get(timeout=0.1)
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
                    if isinstance(item, _Failure):
                        put_checked(batch_q, item)
                        return
                    items.append(item)
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
                if isinstance(batch, _Failure):
                    raise batch.error
                yield batch
        finally:
            stop.set()


class _Failure:
    """An exception a worker caught, on its way to the consuming thread."""

    def __init__(self, error: Exception):
        self.error = error
