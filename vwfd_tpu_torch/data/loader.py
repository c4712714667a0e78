"""Batching with host-side prefetch (port of vwfd_tpu/data/loader.py).

One process assembles each batch as numpy arrays: the item order is the
JAX package's (``np.arange(len·ratio) % len``, shuffled by a seeded
``default_rng``), items are fetched over a thread pool, and a thread keeps
``prefetch`` batches ready. The model moves a batch to the card.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ["Loader"]


class Loader:
    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 prefetch=2, ratio=1, num_workers=4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        # epoch-enlargement factor (DistIterSampler ratio, train.py:57)
        self.ratio = ratio
        self.num_workers = num_workers

    def _make_batch(self, idxs, pool):
        items = list(pool.map(self.dataset.__getitem__, idxs))
        if isinstance(items[0], tuple):
            return tuple(np.stack(parts) for parts in zip(*items))
        return np.stack(items)

    def __iter__(self):
        n = len(self.dataset) * self.ratio
        order = np.arange(n) % len(self.dataset)
        if self.shuffle:
            self.rng.shuffle(order)
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for b in range(n // self.batch_size):
                    if stop.is_set():
                        break
                    q.put(self._make_batch(
                        order[b * self.batch_size:(b + 1) * self.batch_size],
                        pool))
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()
            while t.is_alive():  # unblock a worker waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.01)

    def __len__(self):
        return len(self.dataset) * self.ratio // self.batch_size
