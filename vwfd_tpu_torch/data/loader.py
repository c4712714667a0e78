"""Batching with host-side prefetch (port of vwfd_tpu/data/loader.py).

One process assembles each batch as numpy arrays: the item order is the
JAX package's (``np.arange(len·ratio) % len``, shuffled by a seeded
``default_rng``), items are fetched over a thread pool, and a thread keeps
``prefetch`` batches ready. The model moves a batch to the card.
``stream(start)`` yields the batches of successive epochs from batch
``start`` on, for a resumed run. Under data parallelism (``rows``) every
rank draws the global order from the shared seed and fetches only its
block ``[lo, hi)`` of each global batch (``parallel.local_batch_slice``,
vwfd_tpu/data/loader.py:34-44), so the ranks' batches together are the
one-process loader's.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ["Loader"]


class Loader:
    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 prefetch=2, ratio=1, num_workers=4, rows=None):
        """``batch_size`` is the global batch; ``rows`` ``(lo, hi)`` the
        block of each batch this process fetches (None: every row)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.rows = (0, batch_size) if rows is None else tuple(rows)
        if not 0 <= self.rows[0] < self.rows[1] <= batch_size:
            raise ValueError(f"rows {rows} are not a block of a batch of "
                             f"{batch_size}")
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
        """One epoch: its order drawn from the loader's generator."""
        return self._epoch(0)

    def stream(self, start: int = 0):
        """The batches of epoch after epoch, as repeated iteration yields
        them, from batch ``start`` on: the epochs before it draw their
        orders and make no batch, so a resumed run sees the batches an
        unbroken one sees."""
        per = len(self)
        for _ in range(start // per):
            self._order()
        yield from self._epoch(start % per)
        while True:
            yield from self._epoch(0)

    def _order(self):
        n = len(self.dataset) * self.ratio
        order = np.arange(n) % len(self.dataset)
        if self.shuffle:
            self.rng.shuffle(order)
        return order

    def _epoch(self, first: int):
        order = self._order()
        n = len(order)
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        lo, hi = self.rows

        def worker():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for b in range(first, n // self.batch_size):
                    if stop.is_set():
                        break
                    at = b * self.batch_size
                    q.put(self._make_batch(order[at + lo:at + hi], pool))
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
