"""Keras-style console progress bar with stateful metrics (port of
vwfd_tpu/utils/progbar.py; reference: utils/__init__.py:101-263, used
train.py:96,109): ``Progbar(target).add(n, values)``, running means for
regular metrics and the last value for ``stateful_metrics``, the same text.
"""

import sys
import time


class Progbar:
    def __init__(self, target, width=25, verbose=1, interval=0.05,
                 stateful_metrics=None):
        self.target = target
        self.width = width
        self.verbose = verbose
        self.interval = interval
        self.stateful_metrics = set(stateful_metrics or [])
        self._values = {}
        self._order = []
        self._seen_so_far = 0
        self._start = time.time()
        self._last_update = 0.0

    def update(self, current, values=None):
        values = values or []
        for k, v in values:
            if k not in self._order:
                self._order.append(k)
            if k in self.stateful_metrics:
                self._values[k] = (v, 1)
            else:
                step = current - self._seen_so_far
                tot, cnt = self._values.get(k, (0.0, 0))
                self._values[k] = (tot + v * max(step, 1), cnt + max(step, 1))
        self._seen_so_far = current

        now = time.time()
        if self.verbose != 1:
            return
        if now - self._last_update < self.interval and (
                self.target is None or current < self.target):
            return
        self._last_update = now

        bar = f"{current}/{self.target if self.target else '?'}"
        if self.target:
            frac = current / self.target
            filled = int(self.width * frac)
            bar += " [" + "=" * filled + ">" * (filled < self.width) + \
                   "." * (self.width - filled - 1) + "]"
        elapsed = now - self._start
        rate = current / elapsed if elapsed > 0 else 0
        info = f" - {elapsed:.0f}s - {rate:.2f} it/s"
        for k in self._order:
            tot, cnt = self._values[k]
            info += f" - {k}: {tot / max(cnt, 1):.4f}"
        sys.stdout.write("\r" + bar + info)
        if self.target and current >= self.target:
            sys.stdout.write("\n")
        sys.stdout.flush()

    def add(self, n, values=None):
        self.update(self._seen_so_far + n, values)
