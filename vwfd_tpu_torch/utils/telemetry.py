"""Observability (port of vwfd_tpu/utils/telemetry.py): scalar logging and
profiler traces.

``ScalarLogger`` writes the JAX module's JSONL records (``step``, ``time``
and the scalars as floats, one line a call) to ``<logdir>/scalars.jsonl``,
and to TensorBoard where ``torch.utils.tensorboard`` imports (optional, as
in the JAX module). ``profile_trace`` records the enclosed steps with
``torch.profiler`` (CPU and, where there is one, CUDA activity) and writes
a Chrome trace into ``logdir``; ``step_annotation`` names a span of it
(``torch.profiler.record_function``).
"""

import contextlib
import json
import os
import time

import torch


class ScalarLogger:
    """JSONL scalar stream + optional TensorBoard event files."""

    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "scalars.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard.writer import SummaryWriter
                self._tb = SummaryWriter(logdir)
            except Exception:
                self._tb = None

    def log(self, step: int, **scalars):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), global_step=step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True):
    """Record the enclosed steps with ``torch.profiler`` and write
    ``<logdir>/trace.json`` (Chrome trace format, for Perfetto or
    chrome://tracing)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def step_annotation(name: str):
    """A named span in the profiler's timeline."""
    with torch.profiler.record_function(name):
        yield
