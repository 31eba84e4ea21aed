"""Profiling and tracing hooks (counterpart of ``gwkit/utils/tracing.py``).

:class:`PhaseTimer` is gwkit's wall-clock phase timer. :func:`trace` wraps
any phase in a ``torch.profiler`` session (the host always, the card's
kernels when the process has one) and writes a trace that Chrome's
``chrome://tracing``, Perfetto and TensorBoard's profiler plugin load;
:func:`annotate` names a region in it.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Accumulating named phase timers (per-epoch / per-segment breakdowns)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [
            f"{name}: {self.totals[name]:.2f}s over {self.counts[name]} calls"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Record a torch.profiler trace when a logdir is given, else no-op.

    The trace is written on exit as ``<host>_<pid>.<time>.pt.trace.json``
    under ``logdir`` (created if missing), the name TensorBoard's profiler
    plugin looks for."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
            yield
    finally:
        logging.info("torch profiler trace written to %s", logdir)


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in profiler traces (``record_function``)."""
    with torch.profiler.record_function(name):
        yield
