"""Profiling and tracing hooks (counterpart of ``gwkit/utils/tracing.py``).

:class:`PhaseTimer` is gwkit's wall-clock phase timer. :func:`trace` wraps
any phase in a ``torch.profiler`` session (the host always, the card's
kernels when the process has one) and writes a trace that Chrome's
``chrome://tracing``, Perfetto and TensorBoard's profiler plugin load;
:func:`annotate` names a region in it.

The port opens its own spans, named ``gw.<layer>``, at the entry of each
layer of the search and the classifiers (``gw.h2d``, ``gw.whiten``,
``gw.windows``, ``gw.triggers``, ``gw.qscan``, ``gw.qadapter``,
``gw.log_mel``, ``gw.encoder``, ``gw.head``, ``gw.cluster``); a profiler
session is their only switch. They are recorded as function records
(``cpu_op`` in the trace, like the ATen operations nested in them), not as
``user_annotation`` ranges, so that a caller's own ``record_function``
ranges still name every operation launched inside them. :data:`COUNTERS`
counts, always, the work at the same boundaries.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

# Plain counts at the port's layer boundaries, always on: ``windows`` scored,
# ``padded_windows`` (the wrap- or edge-padding of a block's last batch),
# ``h2d_bytes`` copied host -> device at the ``gw.h2d`` spans, and ``builds``,
# each miss of a hot-path cache (Q-scan plans and their device tables, the
# mel filter bank, the prepared encoder, a kernel library's load).
COUNTERS: Dict[str, int] = {"windows": 0, "padded_windows": 0, "h2d_bytes": 0, "builds": 0}

_NO_SPAN = contextlib.nullcontext()


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


def annotate(name: str):
    """Named region visible in profiler traces: a function record named
    ``name`` while a ``torch.profiler`` session records, so the region lands
    in the session's trace, on its clock, around the launches of the device
    operations inside it; else one shared no-op context, which costs an
    attribute test and allocates nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _RecordFunctionFast(name)
