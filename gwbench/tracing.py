"""Spans around the benchmark's own calls into the port, the profiled slice
of a window, and its reduction to what the per-layer readers read.

With ``--trace 1`` a driver profiles a short steady slice of its window
(``Slice``: a fixed run of units, e.g. one search segment or 16 batches)
under ``torch.profiler`` (CPU and CUDA activity) and closes it with a
synchronize. The trace is written to a file under ``TMPDIR``, read back and
deleted. Every device operation (kernel, copy, fill) is labelled by the
innermost benchmark span open on the host when it was launched, matched by
its correlation id. With ``--trace 0`` spans are no-ops.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's kernel libraries (ops/_cuda.py's LAUNCHES keys) -> their group of device kernels
HAND_WRITTEN = {"attention": "attention_kernel", "ln_gemm": "ln_gemm_kernel", "fused_mlp": "fused_mlp_kernel"}


def kernel_group(name: str) -> str:
    """A device operation's group by its name (a copy of the grouping the
    port's smoke run used)."""
    low = name.lower()
    for key in ("attention_kernel", "dq_kernel", "dkdv_kernel", "ln_gemm_kernel", "fused_mlp_kernel",
                "int8_gemm_kernel"):
        if key in low:
            return key
    if "nccl" in low:
        return "nccl (collectives)"
    if "fft" in low:
        return "fft (whitening, Q-scan, resampling, STFT)"
    if any(k in low for k in ("conv", "cudnn", "implicit", "fprop", "dgrad", "wgrad")):
        return "convolution (stem, Q-adapter)"
    if any(k in low for k in ("gemm", "cutlass", "nvjet", "xmma")):
        return "library gemm (projections, head, pooling, mel bank)"
    if "sort" in low or "radix" in low:
        return "sort (medians)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (elementwise, gathers, reductions)"


class Spans:
    """``span(name)``: a ``record_function`` region when tracing, else nothing."""

    def __init__(self, on: bool):
        self.on = on

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.on else contextlib.nullcontext()


class Slice:
    """Profiles units ``start`` .. ``start + count - 1`` of a window (all
    None when not tracing). ``counters()`` returns the port's launch counts,
    read before and after."""

    def __init__(self, start: Optional[int], count: int, counters: Callable[[], Dict[str, int]]):
        self.start, self.count, self.counters = start, count, counters
        self.prof = self.span = None
        self.launches: Dict[str, int] = {}
        self.window_s = 0.0

    @property
    def done(self) -> bool:
        return self.start is None or self.window_s > 0.0

    def before(self, unit: int) -> None:
        if self.start is None or unit != self.start:
            return
        from torch.profiler import ProfilerActivity, profile

        _sync()
        self._before = dict(self.counters())
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        self.span = torch.profiler.record_function("slice")
        self.span.__enter__()

    def after(self, unit: int) -> None:
        if self.start is None or unit != self.start + self.count - 1:
            return
        _sync()
        self.span.__exit__(None, None, None)
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        after = self.counters()
        self.launches = {k: after[k] - self._before.get(k, 0) for k in after}

    def reduce(self) -> "TraceSlice":
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        return TraceSlice(events, self.window_s, self.launches)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class TraceSlice:
    """The profiled slice: device operations (name, start, end, host span at
    launch; microseconds, the trace's clock), host spans, the slice's wall
    seconds and the port's launch counts over it. Readers add what the
    driver knows (``units``, ``batches``, ``model_flops``, ``bounds``,
    ``peak``)."""

    def __init__(self, events: List[dict], window_s: float, launches: Dict[str, int]):
        self.window_s = window_s
        self.launches = launches
        spans = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
                 if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
        slices = [s for s in spans if s[2] == "slice"]
        self.t0, self.t1 = (slices[0][0], slices[0][1]) if slices else (
            min(e["ts"] for e in events if "ts" in e), max(e["ts"] + e.get("dur", 0) for e in events if "ts" in e))
        self.spans = sorted((s for s in spans if s[2] != "slice"), key=lambda s: (s[0], -s[1]))
        launch_ts = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
                launch_ts[e["args"]["correlation"]] = e["ts"]
        self.ops = []  # (name, start, end, label)
        for e in events:
            if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
                s = max(e["ts"], self.t0)
                t = min(e["ts"] + e.get("dur", 0.0), self.t1)
                if t <= s:
                    continue
                at = launch_ts.get(e.get("args", {}).get("correlation"))
                self.ops.append((e["name"], s, t, self.label_at(at) if at is not None else "unmatched"))
        self.busy = _merge([(s, t) for _, s, t, _ in self.ops])
        self.busy_s = sum(t - s for s, t in self.busy) / 1e6
        self.extra: dict = {}

    def label_at(self, ts: float) -> str:
        """The innermost benchmark span open at ``ts`` ("slice" if none)."""
        best = "slice"
        for s, e, name in self.spans:
            if s > ts:
                break
            if e >= ts:
                best = name  # spans sorted by start: a later one that holds ts is nested deeper
        return best

    def seconds(self, group: Optional[str] = None, labels: Optional[Tuple[str, ...]] = None,
                outside: Optional[Tuple[str, ...]] = None) -> float:
        """Device seconds of operations in ``group``, launched under one of
        ``labels`` or under none of ``outside``."""
        total = 0.0
        for name, s, t, label in self.ops:
            if group is not None and kernel_group(name) != group:
                continue
            if labels is not None and label not in labels:
                continue
            if outside is not None and label in outside:
                continue
            total += t - s
        return total / 1e6

    def count(self, group: str) -> int:
        return sum(1 for name, *_ in self.ops if kernel_group(name) == group)

    def breakdown(self, n: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for name, s, t, _ in self.ops:
            by_name[name[:160]] = by_name.get(name[:160], 0.0) + (t - s) / 1e6
        gaps = []
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((b - a, self.label_at(0.5 * (a + b))))
        gaps.sort(reverse=True)
        return {"device_ops": [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]],
                "idle_gaps": [[label, g / 1e6] for g, label in gaps[:n]]}
