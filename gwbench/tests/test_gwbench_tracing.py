"""The benchmark's readers on traced slices with and without the port's
own ``gw.*`` spans. The port records them as function records (``cpu_op``),
so ``tracing.TraceSlice`` labels every operation and idle gap by the
benchmark's spans alone, as before the port had spans: on synthetic slices
of each cell every accepted reader returns the same value to the bit and
the breakdown is the same; on a CPU profile of the port's ``annotate``
inside a benchmark span the slice holds the benchmark's span alone. The
padded-windows reader reads the port's counters."""
import json
import sys

import pytest
import torch

from gwbench import files
from gwbench.tracing import Slice, Spans, TraceSlice

PEAK = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}


class _Trace:
    """Chrome-trace events: the benchmark's spans (``user_annotation``), the
    port's (``cpu_op``, as ``gwkit_torch.utils.tracing.annotate`` records
    them), and device operations each with its launch on the host, matched
    by correlation id (microseconds)."""

    def __init__(self):
        self.events, self.corr = [], 0

    def span(self, name, start, end):
        cat = "cpu_op" if name.startswith("gw.") else "user_annotation"
        self.events.append({"ph": "X", "cat": cat, "name": name, "ts": float(start), "dur": float(end - start)})

    def op(self, name, launch, start, end, cat="kernel"):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": float(launch),
                            "dur": 1.0, "args": {"correlation": self.corr}})
        self.events.append({"ph": "X", "cat": cat, "name": name, "ts": float(start), "dur": float(end - start),
                            "args": {"correlation": self.corr}})


def search_events():
    """One segment: an 8 us host -> device copy and whitening, two batches
    of the model step at 100 and 400 us, the scores' copy to the host, the
    clusters."""
    tr = _Trace()
    tr.span("slice", 0, 1000)
    tr.span("segment", 5, 995)
    tr.span("gw.h2d", 10, 20)
    tr.op("Memcpy HtoD (Pageable -> Device)", 12, 20, 40, "gpu_memcpy")
    tr.span("gw.whiten", 20, 60)
    tr.op("fft_r2c", 25, 40, 70)
    tr.op("elementwise_whiten", 30, 70, 80)
    for t in (100, 400):
        tr.span("gw.h2d", t - 20, t - 12)
        tr.op("Memcpy HtoD (Pageable -> Device)", t - 18, t - 10, t - 5, "gpu_memcpy")
        tr.span("gw.windows", t - 10, t - 2)
        tr.op("index_gather", t - 8, t - 5, t + 10)
        tr.span("score", t, t + 280)
        tr.span("gw.qscan", t + 5, t + 80)
        tr.op("radixSortKVInPlace", t + 6, t + 10, t + 60)
        tr.op("fft_c2c", t + 30, t + 60, t + 80)
        tr.span("gw.qadapter", t + 80, t + 180)
        tr.op("sm80_xmma_fprop_implicit_gemm_f32", t + 90, t + 130, t + 160)
        tr.op("elementwise_relu", t + 100, t + 160, t + 180)
        tr.span("gw.encoder", t + 180, t + 260)
        tr.op("gw::hopper_attention_kernel", t + 185, t + 190, t + 220)
        tr.op("gw::hopper_fused_mlp_kernel", t + 200, t + 220, t + 250)
        tr.op("gw::hopper_ln_gemm_kernel", t + 210, t + 250, t + 260)
        tr.span("gw.head", t + 260, t + 275)
        tr.op("gemm_head", t + 265, t + 265, t + 275)
        tr.op("elementwise_select", t + 278, t + 278, t + 280)
    tr.span("gw.triggers", 690, 740)
    tr.op("Memcpy DtoH (Device -> Pageable)", 692, 692, 700, "gpu_memcpy")
    tr.span("cluster", 745, 790)
    tr.span("gw.cluster", 750, 785)
    return tr.events


def classify_events():
    """Two batches at 50 and 350 us: the windows' copy, log-mel, encoder,
    head, sigmoid and the copy to the host."""
    tr = _Trace()
    tr.span("slice", 0, 700)
    for t in (50, 350):
        tr.span("batch", t, t + 250)
        tr.op("Memcpy HtoD (Pageable -> Device)", t + 2, t + 2, t + 12, "gpu_memcpy")
        tr.span("gw.log_mel", t + 15, t + 60)
        tr.op("fft_r2c", t + 20, t + 20, t + 40)
        tr.op("elementwise_log", t + 30, t + 50, t + 60)
        tr.span("gw.encoder", t + 60, t + 200)
        tr.op("gw::hopper_attention_kernel", t + 65, t + 70, t + 150)
        tr.op("gw::hopper_fused_mlp_kernel", t + 80, t + 150, t + 190)
        tr.span("gw.head", t + 200, t + 215)
        tr.op("gemm_head", t + 205, t + 205, t + 215)
        tr.op("sigmoid", t + 216, t + 216, t + 218)
        tr.span("to_host", t + 220, t + 245)
        tr.op("Memcpy DtoH (Device -> Pageable)", t + 222, t + 222, t + 230, "gpu_memcpy")
    return tr.events


CELLS = {
    "search": (search_events, {"attention": 2, "ln_gemm": 2, "fused_mlp": 2}, 1e-3),
    "classify": (classify_events, {"attention": 2, "ln_gemm": 0, "fused_mlp": 2}, 7e-4),
}


def trace_slice(cell, program=True):
    make, launches, window_s = CELLS[cell]
    events = [e for e in make() if program or not e["name"].startswith("gw.")]
    ctx = TraceSlice(events, window_s, dict(launches))
    ctx.extra.update(batches=2, peak=PEAK, model_flops=3.0e9,
                     bounds={"attention": 8e-6, "ln_gemm": 4e-6, "fused_mlp": 1.2e-5})
    return ctx


def _reader(name):
    return files.metric_reader(name).read


# the per-layer metrics the benchmark had before the port opened spans
ACCEPTED = {
    "search": ["device_idle", "mfu", "attention_roofline", "ln_gemm_roofline", "fused_mlp_roofline",
               "step_device_ms", "engine_device_ms"],
    "classify": ["device_idle", "mfu", "attention_roofline", "ln_gemm_roofline", "fused_mlp_roofline"],
}


@pytest.mark.parametrize("name", [f"{m}.{cell}" for cell, ms in sorted(ACCEPTED.items()) for m in ms])
def test_readers_read_the_same_to_the_bit(name):
    cell = name.split(".")[1]
    plain, got = _reader(name)(trace_slice(cell, False)), _reader(name)(trace_slice(cell))
    assert got == plain and (got is not None or name == "ln_gemm_roofline.classify")


def test_step_and_engine_keep_the_benchmark_labels():
    """The model step's device time is what was launched in ``score``, the
    engine's the rest, with the port's spans open inside both."""
    ctx = trace_slice("search")
    assert _reader("step_device_ms.search")(ctx) == pytest.approx((50 + 20 + 30 + 20 + 30 + 30 + 10 + 10 + 2) / 1e3)
    assert _reader("engine_device_ms.search")(ctx) == pytest.approx((20 + 30 + 10 + 2 * (5 + 15) + 8) / 2e3)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_breakdown_and_labels_unchanged_by_program_spans(cell):
    plain, got = trace_slice(cell, False), trace_slice(cell)
    assert got.spans == plain.spans and got.ops == plain.ops
    assert got.busy == plain.busy and got.busy_s == plain.busy_s
    assert got.breakdown(n=100) == plain.breakdown(n=100)


def test_port_spans_never_reach_the_benchmark_labels(tmp_path):
    """A CPU profile through the benchmark's own slice: the port's layer
    span, open inside the benchmark's ``score``, is in the trace but not
    among the spans the slice labels by."""
    from gwkit_torch.utils.tracing import annotate

    spans, seen = Spans(True), []
    sl = Slice(0, 1, dict)
    sl.before(0)
    with spans.span("score"):
        with annotate("gw.qscan"):
            seen.append(torch.autograd.profiler._is_profiler_enabled)
            torch.randn(16, 16).relu().sum()
    sl.after(0)
    sl.prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ctx = TraceSlice(events, sl.window_s, {})
    assert seen == [True]
    assert [name for *_, name in ctx.spans] == ["score"]
    (span,) = [e for e in events if e.get("name") == "gw.qscan"]
    assert span["cat"] == "cpu_op"
    assert ctx.label_at(span["ts"] + 0.5 * span["dur"]) == "score"


def test_padded_windows_reads_the_ports_counters(monkeypatch):
    from gwkit_torch.utils.tracing import COUNTERS

    monkeypatch.setitem(COUNTERS, "windows", 6011)
    monkeypatch.setitem(COUNTERS, "padded_windows", 5)
    assert _reader("padded_windows.search")(trace_slice("search")) == pytest.approx(100 * 5 / 6016, rel=1e-12)
    monkeypatch.setitem(sys.modules, "gwkit_torch.utils.tracing", None)  # a program without the counters
    assert _reader("padded_windows.search")(trace_slice("search")) is None
