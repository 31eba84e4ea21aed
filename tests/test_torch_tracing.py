"""The port's own spans and counters (``gwkit_torch.utils.tracing``): each
layer of the search and of the mel classifier opens its ``gw.*`` span while
a profiler records, the model step's spans never nest, tracing changes no
output, ``annotate`` is one shared no-op without a profiler, and the
counters follow the segment's geometry, with nothing built again on a
second identical call. Small shapes on the CPU: the tiny search of
tests/test_torch_search.py (a 20 s two-detector segment, batches of 64,
8 s whitening blocks) and a mel task at n_frames 128."""
import json
import os

import h5py
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gwkit_torch.utils import tracing
from gwkit_torch.utils.tracing import COUNTERS, annotate

FS = 2048
SECONDS = 20
BATCH = 64
BLOCK = 8 * FS
SEARCH_SPANS = {"gw.h2d", "gw.whiten", "gw.windows", "gw.triggers", "gw.qscan", "gw.qadapter", "gw.encoder",
                "gw.head", "gw.cluster"}
STEP_SPANS = {"gw.qscan", "gw.qadapter", "gw.log_mel", "gw.encoder", "gw.head"}
EXPECTED_SPANS = {
    "search": SEARCH_SPANS,
    "stream_search": SEARCH_SPANS - {"gw.windows"},  # windows are cropped from the block's Q-scan, not gathered
    "mel": {"gw.log_mel", "gw.encoder", "gw.head"},
}


def _strain(seconds=SECONDS, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, seconds * FS)) * 1e-21).astype(np.float32)


def _search_task():
    from gwkit_torch.models.qadapter import QAdapterConfig
    from gwkit_torch.models.whisper import WhisperConfig
    from gwkit_torch.train.tasks import build_mlgwsc

    return build_mlgwsc(WhisperConfig(d_model=32, n_heads=2, n_layers=1, d_ff=64, max_positions=64),
                        QAdapterConfig(spectrogram_shape=(32, 32), target_shape=(80, 128), channels=(4, 8, 8),
                                       median_stride=8), device="cpu")


def _mel_task():
    from gwkit_torch.models.whisper import WhisperConfig
    from gwkit_torch.train.tasks import build_signal_vs_noise

    return build_signal_vs_noise(WhisperConfig(d_model=64, n_heads=2, n_layers=1, d_ff=128, max_positions=64),
                                 n_frames=128, device="cpu")


def _search(task, max_block=BLOCK, stream=False):
    """The engine over one segment, then its clusters; the score stream."""
    from gwkit_torch.search.cluster import get_clusters
    from gwkit_torch.search.engine import score_segments, stream_search_kwargs
    from gwkit_torch.search.slicer import Segment, SlicerConfig

    kw = dict(batch_size=BATCH, **({"max_block": max_block} if max_block else {}))
    res = score_segments(task.score, [Segment("seg", _strain(), 1000.0, 1 / FS)], SlicerConfig(**kw),
                         trigger_threshold=-1e9, device=torch.device("cpu"),
                         **(stream_search_kwargs(task) if stream else {}))
    get_clusters(res.triggers)
    return res.all_vals


def _classify(task):
    x = torch.from_numpy(_strain(seconds=1, seed=5)[None].repeat(3, axis=0))
    return task.forward(x).numpy()


RUNS = {
    "search": lambda tasks: _search(tasks["search"]),
    "stream_search": lambda tasks: _search(tasks["search"], stream=True),
    "mel": lambda tasks: _classify(tasks["mel"]),
}


def _spans(prof, path):
    """(name, start, end, category) of every span of the port (``gw.*``)
    in the profile's trace."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"], e.get("cat")) for e in events
            if e["name"].startswith("gw.") and e.get("ph") == "X"]


@pytest.fixture(scope="module")
def tasks():
    return {"search": _search_task(), "mel": _mel_task()}


@pytest.fixture(scope="module")
def traced(tasks, tmp_path_factory):
    """Each run once untraced and once under a CPU profiler: (untraced
    output, traced output, spans of the traced run)."""
    out = {}
    for case, run in RUNS.items():
        plain = run(tasks)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert annotate("gw.x") is not annotate("gw.y")
            got = run(tasks)
        out[case] = plain, got, _spans(prof, tmp_path_factory.mktemp(case) / "trace.json")
    return out


@pytest.mark.parametrize("case", sorted(RUNS))
def test_profiled_run_opens_each_layer_span(traced, case):
    """Each layer's span, recorded as a function (``cpu_op``), never as a
    ``user_annotation`` range: those stay the caller's."""
    spans = traced[case][2]
    assert {name for name, *_ in spans} == EXPECTED_SPANS[case]
    assert {cat for *_, cat in spans} == {"cpu_op"}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_model_step_spans_do_not_nest(traced, case):
    step = sorted((s, e, name) for name, s, e, _ in traced[case][2] if name in STEP_SPANS)
    assert step
    for (_, end, first), (start, _, second) in zip(step, step[1:]):
        assert start >= end, (first, second)


@pytest.mark.parametrize("case", sorted(RUNS))
def test_outputs_bitwise_equal_traced_and_untraced(traced, case):
    plain, got, _ = traced[case]
    assert plain.shape == got.shape and plain.size > 0
    np.testing.assert_array_equal(plain, got)


def test_annotate_without_profiler_is_the_shared_noop(monkeypatch):
    made = []
    real = tracing._RecordFunctionFast

    def counting(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(tracing, "_RecordFunctionFast", counting)
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = annotate("gw.a"), annotate("gw.b")
    assert a is b is tracing._NO_SPAN
    with a, b:
        pass
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with annotate("gw.c"):
            pass
    assert made == ["gw.c"]


def _geometry(max_block, stream):
    """(windows, padded windows, bytes host -> device) of the segment from
    its geometry alone: 0.1 s steps of 204 samples, 1 s windows, 0.125 s
    cropped at each end by whitening, blocks of ``max_block`` raw samples
    sliding back at the tail."""
    n_raw, half, step, length = SECONDS * FS, 256, 204, FS
    n_windows = 1 + (n_raw - 2 * half - length) // step
    if max_block is None:
        blocks, raw_bytes = [n_windows], 2 * n_raw * 4
    else:
        per_block = 1 + (max_block - 2 * half - length) // step
        blocks = [min(per_block, n_windows - i) for i in range(0, n_windows, per_block)]
        raw_bytes = len(blocks) * 2 * max_block * 4
    batches = sum(-(-n // BATCH) for n in blocks)
    padded = batches * BATCH - n_windows
    start_bytes = batches * BATCH * (4 if stream else 8)  # f32 seconds or int64 sample starts
    return n_windows, padded, raw_bytes + start_bytes


@pytest.mark.parametrize("max_block,stream", [(None, False), (BLOCK, False), (BLOCK, True)],
                         ids=["unblocked", "blocked", "stream"])
def test_counters_follow_segment_geometry(tasks, max_block, stream):
    before = dict(COUNTERS)
    scores = _search(tasks["search"], max_block=max_block, stream=stream)
    got = {k: COUNTERS[k] - before[k] for k in ("windows", "padded_windows", "h2d_bytes")}
    windows, padded, h2d = _geometry(max_block, stream)
    assert windows == len(scores) == 189
    assert got == {"windows": windows, "padded_windows": padded, "h2d_bytes": h2d}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_second_identical_call_builds_nothing(case):
    fresh = {"search": _search_task(), "mel": _mel_task()}
    before = COUNTERS["builds"]
    RUNS[case](fresh)
    assert COUNTERS["builds"] - before >= 1  # at least the fresh task's prepared encoder
    before = COUNTERS["builds"]
    RUNS[case](fresh)
    assert COUNTERS["builds"] == before


def _write_segment_file(path):
    with h5py.File(path, "w") as f:
        for i, det in enumerate(("H1", "L1")):
            ds = f.create_group(det).create_dataset("1238205000", data=_strain()[i].astype(np.float64))
            ds.attrs["start_time"] = 1238205000.0
            ds.attrs["delta_t"] = 1.0 / FS


@pytest.mark.parametrize("flag", [True, False], ids=["trace_dir", "no_flag"])
def test_inference_cli_trace_dir(tasks, flag, tmp_path, monkeypatch, capsys):
    """``--trace-dir`` writes a profiler trace holding the search's layer
    spans and prints the counters over the search; without it neither."""
    from gwkit_torch.cli import inference

    monkeypatch.setattr(inference, "load_task_from_components", lambda *a, **k: tasks["search"])
    _write_segment_file(tmp_path / "in.hdf")
    logdir = tmp_path / "trace"
    argv = [str(tmp_path / "in.hdf"), str(tmp_path / "out.hdf"), "--lora-weights", "l", "--dense-weights", "d",
            "--adapter-weights", "a", "--cpu", "--batch-size", str(BATCH)]
    inference.main(argv + (["--trace-dir", str(logdir)] if flag else []))
    out = capsys.readouterr().out
    assert os.path.isfile(tmp_path / "out.hdf")
    with open(tmp_path / "out.hdf.config.json") as f:
        assert not any("trace_dir" in section for section in json.load(f).values())
    if not flag:
        assert "Counters" not in out and not logdir.exists()
        return
    assert "Counters over the search: windows 189, padded_windows 3, h2d_bytes " in out
    (name,) = os.listdir(logdir)
    with open(logdir / name) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
    assert SEARCH_SPANS - {"gw.cluster"} <= names  # the CLI clusters after the search
