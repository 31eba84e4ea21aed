"""The port's progress and tracing utilities against gwkit's
(``tests/test_utils_aux.py``'s cases, each run on both packages): phase
timers, ``trace(None)``, ``annotate``, ``ProgressTracker``'s bar (string
for string equal to gwkit's on the same calls and clock), thread-safe
counts, ``DictList``'s surface (equal results), ``Counter``, and
``MPCounter``/``MPProgressTracker`` across forked processes (each killed
after 120 s). Then the port's own: a torch.profiler trace around an
annotated region, and ``plot_losses(metrics=)`` in both packages."""
import copy
import importlib
import io
import json
import logging
import multiprocessing as mp
import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

PACKAGES = ("gwkit", "gwkit_torch")
LIMIT_S = 120


def _progress(pkg):
    return importlib.import_module(f"{pkg}.utils.progress")


def _tracing(pkg):
    return importlib.import_module(f"{pkg}.utils.tracing")


class _Clock:
    """A scripted ``time`` module: each ``time()`` call advances 0.5 s."""

    def __init__(self):
        self.now = 1000.0

    def time(self):
        self.now += 0.5
        return self.now


def _run_threads(target, n):
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=target) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(LIMIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)


def _join_or_kill(procs):
    for p in procs:
        p.join(LIMIT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_phase_timer_accumulates_and_reports(pkg):
    pt = _tracing(pkg).PhaseTimer()
    with pt.phase("a"):
        pass
    with pt.phase("a"):
        pass
    with pt.phase("b"):
        pass
    assert pt.counts == {"a": 2, "b": 1}
    assert pt.totals["a"] >= 0.0 and pt.totals["b"] >= 0.0
    report = pt.report()
    assert "a: " in report and "over 2 calls" in report


@pytest.mark.parametrize("pkg", PACKAGES)
def test_phase_timer_records_on_exception(pkg):
    pt = _tracing(pkg).PhaseTimer()
    with pytest.raises(ValueError):
        with pt.phase("boom"):
            raise ValueError("x")
    assert pt.counts["boom"] == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_trace_none_is_noop(pkg, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with _tracing(pkg).trace(None):
        x = 1 + 1
        profiling = torch.autograd.profiler._is_profiler_enabled
    assert x == 2 and not profiling
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("pkg", PACKAGES)
def test_annotate_runs_eagerly(pkg):
    with _tracing(pkg).annotate("region"):
        y = float(jnp.sum(jnp.ones((3,)))) if pkg == "gwkit" else float(torch.ones(3).sum())
    assert y == 3.0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_progress_tracker_bar_and_completion(pkg):
    out = io.StringIO()
    pt = _progress(pkg).ProgressTracker(total=4, name="T", steps=10, out=out)
    for _ in range(4):
        pt.iterate()
    text = out.getvalue()
    assert "100.0%" in text
    assert "T: done in" in text
    assert "=" * 10 in text  # the completed bar is fully filled


def test_progress_tracker_prints_what_gwkit_prints(monkeypatch):
    """The same calls on the same clock: the same bytes, partial bars,
    overwrites of a longer line and the done line included."""
    texts = []
    for pkg in PACKAGES:
        mod = _progress(pkg)
        monkeypatch.setattr(mod, "time", _Clock())
        out = io.StringIO()
        pt = mod.ProgressTracker(total=7, name="scan", steps=12, out=out)
        pt.iterate(2)
        pt.iterate(print_update=False)
        pt.iterate(3)
        pt.iterate()
        pt.iterate()  # past the total
        small = mod.ProgressTracker(total=0, name="empty", out=out)  # a total of 0 counts as 1
        small.iterate()
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert "\rscan: [" in texts[1] and "scan: done in" in texts[1] and "empty: done in" in texts[1]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_progress_tracker_thread_safe_counts(pkg):
    pt = _progress(pkg).ProgressTracker(total=400, out=io.StringIO())
    _run_threads(lambda: [pt.iterate(print_update=False) for _ in range(100)], 4)
    assert pt.count == 400


@pytest.mark.parametrize("pkg", PACKAGES)
def test_dictlist_surface(pkg):
    DictList = _progress(pkg).DictList
    dl = DictList({"a": [1]})
    dl.append("a", 2)
    dl.append({"a": 3, "b": 10})  # dict append fans out per key
    dl.extend({"b": [11, 12]})
    dl.extend(DictList({"c": [0]}))
    assert dl.as_dict() == {"a": [1, 2, 3], "b": [10, 11, 12], "c": [0]}
    assert dl["a"] == [1, 2, 3]
    assert set(dl.keys()) == {"a", "b", "c"}
    assert len(dl) == 3


def _dictlist_session(DictList):
    """gwkit's full-surface case as a record of every result (copies: the
    lists a DictList hands out are its own, and change with it)."""
    rec = []
    add = lambda *vals: rec.extend(copy.deepcopy(v) for v in vals)
    dl = DictList({"a": 1, "b": [2, 3]})  # non-list values wrap
    add(dl["a"], dl["b"], "a" in dl, "z" in dl, dl.get("z", "d"), sorted(dl.keys()),
        list(dl.values()), list(dl.items()))
    joined = dl + {"a": [10], "c": 7}
    add(joined.as_dict(), dl.as_dict())  # + copies
    add(({"a": [0]} + dl).as_dict())
    for bad in (lambda: dl + 3, lambda: DictList([1, 2]), lambda: 3 + dl, lambda: dl.join([1])):
        with pytest.raises(TypeError):
            bad()
    dl.append({"a": 5, "d": 6})
    dl.extend("d", value=[7, 8])
    dl.extend("e")  # no value: nothing
    add(dl.as_dict(), dl.count(5), dl.count(6, keys="all"), dl.count(1, keys=["a", "zz"]),
        dl.pop("d"), dl.pop("zz", None), dl.copy().as_dict())
    add(dl.join({"a": [9]}) is dl, dl.as_dict())
    return rec


@pytest.mark.parametrize("pkg", PACKAGES)
def test_dictlist_full_surface(pkg):
    rec = _dictlist_session(_progress(pkg).DictList)
    assert rec[0] == [1] and rec[1] == [2, 3] and rec[2] and not rec[3] and rec[4] == "d"
    assert rec[8]["a"] == [1, 10] and rec[8]["c"] == [7] and rec[9]["a"] == [1] and rec[10]["a"] == [0, 1]
    assert rec[11]["a"] == [1, 5] and rec[11]["d"] == [6, 7, 8] and "e" not in rec[11]
    assert rec[12] == 1 and rec[13] == {"a": 0, "b": 0, "d": 1} and rec[14] == {"a": 1, "zz": 0}
    assert rec[15] == [6, 7, 8] and rec[16] is None and rec[18] and rec[19]["a"] == [1, 5, 9]


def test_dictlist_results_equal_gwkit():
    assert _dictlist_session(_progress("gwkit_torch").DictList) == _dictlist_session(_progress("gwkit").DictList)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_counter_thread_safe(pkg):
    c = _progress(pkg).Counter()
    _run_threads(lambda: [c.increment() for _ in range(1000)], 8)
    assert c.value == 8000


def _mp_counter_worker(counter, n):
    for _ in range(n):
        counter.increment()


def _mp_progress_worker(tracker, n):
    for _ in range(n):
        tracker.iterate()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_mp_counter_across_processes(pkg):
    """MPCounter: two forked processes incrementing one shared value, and
    the int/counter arithmetic."""
    MPCounter = _progress(pkg).MPCounter
    c = MPCounter(5)
    assert c.value == 5 and c == 5
    c.increment(3)
    assert c == 8
    c += 2
    assert (c + MPCounter(1)).value == 11 and (c + 4) == 14
    with pytest.raises(TypeError):
        c == "x"
    with pytest.raises(TypeError):
        c + "x"
    with pytest.raises(TypeError):
        MPCounter(1.5)

    shared = MPCounter(0)
    ctx = mp.get_context("fork")
    procs = [ctx.Process(target=_mp_counter_worker, args=(shared, 500)) for _ in range(2)]
    for p in procs:
        p.start()
    _join_or_kill(procs)
    assert shared.value == 1000


@pytest.mark.parametrize("pkg", PACKAGES)
def test_mp_progress_tracker_across_processes(pkg):
    out = io.StringIO()
    tracker = _progress(pkg).MPProgressTracker(100, name="mp", out=out)
    ctx = mp.get_context("fork")
    procs = [ctx.Process(target=_mp_progress_worker, args=(tracker, 50)) for _ in range(2)]
    for p in procs:
        p.start()
    _join_or_kill(procs)
    assert tracker.shared_count == 100
    assert out.getvalue() == ""  # workers count; only the owner prints
    tracker.print_update()
    text = out.getvalue()
    assert "100.0%" in text and "done" in text and tracker.count == 100


def test_trace_writes_a_json_trace_holding_the_region(tmp_path, caplog):
    from gwkit_torch.utils.tracing import annotate, trace

    logdir = tmp_path / "trace"
    with caplog.at_level(logging.INFO), trace(str(logdir)):
        assert torch.autograd.profiler._is_profiler_enabled
        with annotate("region"):
            y = (torch.randn(32, 32) @ torch.randn(32, 32)).relu().sum()
    assert torch.isfinite(y) and not torch.autograd.profiler._is_profiler_enabled
    assert f"torch profiler trace written to {logdir}" in caplog.text
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(logdir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    region = [e for e in events if e.get("name") == "region"]
    assert len(region) == 1 and region[0]["dur"] > 0
    start, end = region[0]["ts"], region[0]["ts"] + region[0]["dur"]
    inside = {e["name"] for e in events if e.get("cat") == "cpu_op" and start <= e["ts"] <= end}
    assert {"aten::mm", "aten::relu", "aten::sum"} <= inside


def test_plot_losses_takes_metrics_in_both_packages(tmp_path):
    import matplotlib.image

    from gwkit.utils.plotting import plot_losses as gw_plot_losses
    from gwkit_torch.utils.plotting import plot_losses

    losses = tmp_path / "losses.txt"
    losses.write_text("".join(f"{e:04d}\t{0.7 - 0.1 * e:.6f}\t{0.72 - 0.1 * e:.6f}\n" for e in (1, 2, 3)))
    metrics = {"auc": np.array([0.6, 0.7, 0.8]), "accuracy": [0.5, 0.6, 0.7]}
    got = plot_losses(str(losses), str(tmp_path / "pt.png"), metrics=metrics)
    want = gw_plot_losses(str(losses), str(tmp_path / "gw.png"), metrics=metrics)
    assert got == str(tmp_path / "pt.png")
    assert matplotlib.image.imread(got).shape == matplotlib.image.imread(want).shape
    # the argument is ignored, as gwkit ignores it: the same picture without it
    plain = plot_losses(str(losses), str(tmp_path / "plain.png"))
    assert np.array_equal(matplotlib.image.imread(got), matplotlib.image.imread(plain))
