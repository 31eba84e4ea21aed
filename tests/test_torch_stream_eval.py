"""Port parity for the stream evaluation, the bulk scorer and real-event
scoring, against gwkit on the same numpy inputs and weights.

``gwkit_torch/evaluation/stream.py`` is host numpy and must equal gwkit's
bit for bit: every function is compared with exact equality. The scorers
run both packages' tiny Signal_vs_Noise tasks (d 32, 2 heads, 1 layer, 128
mel frames, f32 on the CPU; gwkit's weights handed over): their scores
agree within 1e-4 x max |score|, the files' keys, shapes and dtypes
exactly, and the bulk scorer's log and resume exactly.
"""
import dataclasses

import h5py
import numpy as np
import pytest
import torch

import jax

import gwkit.evaluation.stream as gw_stream
from gwkit.models.whisper import WhisperConfig as GwW
from gwkit.search import bulk as gw_bulk
from gwkit.search import realevents as gw_realevents
from gwkit.train.tasks import build_signal_vs_noise as gw_build
from gwkit_torch.evaluation import stream
from gwkit_torch.io import from_gwkit_numpy
from gwkit_torch.models.whisper import WhisperConfig
from gwkit_torch.search import bulk, realevents
from gwkit_torch.train.tasks import build_signal_vs_noise

TINY = dict(d_model=32, n_heads=2, n_layers=1, d_ff=64, max_positions=1500)


def _stream_case(seed, n_inj=4, with_params=True):
    rng = np.random.default_rng(seed)
    t = np.arange(0, 200, 0.1)
    v = 0.3 * rng.random(len(t))
    tc = np.sort(rng.uniform(10, 190, n_inj))
    for c in tc:  # each injection a peak; some false alarms beside them
        v[np.abs(t - c) < 0.25] = rng.uniform(0.5, 1.0)
    for fa in rng.uniform(5, 195, 3):
        v[np.abs(t - fa) < 0.15] = rng.uniform(0.4, 0.9)
    inj = {"tc": rng.permutation(tc)}  # an injection table need not be sorted
    if with_params:
        inj.update(mass1=rng.uniform(10, 50, n_inj), mass2=rng.uniform(10, 50, n_inj),
                   distance=rng.uniform(100, 2000, n_inj))
    return v, t, inj


def _assert_results_equal(got, want):
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if field.name == "events":
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [
    dict(seed=0, ranking_thresholds=[0.35, 0.5, 0.7, 0.95]),
    dict(seed=1),  # the default thresholds: quantiles of the event statistics
    dict(seed=2, with_params=False, trigger_thresh=0.45, cluster_tolerance=0.3, event_tolerance=1.0),
    dict(seed=3, trigger_thresh=2.0),  # no triggers: the default linspace thresholds
])
def test_evaluate_score_stream_equals_gwkit(kw):
    kw = dict(kw)
    v, t, inj = _stream_case(kw.pop("seed"), with_params=kw.pop("with_params", True))
    got = stream.evaluate_score_stream(v, t, inj, **kw)
    want = gw_stream.evaluate_score_stream(v, t, inj, **kw)
    _assert_results_equal(got, want)
    assert len(got.ranking_thresholds) == len(got.far_per_month)


def test_series_activation_and_filename_helpers_equal_gwkit():
    rng = np.random.default_rng(4)
    two = rng.normal(size=(9, 2))
    times = np.arange(9) * 0.1
    for scores in (two, two[:, :1], two[:, 0]):
        for mode in ("usr", "softmax"):
            for g, w in zip(stream.scores_to_series(scores, times, mode), gw_stream.scores_to_series(scores, times, mode)):
                np.testing.assert_array_equal(g, w)
    for act, rank in (("linear", "linear"), ("linear", "softmax"), ("softmax", "softmax")):
        np.testing.assert_array_equal(stream.convert_activation(two, act, rank),
                                      gw_stream.convert_activation(two, act, rank))
    for act, rank, match in (("softmax", "linear", "linear ranking"), ("linear", "max", "unrecognized ranking"),
                             ("tanh", "softmax", "unrecognized data_activation")):
        with pytest.raises(ValueError, match=match):
            stream.convert_activation(two, act, rank)
        with pytest.raises(ValueError, match=match):
            gw_stream.convert_activation(two, act, rank)
    for fn in ("scores-0-16.hdf", "scores-1600-16.hdf", "x-1238166018-4096.h5"):
        assert stream.start_time_from_filename(fn) == gw_stream.start_time_from_filename(fn)
    assert stream.start_time_from_filename("scores-1600-16.hdf") == 1600.1


def _write_scores(path, data):
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=np.asarray(data, np.float64))


def test_load_and_assemble_score_files_equal_gwkit(tmp_path):
    rng = np.random.default_rng(5)
    for start, n in ((16, 160), (0, 150), (40, 90), (30, 120)):  # a gap, an overlap, out of order
        _write_scores(tmp_path / f"scores-{start}-16.hdf", rng.normal(size=(n, 2)))
    (tmp_path / "scores-64-16.hdf").write_bytes(b"not hdf5")  # skipped by both
    (tmp_path / "subdir").mkdir()
    for act, rank in (("linear", "linear"), ("linear", "softmax"), ("softmax", "softmax")):
        got = stream.load_score_files(str(tmp_path), 0.75, 0.1, act, rank)
        want = gw_stream.load_score_files(str(tmp_path), 0.75, 0.1, act, rank)
        assert [t for _, t in got] == [t for _, t in want] and len(got) == 4
        for (g, _), (w, _) in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(stream.assemble_score_series(got, 0.1), gw_stream.assemble_score_series(want, 0.1)):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="not found"):
        stream.load_score_files(str(tmp_path / "missing"))
    with pytest.raises(ValueError, match="no score files"):
        stream.assemble_score_series([])


def _tiny_pair(num_classes=1, perturb=True):
    gw = gw_build(jax.random.PRNGKey(0), encoder=GwW(**TINY), input_sample_rate=256, n_frames=128,
                  num_classes=num_classes)
    if perturb:  # non-zero LoRA B, so the adapters count
        gw.trainable["adapters"] = jax.tree.map(
            lambda a: a + 0.01 * np.arange(a.size, dtype=np.float32).reshape(a.shape) % 0.07, gw.trainable["adapters"])
    params = from_gwkit_numpy(encoder=jax.tree.map(np.asarray, gw.frozen["encoder"]),
                              **jax.tree.map(np.asarray, gw.trainable))
    port = build_signal_vs_noise(WhisperConfig(**TINY), params, input_sample_rate=256, n_frames=128,
                                 num_classes=num_classes, device="cpu")
    return gw, port


def _close(got, want, frac=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * np.abs(want).max())


@pytest.mark.parametrize("num_classes,usr", [(2, True), (2, False), (1, True)])
def test_score_files_with_resume_matches_gwkit(tmp_path, num_classes, usr):
    gw_task, task = _tiny_pair(num_classes)
    rng = np.random.default_rng(6)
    files = []
    for i, n in enumerate((5, 8, 3)):  # a padded last chunk, exact chunks, one short chunk
        path = str(tmp_path / f"f{i}.hdf")
        with h5py.File(path, "w") as f:
            f.create_dataset("data/0", data=rng.normal(size=(n, 2, 256)).astype(np.float32))
        files.append(path)
    out = {k: str(tmp_path / f"{k}.hdf") for k in ("gw", "pt")}
    gw_bulk.score_files(gw_task, files[:2], out["gw"], chunk=4, usr=usr)
    bulk.score_files(task, files[:2], out["pt"], chunk=4, usr=usr)
    # resume: an entry deleted from the output stays skipped (the log lists it); a new file is scored
    for k in out:
        with h5py.File(out[k], "a") as f:
            del f["f0.hdf"]
    gw_bulk.score_files(gw_task, files, out["gw"], chunk=4, usr=usr)
    bulk.score_files(task, files, out["pt"], chunk=4, usr=usr)
    with h5py.File(out["pt"]) as g, h5py.File(out["gw"]) as w:
        assert sorted(g.keys()) == sorted(w.keys()) == ["f1.hdf", "f2.hdf"]
        for key in w:
            _close(g[key][()], w[key][()])
        assert g["f1.hdf"].shape == ((8, 2) if num_classes == 2 else (8, 1))
    assert open(out["pt"] + ".log").read() == open(out["gw"] + ".log").read() == "f0.hdf\nf1.hdf\nf2.hdf\n"
    if num_classes == 1:  # other trainables passed in, for this call only
        other = jax.tree.map(lambda a: np.asarray(a) * 1.5, gw_task.trainable)
        gw_bulk.score_files(gw_task, files[1:], str(tmp_path / "gw2.hdf"), chunk=4, trainable=other)
        bulk.score_files(task, files[1:], str(tmp_path / "pt2.hdf"), chunk=4, trainable=from_gwkit_numpy(**other))
        with h5py.File(tmp_path / "pt2.hdf") as g, h5py.File(tmp_path / "gw2.hdf") as w, h5py.File(out["pt"]) as p:
            for key in w:
                _close(g[key][()], w[key][()])
                assert np.abs(g[key][()] - p[key][()]).max() > 1e-6
    np.testing.assert_array_equal(bulk.USR_MATRIX, gw_bulk.USR_MATRIX)
    x = rng.normal(size=(4, 2)).astype(np.float32)
    np.testing.assert_array_equal(bulk.usr_scores(x), gw_bulk.usr_scores(x))


@pytest.mark.parametrize("white", [True, False])
def test_score_event_segments_matches_gwkit(tmp_path, white):
    """Pre-whitened strain, and raw strain whitened by the slicer (the
    CLI's --whiten); the task's trainables, and others passed in."""
    gw_task, task = _tiny_pair()
    rng = np.random.default_rng(7)
    events = {"GW150914": rng.normal(size=(2, 2048)).astype(np.float32),
              "GW170814": (1e-21 * rng.normal(size=(2, 1800))).astype(np.float32)}
    kw = dict(sample_rate=256.0, window=256, step=64, batch_size=8, white=white)
    want = gw_realevents.score_event_segments(gw_task, events, **kw)
    got = realevents.score_event_segments(task, events, **kw)
    assert list(got) == list(want)
    for name in want:
        _close(got[name], want[name])
        half = 0 if white else 32  # the whitening crop: max_filter_duration 0.25 s at 256 Hz, halved
        assert len(got[name]) == 1 + (events[name].shape[1] - 2 * half - 256) // 64
        assert ((got[name] > 0) & (got[name] < 1)).all()
    other = jax.tree.map(lambda a: np.asarray(a) * 1.5, gw_task.trainable)
    want2 = gw_realevents.score_event_segments(gw_task, events, trainable=other, **kw)
    got2 = realevents.score_event_segments(task, events, trainable=from_gwkit_numpy(**other), **kw)
    for name in want:
        _close(got2[name], want2[name])
        assert np.abs(got2[name] - got[name]).max() > 1e-6
    _close(task.forward(torch.from_numpy(events["GW150914"][None, :, :256])).numpy(),
           np.asarray(gw_task.forward(gw_task.trainable, gw_task.frozen, events["GW150914"][None, :, :256])))
    gw_realevents.write_event_scores(str(tmp_path / "gw.hdf"), want)
    realevents.write_event_scores(str(tmp_path / "pt.hdf"), got)
    with h5py.File(tmp_path / "pt.hdf") as g, h5py.File(tmp_path / "gw.hdf") as w:
        assert list(g.keys()) == list(w.keys())
        for key in w:
            _close(g[key][()], w[key][()])
