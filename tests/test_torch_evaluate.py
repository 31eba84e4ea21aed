"""Port parity: the MLGWSC-1 challenge statistics (gwkit_torch.evaluation,
the bnslib half of gwkit_torch.search.cluster and
``python -m gwkit_torch.cli.evaluate``) against gwkit's on the same numpy
arrays and files. Both are numpy code, so every output is held by exact
equality: ``assert_array_equal`` on every array and ``==`` on scalars."""
import h5py
import numpy as np
import pytest

from gwkit.cli import evaluate as gw_cli
from gwkit.evaluation import mlgwsc as gw_eval
from gwkit.evaluation import sensitivity as gw_sens
from gwkit.search import cluster as gw_cluster
from gwkit_torch.cli import evaluate as pt_cli
from gwkit_torch.evaluation import mlgwsc as pt_eval
from gwkit_torch.evaluation import sensitivity as pt_sens
from gwkit_torch.search import cluster as pt_cluster


def _same(a, b):
    """Exact equality of two outputs (arrays, scalars, lists of tuples, dicts)."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        for key in a:
            _same(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def _both(name, *args, module="cluster", **kw):
    mods = {"cluster": (gw_cluster, pt_cluster), "eval": (gw_eval, pt_eval), "sens": (gw_sens, pt_sens)}[module]
    want = getattr(mods[0], name)(*args, **kw)
    got = getattr(mods[1], name)(*args, **kw)
    _same(got, want)
    return got


def test_seconds_per_month_and_cluster_semantics_equal_gwkit():
    assert pt_cluster.SECONDS_PER_MONTH == gw_cluster.SECONDS_PER_MONTH
    triggers = {"seg1": [[1.0, 0.5], [1.1, 0.9], [1.2, 0.7], [2.0, 0.3]], "seg2": [[5.0, 1.0]]}
    _both("get_clusters", triggers, cluster_threshold=0.35)
    # a gap exactly at the boundary: get_clusters splits on >, get_cluster_boundaries on >=
    t = np.array([0.0, 0.5, 1.0, 2.0, 2.35, 2.7])
    _both("get_clusters", {"a": [[x, 1.0] for x in t]}, cluster_threshold=0.35)
    for bt in (0.35, 0.5, 1.0):
        _both("get_cluster_boundaries", t, boundary_time=bt)
        _both("get_cluster_boundaries", np.stack([t, t]), boundary_time=bt)


def test_bnslib_cluster_chain_equals_gwkit():
    """gwkit's tests/test_search_eval.py::test_bnslib_cluster_chain, both packages."""
    t = np.arange(100) * 0.1
    v = np.zeros(100)
    v[10:13] = [0.5, 0.9, 0.6]
    v[50] = 0.8
    trig = _both("get_triggers_from_series", v, t, 0.2)
    assert trig.shape[1] == 4
    clusters = _both("get_cluster_boundaries", trig, boundary_time=1.0)
    events = _both("get_event_list_from_triggers", trig, clusters)
    assert len(events) == 2
    tp, fp = _both("split_true_and_false_positives", events, np.array([1.0]), tolerance=0.5)
    assert len(tp) == 1 and len(fp) == 1
    assert _both("false_alarm_rate", v, t, np.array([1.0]), trigger_thresh=0.2, ranking_thresh=0.5) > 0
    assert _both("sensitive_fraction", v, t, np.array([1.0]), trigger_thresh=0.2, ranking_thresh=0.5) == 1.0
    _both("get_triggers_from_series", v, t, 5.0)  # no trigger: the empty (2, 0) array
    _both("split_true_and_false_positives", [], np.array([1.0]))


def test_event_list_series_and_closest_injections_equal_gwkit():
    """gwkit's test_get_event_list_series_and_closest_injections, both packages."""
    t = np.arange(0, 10, 0.1)
    v = np.zeros_like(t)
    v[12] = 0.9
    v[50] = 0.7
    events = _both("get_event_list", v, t, [[1.0, 1.5], [4.8, 5.2], [7.01, 7.02]])
    assert len(events) == 2
    inj = np.array([30.0, 10.0, 20.0])
    for kw in (dict(return_indices=True), dict(), dict(return_indices=True, assume_sorted=True)):
        _both("get_closest_injection_times", np.sort(inj) if kw.get("assume_sorted") else inj,
              [11.0, 29.0, 15.0, 25.0], **kw)
    _both("events_above_threshold", [(1.0, 0.4), (2.0, 0.6), (3.0, 0.5)], 0.5)


@pytest.mark.parametrize("values", [
    np.array([-1.0, 0.4, 0.6, 7.4, 7.6, 20.0, 5.0]),  # gwkit's case and an exact tie (5.0 -> 1)
    np.random.default_rng(4).uniform(-5, 25, size=200),
])
def test_find_closest_index_equals_gwkit(values):
    arr = np.array([0.0, 10.0, 1.0, 5.0])
    idx = _both("find_closest_index", arr, values, module="eval")
    _both("find_closest_index", np.sort(arr), values, module="eval", assume_sorted=True)
    if len(values) == 7:
        np.testing.assert_array_equal(idx, [0, 0, 1, 2, 3, 3, 2])
    with pytest.raises(ValueError):
        pt_eval.find_closest_index(np.array([]), values)


def test_get_stats_known_answers_equal_gwkit():
    """gwkit's test_get_stats_known_answers, both packages."""
    injtc = np.array([100.0, 200.0, 300.0])
    injdist = np.array([50.0, 100.0, 150.0])
    fg = np.array([[100.05, 100.1, 150.0, 200.02, 250.0], [5.0, 7.0, 1.0, 6.0, 2.0], [0.2] * 5])
    bg = np.array([[10.0, 20.0, 30.0], [0.5, 1.5, 2.5], [0.2, 0.2, 0.2]])
    stats = _both("get_stats", fg, bg, {"tc": injtc, "distance": injdist}, duration=1000.0, module="eval")
    np.testing.assert_array_equal(stats["true-positive-event-indices"], [0, 1, 3])
    np.testing.assert_array_equal(stats["far"], np.array([2, 1, 0]) / 1000.0)
    assert stats["sensitive-fraction"][0] == 2.0 / 3.0


def _random_events(rng, injtc, n_fg=300, n_bg=500, span=(0.0, 10000.0)):
    """Foreground: half near injections (some within, some past the 0.2 s
    window), half anywhere; background anywhere. Rows (time, stat, var)."""
    near = rng.choice(injtc, n_fg // 2) + rng.normal(0, 0.3, n_fg // 2)
    fg_t = np.concatenate([near, rng.uniform(*span, n_fg - n_fg // 2)])
    fg = np.stack([fg_t, rng.normal(2, 2, n_fg), np.full(n_fg, 0.2)])
    bg = np.stack([rng.uniform(*span, n_bg), rng.normal(0, 2, n_bg), np.full(n_bg, 0.2)])
    return fg, bg


@pytest.mark.parametrize("chirp_distance", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_get_stats_random_events_equal_gwkit(seed, chirp_distance):
    rng = np.random.default_rng(seed)
    n_inj = 120
    inj = {"tc": np.sort(rng.uniform(50, 9950, n_inj)), "distance": rng.uniform(100, 3000, n_inj),
           "mass1": rng.uniform(10, 50, n_inj), "mass2": rng.uniform(10, 50, n_inj)}
    fg, bg = _random_events(rng, inj["tc"])
    for duration in (9000.0, None):
        got = _both("get_stats", fg, bg, inj, duration=duration, chirp_distance=chirp_distance, module="eval")
        assert len(got["true-positive-event-indices"]) > 0 and len(got["false-positive-event-indices"]) > 0
        assert np.isfinite(got["sensitive-distance"]).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_far_sensitive_fraction_and_distance_on_a_score_series_equal_gwkit(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(0, 2000, 0.1)
    v = rng.normal(0, 0.2, len(t))
    inj_t = np.sort(rng.uniform(10, 1990, 40))
    amp = rng.uniform(0, 2, len(inj_t))
    for ti, a in zip(inj_t, amp):
        v += a * np.exp(-0.5 * ((t - ti) / 0.3) ** 2)
    m1, m2, dist = rng.uniform(10, 50, 40), rng.uniform(10, 50, 40), 400 / (0.1 + amp)
    kw = dict(trigger_thresh=0.2, ranking_thresh=0.5)
    for name in ("false_alarm_rate", "sensitive_fraction"):
        _both(name, v, t, inj_t, **kw)
        _both(name, v, t, inj_t, trigger_thresh=0.5, ranking_thresh=1.0, cluster_tolerance=2.0, event_tolerance=1.0)
    d = _both("sensitive_distance", v, t, inj_t, m1, m2, dist, module="sens", **kw)
    assert 0 < d < dist.max()
    _both("sensitive_distance", v, t, inj_t, m1, m2, dist, module="sens", trigger_thresh=50.0, ranking_thresh=50.0)


@pytest.mark.parametrize("distribution_param", ["distance", "chirp_distance"])
@pytest.mark.parametrize("distribution", ["log", "uniform", "distancesquared", "volume"])
def test_volume_montecarlo_equals_gwkit(distribution, distribution_param):
    rng = np.random.default_rng(7)
    found, missed = rng.uniform(10, 100, 30), rng.uniform(50, 300, 20)
    fm, mm = rng.uniform(5, 30, 30), rng.uniform(5, 30, 20)
    _both("volume_montecarlo", found, missed, fm, mm, distribution_param, distribution, "distance", module="sens")
    if distribution == "volume" and distribution_param == "distance":
        ones = np.ones(3)
        vol, err = pt_sens.volume_montecarlo(np.array([10.0, 20, 30]), np.array([40.0, 50, 60]), ones, ones)
        assert vol == pytest.approx(4.0 / 3.0 * np.pi * 60.0 ** 3 * 0.5) and err > 0
    with pytest.raises(NotImplementedError):
        pt_sens.volume_montecarlo(found, missed, fm, mm, "mass", distribution, "distance")


def _strain_file(path, segments, fs=2048):
    with h5py.File(path, "w") as f:
        for det in ("H1", "L1"):
            g = f.create_group(det)
            for start, seconds in segments:
                d = g.create_dataset(str(int(start)), data=np.zeros(int(seconds * fs), np.float32))
                d.attrs["start_time"] = float(start)
                d.attrs["delta_t"] = 1.0 / fs


def _injection_file(path, tc, rng, chirp_distance=False):
    n = len(tc)
    with h5py.File(path, "w") as f:
        f.create_dataset("tc", data=np.asarray(tc, np.float64))
        f.create_dataset("distance", data=rng.uniform(100, 3000, n))
        f.create_dataset("mass1", data=rng.uniform(10, 50, n))
        f.create_dataset("mass2", data=rng.uniform(10, 50, n))
        if chirp_distance:
            f.create_dataset("chirp_distance", data=rng.uniform(100, 3000, n))


def _events_file(path, events, var_extra=0):
    with h5py.File(path, "w") as f:
        f.create_dataset("time", data=events[0])
        f.create_dataset("stat", data=events[1])
        f.create_dataset("var", data=np.concatenate([events[2], np.full(var_extra, 0.2)]))


def test_find_injection_times_and_read_events_on_files_equal_gwkit(tmp_path):
    rng = np.random.default_rng(3)
    fg, inj = str(tmp_path / "fg.hdf"), str(tmp_path / "inj.hdf")
    _strain_file(fg, [(1000.0, 100.0), (1300.0, 200.0)])
    _injection_file(inj, [990.0, 1035.0, 1095.0, 1200.0, 1330.0, 1400.0, 1475.0], rng)
    for pads in ((0, 0), (30, 30), (60, 90)):
        dur, mask = _both("find_injection_times", [fg], inj, *pads, module="eval")
        assert dur == 300.0
    np.testing.assert_array_equal(mask, [False] * 5 + [True, False])
    ev1, ev2 = str(tmp_path / "e1.hdf"), str(tmp_path / "e2.hdf")
    _events_file(ev1, rng.normal(size=(3, 7)), var_extra=2)  # var longer than time: cut, as gwkit
    _events_file(ev2, rng.normal(size=(3, 4)))
    events = _both("read_events", [ev1, ev2], module="eval")
    assert events.shape == (3, 11)


def _cli_files(tmp_path, rng, chirp_distance):
    """A 600 s foreground file with 20 injections inside and 5 outside,
    foreground events (20 near injections, 40 noise) in two files, and 150
    background events."""
    fg = str(tmp_path / "fg.hdf")
    _strain_file(fg, [(1000.0, 600.0)])
    tc = np.sort(np.concatenate([rng.uniform(1040, 1560, 20), rng.uniform(0, 900, 5)]))
    inj = str(tmp_path / "inj.hdf")
    _injection_file(inj, tc, rng, chirp_distance)
    inside = tc[(tc >= 1030) & (tc <= 1570)]
    fg_t = np.concatenate([inside[:16] + rng.normal(0, 0.1, 16), rng.uniform(1000, 1600, 40)])
    fg_ev = np.stack([fg_t, rng.normal(3, 2, len(fg_t)), np.full(len(fg_t), 0.2)])
    bg_ev = np.stack([rng.uniform(1000, 1600, 150), rng.normal(0, 2, 150), np.full(150, 0.2)])
    paths = [str(tmp_path / n) for n in ("fg_a.hdf", "fg_b.hdf", "bg.hdf")]
    _events_file(paths[0], fg_ev[:, :30])
    _events_file(paths[1], fg_ev[:, 30:])
    _events_file(paths[2], bg_ev)
    return ["--injection-file", inj, "--foreground-events", paths[0], paths[1], "--foreground-files", fg,
            "--background-events", paths[2]]


@pytest.mark.parametrize("chirp_distance", [False, True])
def test_evaluate_cli_output_equals_gwkit_cli(tmp_path, chirp_distance):
    args = _cli_files(tmp_path, np.random.default_rng(11), chirp_distance)
    gw_out, pt_out = str(tmp_path / "gw.hdf"), str(tmp_path / "pt.hdf")
    gw_cli.main(args + ["--output-file", gw_out])
    pt_cli.main(args + ["--output-file", pt_out])
    with h5py.File(gw_out) as a, h5py.File(pt_out) as b:
        assert list(a) == list(b) and len(a) == 16
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(b[key][()], a[key][()], err_msg=key)
        assert len(b["true-positive-event-indices"]) >= 16 and np.isfinite(b["sensitive-distance"][()]).all()
    # --force overwrites; without it the existing file is refused
    pt_cli.main(args + ["--output-file", pt_out, "--force"])
    with pytest.raises(IOError, match="already exists"):
        pt_cli.main(args + ["--output-file", pt_out])


def test_evaluate_cli_refusals_match_gwkit(tmp_path):
    args = _cli_files(tmp_path, np.random.default_rng(12), False)
    for main in (gw_cli.main, pt_cli.main):
        with pytest.raises(ValueError, match="extension `.hdf`"):
            main(args + ["--output-file", str(tmp_path / "out.h5")])
    # no injection inside the padded foreground: the same RuntimeError
    rng = np.random.default_rng(13)
    fg = str(tmp_path / "short.hdf")
    _strain_file(fg, [(1000.0, 70.0)])
    inj = str(tmp_path / "far_inj.hdf")
    _injection_file(inj, [1010.0, 1065.0, 5000.0], rng)
    bad = list(args)
    bad[bad.index("--foreground-files") + 1] = fg
    bad[bad.index("--injection-file") + 1] = inj
    for i, main in enumerate((gw_cli.main, pt_cli.main)):
        with pytest.raises(RuntimeError, match="no injections! Generate at least 84 seconds"):
            main(bad + ["--output-file", str(tmp_path / f"none{i}.hdf")])
