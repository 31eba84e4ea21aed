"""Port parity for data generation's pipeline: ``gwkit_torch.data.
{segments,population,generate}``, ``gwkit_torch.utils.hdf5`` and
``python -m gwkit_torch.cli.generate_data`` against gwkit's on the CPU.

Tolerances: the host code (segments, populations, injection tables, PSD
selection, time slides, HDF5 layouts) is a numpy copy, equal bit for bit.
The two packages draw noise from different generators (jax keys, torch
streams), so the noise tests substitute both packages' draws with the same
numpy draws (gwkit's ``colored_noise``/``_batched_colored_noise`` and the
port's ``seeded_draws``, by monkeypatching; both draw in segment ->
detector -> chunk order). Noise from the same draws through two FFT
libraries agrees within 1e-5 of the largest value; waveforms and
injections (float32 phases of up to 1e5 rad, evaluated by two libraries)
within 2e-3 of each waveform's, or the segment's, largest value. A resumed
run of the port equals an uninterrupted one bit for bit.
"""
import dataclasses
import json
import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_population import DS2_LIKE_INI, DS3_LIKE_INI

from gwkit.data import generate as gw_generate
from gwkit.data import population as gw_population
from gwkit.data import segments as gw_segments
from gwkit.evaluation import mlgwsc as gw_mlgwsc
from gwkit.search import slicer as gw_slicer
from gwkit.utils import hdf5 as gw_hdf5
from gwkit_torch.data import generate, noise, population, segments
from gwkit_torch.evaluation import mlgwsc
from gwkit_torch.search import slicer
from gwkit_torch.utils import hdf5

T0 = 1238166018.0
NOISE_TOL, WAVE_TOL = 1e-5, 2e-3


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


class SameDraws:
    """Both packages' noise from one numpy stream: draw k (in call order) is
    default_rng(base + k)'s two standard-normal arrays. With ``ulp`` set,
    the port's draws are each moved by one float32 ulp, up or down at
    random (a probe of a pipeline's float32 conditioning)."""

    def __init__(self, monkeypatch, base=100):
        self.base, self.k, self.ulp = base, {"gwkit": 0, "port": 0}, False
        monkeypatch.setattr(gw_generate, "colored_noise", self._gw_one)
        monkeypatch.setattr(gw_generate, "_batched_colored_noise", self._gw_batched)
        monkeypatch.setattr("gwkit.data.noise.colored_noise", self._gw_one)
        monkeypatch.setattr(noise, "seeded_draws", self._port)

    def _next(self, who, shape):
        r = np.random.default_rng(self.base + self.k[who])
        self.k[who] += 1
        return r.standard_normal(shape, dtype=np.float32), r.standard_normal(shape, dtype=np.float32)

    def _gw_one(self, key, n, delta_t, psd):
        a, b = self._next("gwkit", psd.shape[:-1] + (n // 2 + 1,))
        amp = jnp.sqrt(psd * n / (4.0 * delta_t))  # gwkit.data.noise.colored_noise after its draws
        z = (a + 1j * b) * amp
        z = z.at[..., 0].set(0.0)
        z = z.at[..., -1].set(a[..., -1] * jnp.sqrt(psd[..., -1] * n / (2.0 * delta_t)))
        return jnp.fft.irfft(z, n, axis=-1)

    def _gw_batched(self, keys, n, delta_t, psd):
        return jnp.stack([self._gw_one(k, n, delta_t, psd) for k in keys])

    def _port(self, stream, shape, device):
        a, b = self._next("port", tuple(shape))
        if self.ulp:
            r = np.random.default_rng(self.k["port"])
            a, b = (np.nextafter(x, np.where(r.random(x.shape) < 0.5, -np.inf, np.inf).astype(np.float32))
                    for x in (a, b))
        return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def _walk(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, (o[()], dict(o.attrs)))
                     if isinstance(o, h5py.Dataset) else None)
        out["/"] = (None, dict(f.attrs))
    return out


# ---------------------------------------------------------------- host copies

def test_segments_are_gwkit_s(tmp_path):
    assert segments.default_o3a_segments() == gw_segments.default_o3a_segments()
    assert segments.default_o3a_segments(1e9, 4e4) == gw_segments.default_o3a_segments(1e9, 4e4)
    spans = gw_segments.default_o3a_segments()
    for dur, min_seg in ((3600.0, 0.0), (86400.0, 0.0), (50000.0, 10000.0)):
        assert segments.restrict_segments(spans, dur, min_seg) == gw_segments.restrict_segments(spans, dur, min_seg)
    with pytest.raises(ValueError, match="too short"):
        segments.restrict_segments([(0.0, 10.0)], 20.0)
    csv = tmp_path / "segments.csv"
    for text in ("0,1238166018,1238170000\n", "0,10,20\n1,30,45.5\n"):
        csv.write_text(text)
        assert segments.load_segments_csv(str(csv)) == gw_segments.load_segments_csv(str(csv))
    fs = 64.0
    r = np.random.default_rng(0)
    rows = [(det, r.normal(size=int(fs * n)).astype(np.float32), t) for det, n, t in
            (("H1", 100, 0.0), ("L1", 120, -10.0), ("V1", 110, -3.0))]
    for duration in (None, 80.0):  # circular slides, then offsets into a slide buffer
        got = segments.OverlapSegment(*[segments.DetectorData(d, x, t, fs) for d, x, t in rows], duration=duration)
        want = gw_segments.OverlapSegment(*[gw_segments.DetectorData(d, x, t, fs) for d, x, t in rows],
                                          duration=duration)
        assert got.overlap == want.overlap and got.detectors == want.detectors
        for shift in (False, True):
            (s1, a1), (s2, a2) = got.get(shift, np.random.default_rng(7)), want.get(shift, np.random.default_rng(7))
            assert s1 == s2
            np.testing.assert_array_equal(a1, a2)
        lists = segments.SegmentList([got]), gw_segments.SegmentList([want])
        assert lists[0].get_full_seglist() == lists[1].get_full_seglist()
        assert lists[0].get_full_duration() == lists[1].get_full_duration()
        for (s1, a1), (s2, a2) in zip(lists[0].apply_dynamic_shifts(np.random.default_rng(3)),
                                      lists[1].apply_dynamic_shifts(np.random.default_rng(3))):
            assert s1 == s2
            np.testing.assert_array_equal(a1, a2)


@pytest.mark.parametrize("text", [DS2_LIKE_INI, DS3_LIKE_INI, "json"])
def test_populations_are_gwkit_s(text, tmp_path):
    if text == "json":
        path = tmp_path / "pop.json"
        path.write_text(json.dumps({"mass_min": 5.0, "mass_max": 20.0, "spin_max": 0.5,
                                    "approximant": "IMRPhenomPv2", "chirp_distance_range": [50.0, 150.0]}))
    else:
        path = tmp_path / "pop.ini"
        path.write_text(text)
    got, want = population.load_population(str(path)), gw_population.load_population(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    a, b = got.sample(np.random.default_rng(0), 64), want.sample(np.random.default_rng(0), 64)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_population_errors_are_gwkit_s(tmp_path):
    cases = [("pop.json", json.dumps({"mass_minimum": 5.0}), "mass_minimum"),
             ("pop.ini", "[prior-eccentricity]\nname = uniform\nmin-eccentricity = 0\nmax-eccentricity = 0.1\n",
              "eccentricity"),
             ("pop.ini", "[prior-mass1]\nname = gaussian\nmin-mass1 = 5\nmax-mass1 = 20\n", "uniform mass"),
             ("pop.ini", "[prior-spin1_a]\nname = uniform\nmin-spin1_a = 0.1\nmax-spin1_a = 0.5\n", "must be 0")]
    for name, text, match in cases:
        (tmp_path / name).write_text(text)
        for pkg in (population, gw_population):
            with pytest.raises(ValueError, match=match):
                pkg.load_population(str(tmp_path / name))
    for pkg in (population, gw_population):
        with pytest.raises(ValueError, match="unsupported approximant"):
            pkg.normalize_approximant("SEOBNRv4")
        with pytest.raises(ValueError, match="ini or .json"):
            pkg.load_population("pop.yaml")
    assert population._APPROXIMANTS == gw_population._APPROXIMANTS


@pytest.mark.parametrize("dataset", [1, 2, 3, 4])
def test_injection_table_and_psd_selection_are_gwkit_s(dataset):
    got, want = generate.challenge_distribution(dataset), gw_generate.challenge_distribution(dataset)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    spans = gw_segments.restrict_segments(gw_segments.default_o3a_segments(), 20000.0)
    a = generate.make_injection_table(5, spans, distribution=got)
    b = gw_generate.make_injection_table(5, spans, distribution=want)
    assert list(a) == list(b) and len(a["tc"]) > 100
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if dataset == 4:
        for pkg in (generate, gw_generate):
            with pytest.raises(ValueError):
                pkg.challenge_distribution(5)
            with pytest.raises(ValueError, match="datasets 1-3"):
                pkg.ChallengePSDSelector(4, 0, ("H1", "L1"))
        return
    sel, gw_sel = generate.ChallengePSDSelector(dataset, 9, ("H1", "L1")), \
        gw_generate.ChallengePSDSelector(dataset, 9, ("H1", "L1"))
    keys = [(sel.key_for(d, i), gw_sel.key_for(d, i)) for i in range(12) for d in ("H1", "L1")]
    assert all(k == g for k, g in keys)
    for key, _ in keys[:4]:
        np.testing.assert_array_equal(sel.psd_array(key, 2049, 0.5, 18.0), gw_sel.psd_array(key, 2049, 0.5, 18.0))


# ---------------------------------------------------------------- the challenge files

# challenge runs at 512 Hz with 32 s waves in blocks of 8 (gwkit's defaults are
# 2048 Hz, 64 s and 64): a padded block of 64 precessing waveforms costs
# minutes on a CPU shared by several test workers
FS_SMALL, WAVE_S, INJECT_BATCH = 512.0, 32.0, 8


def test_project_injection_batch_matches_gwkit():
    """A padded block of INJECT_BATCH ds3/4 injections at 512 Hz: the
    device gather shifts as np.roll does, and the strains are within 2e-3
    of the block's max |h| by detector. A waveform alone differs from
    gwkit's by up to 3.2e-3 of its own max (median 7e-4, over 64 such
    waveforms) near the merger, where each package's float32 waveform is
    2.0-2.6e-3 of its max from the same model in float64."""
    spans = [(T0, T0 + 1800.0)]
    params = gw_generate.make_injection_table(4, spans, distribution=gw_generate.challenge_distribution(3))
    blk = np.arange(INJECT_BATCH) % 5
    got = generate._project_injection_batch(params, blk, WAVE_S, FS_SMALL, 20.0, 1.0, ("H1", "L1"),
                                            approximant="imrphenomxphm", device="cpu").numpy()
    want = gw_generate._project_injection_batch(params, blk, WAVE_S, FS_SMALL, 20.0, 1.0, ("H1", "L1"),
                                                approximant="imrphenomxphm")
    assert got.shape == want.shape == (INJECT_BATCH, 2, int(WAVE_S * FS_SMALL))
    for d in range(2):  # a sample's shift would move each merger by a radian or more
        _close(got[:, d], want[:, d], WAVE_TOL, f"detector {d}")


def _generate_both(tmp_path, dataset, **kw):
    """gwkit's and the port's challenge files from the same arguments,
    both packages' noise from the same numpy draws; their paths."""
    paths = {}
    for pkg, fn in (("gwkit", gw_generate.generate_challenge_data), ("port", generate.generate_challenge_data)):
        paths[pkg] = tuple(str(tmp_path / f"{pkg}_{nm}.hdf") for nm in ("fg", "bg", "inj"))
        extra = {"device": "cpu"} if pkg == "port" else {}
        fn(*paths[pkg], dataset=dataset, **kw, **extra)
    return paths


@pytest.mark.parametrize("dataset,fs,span", [(1, 2048.0, 640.0), (3, FS_SMALL, 200.0), (4, FS_SMALL, None)])
def test_challenge_data_matches_gwkit(dataset, fs, span, tmp_path, monkeypatch):
    """Datasets 1 (a 640 s segment of 2.5 chunks), 3 and 4: the background
    within 1e-5 of its max, fg - bg within 2e-3 of its max, keys and
    attributes equal, the injection file bit for bit; then each package's
    search and evaluation readers read the other's files."""
    kw = dict(sample_rate=fs, seed=3, wave_duration=WAVE_S, inject_batch=INJECT_BATCH)
    if dataset == 4:  # both read one noise file gwkit wrote: no draws to substitute
        real = str(tmp_path / "real_noise.hdf")
        gw_generate.write_real_noise_file(real, sample_rate=fs, seed=1,
                                          segments=[(T0, T0 + 600.0), (T0 + 1000.0, T0 + 1600.0)])
        kw.update(duration=300.0, real_noise_path=real)
    else:
        SameDraws(monkeypatch)
        kw.update(segments=[(T0, T0 + span)])
    paths = _generate_both(tmp_path, dataset, **kw)
    files = {pkg: [_walk(p) for p in ps] for pkg, ps in paths.items()}
    (g_fg, g_bg, g_inj), (w_fg, w_bg, w_inj) = files["port"], files["gwkit"]
    assert list(g_inj) == list(w_inj) and g_inj["/"][1] == w_inj["/"][1] == {"dataset": dataset}
    for k in w_inj:
        if k != "/":
            np.testing.assert_array_equal(g_inj[k][0], w_inj[k][0], err_msg=k)
    assert len(w_inj["tc"][0]) >= 5
    assert sorted(g_fg) == sorted(w_fg) == sorted(g_bg) == sorted(w_bg)
    for k in w_bg:
        if k == "/":
            continue
        assert g_bg[k][1] == w_bg[k][1] == g_fg[k][1] == w_fg[k][1]
        assert g_bg[k][0].dtype == w_bg[k][0].dtype == np.float32
        if dataset == 4:
            np.testing.assert_array_equal(g_bg[k][0], w_bg[k][0], err_msg=k)
        else:
            _close(g_bg[k][0], w_bg[k][0], NOISE_TOL, f"background {k}")
        diff = w_fg[k][0].astype(np.float64) - w_bg[k][0]
        assert np.abs(diff).max() > 0
        _close(g_fg[k][0].astype(np.float64) - g_bg[k][0], diff, WAVE_TOL, f"foreground - background {k}")

    # the readers cross: each package's segments and injection times from either's files
    for fg, inj in (paths["gwkit"][0::2], paths["port"][0::2]):
        a, b = slicer.read_segments(fg), gw_slicer.read_segments(fg)
        assert [(s.key, s.start_time, s.delta_t) for s in a] == [(s.key, s.start_time, s.delta_t) for s in b]
        for s, t in zip(a, b):
            np.testing.assert_array_equal(s.strain, t.strain)
        (d1, m1), (d2, m2) = mlgwsc.find_injection_times([fg], inj), gw_mlgwsc.find_injection_times([fg], inj)
        assert d1 == d2 and m1.any()
        np.testing.assert_array_equal(m1, m2)


def test_real_noise_file_layout_and_loader_are_gwkit_s(tmp_path):
    """The port's write_real_noise_file writes gwkit's layout (its noise is
    the port's own draws), and each package's load_real_noise_segments
    reads either package's file to the same segments."""
    spans = [(T0, T0 + 600.0), (T0 + 1000.0, T0 + 1600.0)]
    paths = {"port": str(tmp_path / "port.hdf"), "gwkit": str(tmp_path / "gwkit.hdf")}
    assert generate.write_real_noise_file(paths["port"], sample_rate=FS_SMALL, seed=1, segments=spans,
                                          device="cpu") == spans
    gw_generate.write_real_noise_file(paths["gwkit"], sample_rate=FS_SMALL, seed=1, segments=spans)
    got, want = _walk(paths["port"]), _walk(paths["gwkit"])
    assert sorted(got) == sorted(want) == ["/", "H1/1238166018", "H1/1238167018", "L1/1238166018", "L1/1238167018"]
    for k in want:
        if k != "/":
            assert got[k][1] == want[k][1] and got[k][0].shape == want[k][0].shape
            assert got[k][0].dtype == want[k][0].dtype == np.float32
            assert 0.5 < got[k][0].std() / want[k][0].std() < 2.0  # one PSD, physical scale
    for path in paths.values():
        for duration in (300.0, 700.0):  # each segment keeps 240 s for the slides
            a = generate.load_real_noise_segments(path, duration)
            b = gw_generate.load_real_noise_segments(path, duration)
            assert [(s.duration, s.overlap) for s in a] == [(s.duration, s.overlap) for s in b]
            for s, t in zip(a, b):
                for x, y in zip(s.data, t.data):
                    assert (x.detector, x.start_time, x.sample_rate) == (y.detector, y.start_time, y.sample_rate)
                    np.testing.assert_array_equal(x.strain, y.strain)
        for pkg in (generate, gw_generate):
            with pytest.raises(ValueError, match="covers"):
                pkg.load_real_noise_segments(path, 5000.0)


@pytest.mark.parametrize("dataset,fs", [(1, 2048.0), (3, FS_SMALL)])
def test_challenge_resume_is_bit_exact(dataset, fs, tmp_path):
    """An interrupted run (the last segment dropped from fg, partly from bg,
    and the injection file gone) resumed equals an uninterrupted one, bit
    for bit (gwkit's own resume test, on the port; dataset 3 also draws a
    PSD variant per segment)."""
    spans = [(T0, T0 + 200.0), (T0 + 1000.0, T0 + 1640.0), (T0 + 2000.0, T0 + 2300.0)]

    def paths(tag):
        return tuple(str(tmp_path / f"{tag}_{nm}.hdf") for nm in ("fg", "bg", "inj"))

    # the aligned model's waveforms for both: what resumes is the noise and the PSD choice
    kw = dict(seed=5, segments=spans, wave_duration=24.0, sample_rate=fs, dataset=dataset, device="cpu",
              distribution=generate.challenge_distribution(1))
    generate.generate_challenge_data(*paths("a"), **kw)
    generate.generate_challenge_data(*paths("b"), **kw)
    b_fg, b_bg, b_inj = paths("b")
    with h5py.File(b_fg, "a") as f:
        for det in list(f.keys()):
            del f[det]["2"]
    with h5py.File(b_bg, "a") as f:
        del f[sorted(f.keys())[1]]["2"]
    os.remove(b_inj)
    generate.generate_challenge_data(*paths("b"), resume=True, **kw)
    for pa, pb in zip(paths("a"), paths("b")):
        da, db = _walk(pa), _walk(pb)
        assert sorted(da) == sorted(db)
        for k in da:
            if k != "/":
                np.testing.assert_array_equal(da[k][0], db[k][0], err_msg=f"{pb}:{k}")
            assert da[k][1] == db[k][1]


def test_synthesis_in_memory_and_its_draws(monkeypatch):
    """ChallengeSynthesis makes segments in any order with the same result,
    its PSD choices are gwkit's in gwkit's order, and each noise chunk is
    its own stream (seed, domain, segment, detector, chunk)."""
    spans = [(T0, T0 + 100.0), (T0 + 200.0, T0 + 300.0), (T0 + 400.0, T0 + 450.0)]
    kw = dict(sample_rate=FS_SMALL, seed=2, segments=spans, wave_duration=8.0, dataset=3, device="cpu",
              distribution=generate.challenge_distribution(1))
    a, b = generate.ChallengeSynthesis(**kw), generate.ChallengeSynthesis(**kw)
    sel = gw_generate.ChallengePSDSelector(3, 2, ("H1", "L1"))
    assert [[a.psd_key(si, d) for d in ("H1", "L1")] for si in range(3)] == \
        [[sel.key_for(d, si) for d in ("H1", "L1")] for si in range(3)]
    later = b.segment(2)
    for si in range(3):
        start, bg, fg = a.segment(si)
        assert start == spans[si][0] and bg["H1"].shape == (a.n_samples(si),)
    for x, y in zip((start, bg, fg), later):
        assert x == y if isinstance(x, float) else all(torch.equal(x[d], y[d]) for d in ("H1", "L1"))
    seen = []
    real = noise.seeded_draws
    monkeypatch.setattr(noise, "seeded_draws", lambda s, shape, dev: seen.append(tuple(s)) or real(s, shape, dev))
    a.segment(1)
    assert seen == [(2, noise.STREAM_CHALLENGE, 1, 0, 0), (2, noise.STREAM_CHALLENGE, 1, 1, 0)]


@pytest.mark.parametrize("n_valid", [4, 0])
def test_training_set_matches_gwkit(n_valid, tmp_path, monkeypatch):
    """The corpus: waveform windows within 2e-3 of each window's max of
    gwkit's, the noise windows from the same draws within 1e-5 of the max,
    the layout equal (an empty validation split included)."""
    SameDraws(monkeypatch)
    out = {}
    for pkg, fn in (("gwkit", gw_generate.generate_training_set), ("port", generate.generate_training_set)):
        out[pkg] = str(tmp_path / f"{pkg}.hdf")
        fn(out[pkg], n_train=8, n_valid=n_valid, seed=0, wave_duration=8.0,
           **({"device": "cpu"} if pkg == "port" else {}))
        assert not os.path.exists(out[pkg] + ".tmp")
    got, want = _walk(out["port"]), _walk(out["gwkit"])
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "/":
            continue
        assert got[k][0].shape == want[k][0].shape and got[k][0].dtype == np.float32
        if k.endswith("waveforms"):
            for i, (g, w) in enumerate(zip(got[k][0], want[k][0])):
                _close(g, w, WAVE_TOL, f"{k}[{i}]")
        elif len(want[k][0]):
            _close(got[k][0], want[k][0], NOISE_TOL, k)
    assert got["training/noises"][0].shape == (8, 2, 2048)
    assert got["validation/noises"][0].shape == (n_valid, 2, 2048)


def test_hdf5_helpers_are_gwkit_s(tmp_path):
    data = {"a": np.arange(5.0), "b": np.ones((2, 3), np.float32)}
    for writer, reader in ((hdf5, gw_hdf5), (gw_hdf5, hdf5)):
        path = str(tmp_path / f"{writer.__name__}.hdf")
        writer.write_datasets(path, data, attrs={"dataset": 2})
        back = reader.read_datasets(path)
        assert sorted(back) == ["a", "b"]
        for k in data:
            np.testing.assert_array_equal(back[k], data[k])
        assert reader.read_datasets(path, ["b"]).keys() == {"b"}
        with h5py.File(path) as f:
            assert f.attrs["dataset"] == 2
    hdf5.check_file_existence(str(tmp_path / "missing.hdf"), False)
    with pytest.raises(IOError, match="--force"):
        hdf5.check_file_existence(path, False)
    hdf5.check_file_existence(path, True)


# ---------------------------------------------------------------- the CLI

def _cli_both(argv_for):
    from gwkit.cli import generate_data as gw_cli
    from gwkit_torch.cli import generate_data as cli

    gw_cli.main(argv_for("gwkit"))
    cli.main(["--cpu"] + argv_for("port"))


def test_cli_challenge_population_matches_gwkit(tmp_path, monkeypatch):
    """`challenge --population` (tests/test_population.py's round trip) on
    both CLIs: the injection files bit for bit, the backgrounds from the
    same draws within 1e-5."""
    SameDraws(monkeypatch)
    ini = tmp_path / "custom.ini"
    ini.write_text(DS2_LIKE_INI)
    _cli_both(lambda pkg: ["--seed", "11", "challenge", "-d", "2", "--population", str(ini),
                           "-f", str(tmp_path / f"{pkg}_fg.hdf"), "-b", str(tmp_path / f"{pkg}_bg.hdf"),
                           "-i", str(tmp_path / f"{pkg}_inj.hdf"), "--duration", "200", "--sample-rate", "512"])
    a, b = _walk(str(tmp_path / "port_inj.hdf")), _walk(str(tmp_path / "gwkit_inj.hdf"))
    assert sorted(a) == sorted(b) and a["mass1"][0].max() <= 20.0
    for k in b:
        if k != "/":
            np.testing.assert_array_equal(a[k][0], b[k][0], err_msg=k)
    a, b = _walk(str(tmp_path / "port_bg.hdf")), _walk(str(tmp_path / "gwkit_bg.hdf"))
    for k in b:
        if k != "/":
            _close(a[k][0], b[k][0], NOISE_TOL, k)


def test_cli_training_and_glitch_match_gwkit(tmp_path, monkeypatch):
    """`training` (noise from the same draws) and the synthetic `glitch`
    corpus (numpy: bit for bit) on both CLIs."""
    SameDraws(monkeypatch)
    _cli_both(lambda pkg: ["--seed", "1", "training", "-o", str(tmp_path / f"{pkg}_train.hdf"), "--n-train", "4",
                           "--n-valid", "2"])
    got, want = _walk(str(tmp_path / "port_train.hdf")), _walk(str(tmp_path / "gwkit_train.hdf"))
    assert sorted(got) == sorted(want)
    for k in want:
        if k != "/" and len(want[k][0]):
            _close(got[k][0], want[k][0], WAVE_TOL if k.endswith("waveforms") else NOISE_TOL, k)
    _cli_both(lambda pkg: ["--seed", "4", "glitch", "-o", str(tmp_path / f"{pkg}_glitch.hdf"), "--n-per-class", "2"])
    got, want = _walk(str(tmp_path / "port_glitch.hdf")), _walk(str(tmp_path / "gwkit_glitch.hdf"))
    assert sorted(got) == sorted(want) == ["/", "labels", "strain"]
    for k in ("labels", "strain"):
        np.testing.assert_array_equal(got[k][0], want[k][0])


def test_cli_refusals_are_gwkit_s(tmp_path):
    from gwkit_torch.cli import generate_data as cli

    existing = tmp_path / "fg.hdf"
    existing.write_text("x")
    with pytest.raises(IOError, match="--force"):
        cli.main(["--cpu", "challenge", "-f", str(existing), "-b", str(tmp_path / "b.hdf"),
                  "-i", str(tmp_path / "i.hdf")])
    with pytest.raises(SystemExit, match="dataset 4 needs"):
        cli.main(["--cpu", "challenge", "-d", "4", "-f", str(tmp_path / "f4.hdf"), "-b", str(tmp_path / "b4.hdf"),
                  "-i", str(tmp_path / "i4.hdf")])
    a = cli.parse_args(["challenge", "-f", "f.hdf", "-b", "b.hdf", "-i", "i.hdf", "--population", "pop.ini"])
    assert a.population == "pop.ini" and a.mode == "challenge"
    assert cli.parse_args(["training", "-o", "t.hdf", "--population", "pop.json"]).population == "pop.json"
