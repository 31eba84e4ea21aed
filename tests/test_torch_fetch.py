"""Port parity for the real-data ingestion layer (``gwkit_torch.data.fetch``):
``tests/test_fetch.py``'s cases on the port, with the same fake fetch
functions and the same local byte-range HTTP server, and the outputs held
against gwkit's on the same fake data. Nothing here leaves the machine:
gwpy is blocked, and every URL is the local server's.

Tolerances: CSV rows, labels, SNRs, event files and downloads bit for bit;
the whitened glitch windows (two FFT libraries in float32, then one scipy
filter) within 1e-4 of the largest value.
"""
import sys
import urllib.request

import h5py
import numpy as np
import pytest
from test_fetch import _challenge_noise_bytes, _fake_fetch_factory, _serve
from test_torch_generate import _close

from gwkit.data import fetch as gw_fetch
from gwkit_torch.data import fetch
from gwkit_torch.data.glitch import CLASS_TO_INDEX


def test_read_gravityspy_csv_is_gwkit_s(tmp_path):
    p = tmp_path / "Koi_Fish_O3a.csv"
    p.write_text("GPStime,snr,ifo\n1238166018.0,12.5,H1\n1238166100.5,8.0,L1\n")
    p2 = tmp_path / "whatever.csv"
    p2.write_text("GPStime,snr,ifo,label\n100.0,9.0,H1,Tomte\n")
    p3 = tmp_path / "no_class.csv"
    p3.write_text("GPStime\n5.0\n")
    rows = fetch.read_gravityspy_csv(str(p))
    assert [r["label"] for r in rows] == ["Koi Fish", "Koi Fish"] and rows[1]["ifo"] == "L1"
    for path, label in ((p, None), (p2, None), (p3, None), (p, "Blip")):
        assert fetch.read_gravityspy_csv(str(path), label) == gw_fetch.read_gravityspy_csv(str(path), label)


def test_fetch_glitch_window_matches_gwkit():
    fake = _fake_fetch_factory()
    for gps, ifo in ((1238166018.0, "H1"), (1238166100.5, "L1")):
        row = {"GPStime": gps, "snr": 10.0, "ifo": ifo}
        got = fetch.fetch_glitch_window(row, fake, device="cpu")
        want = gw_fetch.fetch_glitch_window(row, fake)
        assert got is not None and got.shape == want.shape == (2048,) and got.dtype == np.float32
        _close(got, want, 1e-4, f"{ifo} @ {gps}")
        assert abs(int(np.argmax(np.abs(got))) - int(0.8 * 2048)) < 120  # the trigger 0.8 s into the window

    def failing(ifo, a, b):
        raise ValueError("no data")

    assert fetch.fetch_glitch_window({"GPStime": 1.0, "snr": 0, "ifo": "H1"}, failing, device="cpu") is None

    def nans(ifo, a, b):
        return np.full(int((b - a) * 2048), np.nan), 2048.0

    assert fetch.fetch_glitch_window({"GPStime": 1.0, "snr": 0, "ifo": "H1"}, nans, device="cpu") is None


def test_build_gravityspy_corpus_matches_gwkit(tmp_path):
    (tmp_path / "Blip.csv").write_text("GPStime,snr,ifo\n1238166018.0,12.5,H1\n1238166100.5,8.0,L1\n")
    (tmp_path / "Tomte.csv").write_text("GPStime,snr,ifo\n1238167000.0,9.0,H1\n1238167100.0,7.0,H1\n")
    (tmp_path / "Mystery.csv").write_text("GPStime,snr,ifo\n1238168000.0,9.0,H1\n")  # unknown class: skipped
    csvs = [str(tmp_path / n) for n in ("Blip.csv", "Tomte.csv", "Mystery.csv")]
    out = {pkg: str(tmp_path / f"{pkg}.hdf") for pkg in ("port", "gwkit")}
    n = fetch.build_gravityspy_corpus(csvs, out["port"], fetch_fn=_fake_fetch_factory(), max_rows_per_file=1,
                                      device="cpu")
    assert n == gw_fetch.build_gravityspy_corpus(csvs, out["gwkit"], fetch_fn=_fake_fetch_factory(),
                                                 max_rows_per_file=1) == 2
    with h5py.File(out["port"]) as f, h5py.File(out["gwkit"]) as g:
        assert sorted(f) == sorted(g) == ["SNR", "labels", "strain"]
        assert list(f["labels"][()]) == [CLASS_TO_INDEX["Blip"], CLASS_TO_INDEX["Tomte"]]
        for k in ("labels", "SNR"):
            assert f[k].dtype == g[k].dtype
            np.testing.assert_array_equal(f[k][()], g[k][()])
        _close(f["strain"][()], g["strain"][()], 1e-4, "strain")
    with pytest.raises(IOError, match="no valid rows"):
        fetch.build_gravityspy_corpus([csvs[2]], str(tmp_path / "none.hdf"), fetch_fn=_fake_fetch_factory(),
                                      device="cpu")


def test_fetch_event_file_is_gwkit_s(tmp_path):
    events = {"GW150914": 1126259462.4, "GW190521": 1242442967.4}
    for pkg in (fetch, gw_fetch):
        pkg.fetch_event_file(events, str(tmp_path / f"{pkg.__name__}.hdf"), fetch_fn=_fake_fetch_factory())
    with h5py.File(tmp_path / f"{fetch.__name__}.hdf") as f, h5py.File(tmp_path / f"{gw_fetch.__name__}.hdf") as g:
        assert sorted(f) == sorted(g) == sorted(events)
        for name in events:
            assert f[name].attrs["gps"] == g[name].attrs["gps"] == events[name]
            assert sorted(f[name]) == sorted(g[name]) == ["h1_strain", "l1_strain"]
            for k in f[name]:
                assert f[name][k].shape == (16 * 2048,)
                np.testing.assert_array_equal(f[name][k][()], g[name][k][()])


def test_gwpy_fetch_gated(monkeypatch):
    monkeypatch.setitem(sys.modules, "gwpy", None)  # no gwpy, so no network either
    monkeypatch.setitem(sys.modules, "gwpy.timeseries", None)
    with pytest.raises(RuntimeError, match="gwpy is required"):
        fetch.gwpy_fetch("H1", 0.0, 1.0)
    assert fetch.REAL_NOISE_URL == gw_fetch.REAL_NOISE_URL


@pytest.mark.parametrize("cut,honor_range", [(1500, True), (None, False)])
def test_download_file_resumes_and_restarts(cut, honor_range, tmp_path):
    """Interrupted transfers resume by Range headers; a server that ignores
    the range restarts the file instead of appending a second copy."""
    payload = _challenge_noise_bytes(tmp_path)
    dest = tmp_path / "dl.hdf"
    if not honor_range:
        dest.write_bytes(payload[:1000])  # a stale partial from an earlier attempt
    with _serve(payload, max_bytes_per_request=cut, honor_range=honor_range) as (url, handler):
        size = fetch.download_file(url, str(dest), chunk_size=512)
    assert size == len(payload) and dest.read_bytes() == payload
    assert len(handler.range_requests) >= (2 if cut else 1)
    assert handler.range_requests[0].startswith("bytes=")


def test_download_file_stalls_and_completes(tmp_path):
    payload = _challenge_noise_bytes(tmp_path)
    dest = tmp_path / "dl.hdf"
    dest.write_bytes(payload)
    with _serve(payload) as (url, handler):  # range at EOF: 416, already complete
        assert fetch.download_file(url, str(dest)) == len(payload)
    with _serve(payload, max_bytes_per_request=0) as (url, handler):  # no progress at all
        with pytest.raises(IOError, match="stalled"):
            fetch.download_file(url, str(tmp_path / "never.hdf"), max_stalls=2)


def test_download_real_noise_kill_and_resume(tmp_path, monkeypatch):
    """A transfer killed mid-flight leaves a partial file; a second run
    finishes it in place."""
    payload = _challenge_noise_bytes(tmp_path)
    dest = str(tmp_path / "real_noise_file.hdf")
    with _serve(payload, max_bytes_per_request=1200) as (url, handler):
        reads = {"n": 0}
        orig = urllib.request.urlopen

        def dying_urlopen(req, timeout=None):
            reads["n"] += 1
            if reads["n"] > 1:
                raise KeyboardInterrupt  # the process is killed after the first request
            return orig(req, timeout=timeout)

        monkeypatch.setattr(urllib.request, "urlopen", dying_urlopen)
        with pytest.raises(KeyboardInterrupt):
            fetch.download_file(url, dest, chunk_size=512)
        monkeypatch.setattr(urllib.request, "urlopen", orig)
        assert 0 < len(open(dest, "rb").read()) < len(payload)
        assert fetch.download_real_noise(dest, url=url) == dest
    assert open(dest, "rb").read() == payload
    assert any(r.startswith("bytes=") for r in handler.range_requests)


def test_download_real_noise_redownloads_or_skips(tmp_path):
    payload = _challenge_noise_bytes(tmp_path)
    dest = tmp_path / "real_noise_file.hdf"
    dest.write_bytes(b"\x00" * len(payload))  # full size, unreadable: downloaded anew
    with _serve(payload) as (url, handler):
        assert fetch.download_real_noise(str(dest), url=url) == str(dest)
    assert dest.read_bytes() == payload
    with h5py.File(dest) as f:
        assert set(f.keys()) == {"H1", "L1"}
    # a readable file is kept: no request is made (nothing listens at this port)
    assert fetch.download_real_noise(str(dest), url="http://127.0.0.1:1/nope.hdf") == str(dest)
