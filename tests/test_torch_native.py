"""The port's host-IO runtime (``gwkit_torch/native/hostio.py`` over its own
copy of the C++ source) against numpy and gwkit's bindings
(``tests/test_native.py``), bit for bit; and the slicer's readers over it:
the native stream equal to eager reads and to gwkit's readers, with
``key_filter``, each reading mode against the same gwkit mode on a file
whose ``delta_t`` is not a power of two."""
import logging

import h5py
import numpy as np
import pytest

import gwkit.native.hostio as gw_io
import gwkit.search.slicer as gw_slicer
import gwkit_torch.native.hostio as io
from gwkit_torch.search import slicer

needs_native = pytest.mark.skipif(not io.available(), reason="g++ unavailable")


def test_f64_to_f32_matches_numpy_and_gwkit(rng):
    x = rng.normal(size=(3, 1001)) * np.logspace(-30, 30, 1001)
    got = io.f64_to_f32(x)
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got, x.astype(np.float32))
    np.testing.assert_array_equal(got, gw_io.f64_to_f32(x))


def test_extract_windows_matches_numpy_and_gwkit(rng):
    src = rng.normal(size=(2, 500)).astype(np.float32)
    starts = np.array([0, 100, 250, 372], np.int64)
    out = io.extract_windows(src, starts, 128)
    assert out.shape == (4, 2, 128)
    np.testing.assert_array_equal(out, np.stack([src[:, s: s + 128] for s in starts]))
    np.testing.assert_array_equal(out, gw_io.extract_windows(src, starts, 128))
    with pytest.raises(ValueError, match="leaves"):
        io.extract_windows(src, np.array([373]), 128)


@needs_native
@pytest.mark.parametrize("dtype,chunk", [(np.float64, 9999), (np.float32, 1 << 22)])
def test_chunk_loader_matches_numpy_and_gwkit(tmp_path, rng, dtype, chunk):
    data = rng.normal(size=100_000).astype(dtype)
    path = str(tmp_path / "raw.bin")
    with open(path, "wb") as f:
        f.write(b"\0" * 24)  # a header the offset skips
        data.tofile(f)
    loader = io.ChunkLoader(path, 24, len(data), on_disk_f64=dtype == np.float64, chunk_elems=chunk)
    chunks = list(loader)
    loader.close()
    assert all(len(c) <= chunk for c in chunks)
    out = np.concatenate(chunks)
    np.testing.assert_array_equal(out, data.astype(np.float32))
    gw = gw_io.ChunkLoader(path, 24, len(data), on_disk_f64=dtype == np.float64, chunk_elems=chunk)
    np.testing.assert_array_equal(out, np.concatenate(list(gw)))
    gw.close()


@needs_native
def test_array_prefetch_matches_numpy_and_gwkit(tmp_path, rng):
    d64 = rng.normal(size=(2, 30_000))
    path = str(tmp_path / "raw.bin")
    d64.tofile(path)
    a, b = io.ArrayPrefetch(path, 0, (2, 30_000), True), io.ArrayPrefetch(path, 8 * 30_000, (30_000,), True)
    np.testing.assert_array_equal(b.wait(), d64[1].astype(np.float32))  # waited out of issue order
    got = a.wait()
    np.testing.assert_array_equal(got, np.fromfile(path).astype(np.float32).reshape(2, -1))
    np.testing.assert_array_equal(got, gw_io.ArrayPrefetch(path, 0, (2, 30_000), True).wait())
    short = io.ArrayPrefetch(path, 8, (2, 30_000), True)  # one element past the end
    with pytest.raises(IOError, match="prefetch read"):
        short.wait()


@needs_native
def test_read_contiguous_dataset_contiguous_chunked_and_f32(tmp_path, rng):
    path = str(tmp_path / "seg.hdf")
    data = rng.normal(size=(2, 50_000))
    with h5py.File(path, "w") as f:
        f.create_dataset("H1", data=data)  # contiguous by default
        f.create_dataset("chunked", data=data[0], chunks=(1000,))
        f.create_dataset("gzip", data=data[0], chunks=(1000,), compression="gzip")
        f.create_dataset("f32", data=data[0].astype(np.float32))
    with h5py.File(path, "r") as f:
        out = io.read_contiguous_dataset(path, f["H1"])
        np.testing.assert_array_equal(out, data.astype(np.float32))
        np.testing.assert_array_equal(out, gw_io.read_contiguous_dataset(path, f["H1"]))
        for name in ("chunked", "gzip", "f32"):  # not the fast path, as in gwkit
            assert io.read_contiguous_dataset(path, f[name]) is None
            assert gw_io.read_contiguous_dataset(path, f[name]) is None
        assert io.dataset_prefetch_meta(f["f32"])[1:] == ((50_000,), False)
        for name in ("H1", "chunked", "gzip", "f32"):
            assert io.dataset_prefetch_meta(f[name]) == gw_io.dataset_prefetch_meta(f[name])


def test_failed_build_is_logged_and_numpy_takes_over(tmp_path, monkeypatch, caplog, rng):
    """No C++ library: the numpy fallbacks give the same values, the readers
    refuse, and the compiler's error is in the log."""
    bad = tmp_path / "hostio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(io, "SOURCE", bad)
    monkeypatch.setattr(io, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(io, "_lib", None)
    monkeypatch.setattr(io, "_build_failed", False)
    with caplog.at_level(logging.WARNING):
        assert not io.available()
    assert any("g++" in r.getMessage() and "hostio.cpp" in r.getMessage() for r in caplog.records)
    x = rng.normal(size=(2, 300))
    np.testing.assert_array_equal(io.f64_to_f32(x), x.astype(np.float32))
    np.testing.assert_array_equal(io.extract_windows(x, np.array([5, 50]), 64),
                                  np.stack([x[:, 5:69], x[:, 50:114]]).astype(np.float32))
    with pytest.raises(RuntimeError, match="unavailable"):
        io.ArrayPrefetch(str(tmp_path / "x"), 0, (4,), True)


# ---------------------------------------------------------------------------
# The slicer's readers
# ---------------------------------------------------------------------------

DELTA_T = 0.000488005  # not a power of two: 1/(1/attr) != attr, so each mode shows


def _search_file(path, rng, chunked=False, delta_t=1.0 / 2048):
    with h5py.File(path, "w") as f:
        for det in ("H1", "L1"):
            g = f.create_group(det)
            for i, n in enumerate((40_000, 90_000, 10_000, 60_000)):
                kw = dict(chunks=(5000,)) if chunked else {}
                ds = g.create_dataset(f"seg{i}", data=rng.normal(size=n), **kw)
                ds.attrs["start_time"] = 1000.0 * i
                ds.attrs["delta_t"] = delta_t
    return path


def _same(got, want):
    assert [s.key for s in got] == [s.key for s in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.strain, b.strain)
        assert (a.start_time, a.delta_t, a.strain.dtype) == (b.start_time, b.delta_t, np.float32)


@needs_native
@pytest.mark.parametrize("chunked", [False, True])
def test_readers_match_gwkit_mode_by_mode(tmp_path, rng, chunked):
    """Eager against gwkit's eager reader and streaming against gwkit's
    streaming reader (the C++ prefetcher on a contiguous file, the reader
    thread on a chunked one), with and without a key filter, on a
    non-power-of-two delta_t: the eager readers take 1/(1/attr), the
    streaming ones the attribute itself, in both packages."""
    path = _search_file(str(tmp_path / "s.hdf"), rng, chunked, DELTA_T)
    assert 1.0 / (1.0 / DELTA_T) != DELTA_T
    assert slicer.native_streamable(path) == gw_slicer.native_streamable(path) == (not chunked)
    for key_filter in (None, lambda i, key: i % 2 == 1):
        eager = slicer.read_segments(path, key_filter=key_filter)
        streamed = list(slicer.stream_segments(path, key_filter=key_filter))
        _same(eager, gw_slicer.read_segments(path, key_filter=key_filter))
        _same(streamed, list(gw_slicer.stream_segments(path, key_filter=key_filter)))
        want_keys = ["seg1", "seg3", "seg0", "seg2"]  # longest first
        assert [s.key for s in eager] == (want_keys if key_filter is None else want_keys[1::2])
        for a, b in zip(eager, streamed):
            np.testing.assert_array_equal(a.strain, b.strain)
            assert a.delta_t == 1.0 / (1.0 / DELTA_T) and b.delta_t == DELTA_T


@needs_native
def test_stream_prefetch_depth_and_early_stop(tmp_path, rng):
    """Reading two segments ahead gives the same stream; a consumer that
    stops after the first segment leaves no read in flight."""
    path = _search_file(str(tmp_path / "s.hdf"), rng)
    _same(list(slicer.stream_segments(path, prefetch=2)), slicer.read_segments(path))
    it = slicer.stream_segments(path, prefetch=2)
    assert next(it).key == "seg1"
    it.close()


def test_native_streamable_refuses_mismatched_keys(tmp_path, rng):
    path = str(tmp_path / "s.hdf")
    with h5py.File(path, "w") as f:
        for det, keys in (("H1", ("a", "b")), ("L1", ("a",))):
            g = f.create_group(det)
            for k in keys:
                g.create_dataset(k, data=rng.normal(size=100))
    assert slicer.native_streamable(path) is False
    assert gw_slicer.native_streamable(path) is False
