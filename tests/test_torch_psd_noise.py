"""Port parity for data generation's host and spectral layer:
``gwkit_torch.data.detector``, the PSD builders of ``gwkit_torch.ops.psd``,
``inverse_spectrum_truncation``/``whiten_psd``, ``gwkit_torch.ops.snr`` and
``gwkit_torch.data.noise`` against gwkit's on the same inputs (CPU).

Tolerances: the detector geometry and the PSD builders are numpy copies,
equal bit for bit. The float32 spectral functions are FFTs of two
libraries: ``whiten_psd``, the SNRs and ``colored_noise`` from gwkit's own
``jax.random`` draws within 1e-5 of the largest value. The truncation's
output 1/|q~|^2 is ill-conditioned where the truncated inverse ASD q~ is
near zero (below the cutoff, where it is orders of magnitude above the
in-band level and float32 rounding of q~ moves it by far more than 1e-5),
so it is held as |q~|^2 to 1e-5 of the largest value and in band to 1e-5
relative. The generators are
held as gwkit's test holds its own (shape, seeding, physical scale, a Welch
PSD within 20% of the target); their streams are torch's, not jax's.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwkit.data import detector as gw_detector
from gwkit.data import noise as gw_noise
from gwkit.ops import psd as gw_psd
from gwkit.ops import snr as gw_snr
from gwkit.ops import whiten as gw_whiten
from gwkit_torch.data import detector, noise
from gwkit_torch.ops import psd, snr, whiten

FS, N = 1024.0, 4096
FLEN, DF = N // 2 + 1, FS / N


@pytest.mark.parametrize("det", ["H1", "L1", "V1"])
def test_detector_geometry_is_gwkit_s(det):
    rng = np.random.default_rng(0)
    ra, dec, pol = rng.uniform(0, 2 * np.pi, 64), np.arcsin(rng.uniform(-1, 1, 64)), rng.uniform(0, 2 * np.pi, 64)
    t = 1.25e9 + rng.uniform(0, 3e7, 64)
    for got, want in ((detector.antenna_pattern(det, ra, dec, pol, t), gw_detector.antenna_pattern(det, ra, dec, pol, t)),
                      ((detector.time_delay_from_earth_center(det, ra, dec, t),),
                       (gw_detector.time_delay_from_earth_center(det, ra, dec, t),)),
                      ((detector.gmst_rad(t),), (gw_detector.gmst_rad(t),))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    hp, hc = rng.normal(size=(64, 100)), rng.normal(size=(64, 100))
    np.testing.assert_array_equal(detector.project_wave(det, hp, hc, ra, dec, pol, t),
                                  gw_detector.project_wave(det, hp, hc, ra, dec, pol, t))
    for k in ("response", "location"):
        np.testing.assert_array_equal(detector.DETECTORS[det][k], gw_detector.DETECTORS[det][k])


@pytest.mark.parametrize("det,index", [("H1", 0), ("L1", 0), ("L1", 7), ("V1", 3)])
def test_psd_builders_are_gwkit_s(det, index):
    for flen, df, f_low in ((FLEN, DF, 15.0), (300 * 2048 // 2 + 1, 1 / 300.0, 9.0)):
        np.testing.assert_array_equal(psd.psd_variant(flen, df, f_low, det, index),
                                      gw_psd.psd_variant(flen, df, f_low, det, index))
    for name in psd.PSD_BUILDERS:
        np.testing.assert_array_equal(psd.get_psd(name, FLEN, DF, 12.0), gw_psd.get_psd(name, FLEN, DF, 12.0))
    np.testing.assert_array_equal(psd.flat_psd(FLEN, DF, 3.0, 10.0), gw_psd.flat_psd(FLEN, DF, 3.0, 10.0))
    assert sorted(psd.PSD_BUILDERS) == sorted(gw_psd.PSD_BUILDERS) and psd._PSD_LINES == gw_psd._PSD_LINES


def test_psd_file_and_named_cache_are_gwkit_s(tmp_path):
    f = np.linspace(5.0, 600.0, 400)
    path = os.path.join(tmp_path, "asd.txt")
    np.savetxt(path, np.stack([f, 1e-23 * (1 + (30.0 / f) ** 4)], 1))
    for is_asd in (True, False):
        np.testing.assert_array_equal(psd.load_psd_file(path, FLEN, DF, 11.0, is_asd),
                                      gw_psd.load_psd_file(path, FLEN, DF, 11.0, is_asd))
    np.testing.assert_array_equal(psd.get_psd(path, FLEN, DF), gw_psd.get_psd(path, FLEN, DF))
    with pytest.raises(ValueError, match="Unknown PSD"):
        psd.get_psd(os.path.join(tmp_path, "missing.txt"), FLEN, DF)
    cache, gw_cache = psd.NamedPSDCache([path]), gw_psd.NamedPSDCache([path])
    a = cache.get_from_timeseries(N, 1 / FS, 15.0)
    assert cache.get(FLEN, DF, 15.0) is a  # cached by (name, flen, delta_f, f_low)
    np.testing.assert_array_equal(a, gw_cache.get_from_timeseries(N, 1 / FS, 15.0))
    two = psd.NamedPSDCache(["flat", "aLIGOZeroDetHighPower"])
    with pytest.raises(ValueError, match="psd_name required"):
        two.get(FLEN, DF, 15.0)
    np.testing.assert_array_equal(two.get(FLEN, DF, 15.0, "flat"),
                                  gw_psd.NamedPSDCache(["flat"]).get(FLEN, DF, 15.0))


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_truncation_and_known_psd_whitening_match_gwkit():
    p = psd.psd_variant(FLEN, DF, 15.0, "H1", 2)
    core = p / p[p > 0].mean()
    got = whiten.inverse_spectrum_truncation(core, 512, 15.0, DF).numpy()
    want = np.asarray(gw_whiten.inverse_spectrum_truncation(core, 512, 15.0, DF))
    _close(1.0 / got, 1.0 / want, 1e-5)
    band = np.arange(FLEN) * DF >= 20.0
    np.testing.assert_allclose(got[band], want[band], rtol=1e-5)
    x = (np.random.default_rng(0).normal(size=(3, N)) * 1e-21).astype(np.float32)
    for f_low, mfd in ((20.0, 1.0), (15.0, 0.5)):
        got = whiten.whiten_psd(torch.from_numpy(x), p, 1 / FS, f_low, mfd).numpy()
        want = np.asarray(gw_whiten.whiten_psd(jnp.asarray(x), p, 1 / FS, f_low, mfd))
        assert got.shape == want.shape == (3, N - 2 * int(mfd * FS))
        _close(got, want, 1e-5)


def test_snr_matches_gwkit():
    p = psd.aligo_zdhp_psd(FLEN, DF, 15.0)
    pn = (p / p[p > 0].mean()).astype(np.float32)
    h = np.random.default_rng(1).normal(size=(2, 3, N)).astype(np.float32)
    for lo, hi in ((None, None), (20.0, None), (20.0, 300.0)):
        for fn in ("sigma_sq", "optimal_snr"):
            _close(getattr(snr, fn)(torch.from_numpy(h), torch.from_numpy(pn), 1 / FS, lo, hi).numpy(),
                   np.asarray(getattr(gw_snr, fn)(jnp.asarray(h), jnp.asarray(pn), 1 / FS, lo, hi)), 1e-5)
    per_det = np.random.default_rng(2).uniform(1, 20, (5, 2)).astype(np.float32)
    _close(snr.network_snr(torch.from_numpy(per_det)).numpy(), np.asarray(gw_snr.network_snr(per_det)), 1e-6)
    _close(snr.network_snr(torch.from_numpy(per_det), axis=0).numpy(),
           np.asarray(gw_snr.network_snr(per_det, axis=0)), 1e-6)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_colored_noise_from_gwkit_draws_matches_gwkit(batch):
    p = psd.psd_variant(FLEN, DF, 15.0, "L1", 1)
    pn = np.broadcast_to((p / p[p > 0].mean()).astype(np.float32), batch + (FLEN,))
    key = jax.random.PRNGKey(4)
    k1, k2 = jax.random.split(key)  # colored_noise's own split and draws
    a, b = (np.array(jax.random.normal(k, batch + (FLEN,))) for k in (k1, k2))
    want = np.asarray(gw_noise.colored_noise(key, N, 1 / FS, jnp.asarray(pn)))
    got = noise.colored_noise_core(torch.from_numpy(a), torch.from_numpy(b), N, 1 / FS, torch.from_numpy(pn.copy()))
    assert got.shape == want.shape == batch + (N,)
    _close(got.numpy(), want, 1e-5)


def test_noise_generators_seeding_scale_and_psd():
    gen = noise.NoiseGenerator(sample_rate=512.0, seed=7, chunk_samples=3, device="cpu")
    a = gen.get(4, 2.0)
    assert a.dtype == torch.float32 and a.device.type == "cpu" and a.shape == (4, 1024)
    assert torch.equal(a, noise.NoiseGenerator(sample_rate=512.0, seed=7, chunk_samples=3, device="cpu").get(4, 2.0))
    assert not torch.equal(a, noise.NoiseGenerator(sample_rate=512.0, seed=8, device="cpu").get(4, 2.0))
    assert 1e-24 < float(a.std()) < 1e-19  # physical scale restored
    # the target PSD, as gwkit's test holds its own colored_noise
    fs, n = 2048.0, 2048 * 32
    f = np.arange(n // 2 + 1) * (fs / n)
    target = 1.0 + 10.0 * np.exp(-(((f - 300) / 50.0) ** 2))
    target[f < 10] = 0.0
    x = noise.colored_noise(torch.Generator().manual_seed(0), n, 1 / fs, torch.from_numpy(target.astype(np.float32)))
    est = psd.welch_psd(x[None], 1 / fs, segment_duration=1.0)[0].numpy()
    f_est = np.arange(len(est)) * 1.0
    band = (f_est > 50) & (f_est < 900)
    assert 0.8 < np.median(est[band] / np.interp(f_est, f, target)[band]) < 1.2
    s = noise.NoiseGenerator("aLIGOZeroDetHighPower", 512.0, seed=1, device="cpu").stream(5.0, chunk_duration=2.0)
    assert s.shape == (2560,) and torch.isfinite(s).all()


def test_white_noise_generator():
    w = noise.WhiteNoiseGenerator(sample_rate=512.0, seed=0, device="cpu").get(8, 1.0)
    assert w.shape == (8, 512) and w.dtype == torch.float32
    assert abs(float(w.std()) - 1.0) < 0.05
    w2 = noise.WhiteNoiseGenerator(sample_rate=512.0, seed=0, sigma=3.0, device="cpu").get(8, 1.0)
    torch.testing.assert_close(w2, 3.0 * w, rtol=1e-6, atol=0)
