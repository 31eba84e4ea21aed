"""Port parity for the glitch corpora (the synthesis half of
``gwkit_torch/data/glitch.py``) against gwkit's on the CPU.

Tolerances: the morphologies and the synthetic corpus are numpy copies,
equal bit for bit. ``preprocess_glitch_strain`` whitens by two FFT
libraries in float32, then filters with the same scipy call: within 1e-4
of the largest value, with a known and with an estimated PSD, on white
strain with a transient (gwkit's own test input). The realistic corpus
takes its noise from the same numpy draws in both packages (gwkit's
``colored_noise`` and the port's ``seeded_draws`` substituted). Its
data-estimated whitening of colored noise is ill-conditioned in float32:
moving the port's own draws by one ulp moves the corpus by 2.5e-3-6.8e-3
of its largest value and the achieved SNRs by 2.3e-3-3.6e-2 (two draws
measured), and gwkit's float32 output differs from the port's by as much
(5.2e-3-8.4e-3 and 2.1e-3-3.1e-2). So the test measures that move on its
own draws and holds the gap to gwkit within REALISTIC_CONDITIONING = 3
times it; the labels, the order and the calibrated targets exactly, the
median crop within 1e-3 of its max. Its calibration gate is gwkit's own
test, on the port.
"""
import numpy as np
import pytest
import torch
from test_torch_generate import SameDraws, _close

from gwkit.data import glitch as gw_glitch
from gwkit.ops.psd import get_psd
from gwkit_torch.data import glitch

REALISTIC_CONDITIONING = 3.0


def test_morphologies_and_synthetic_corpus_are_gwkit_s():
    assert glitch.GLITCH_CLASSES == gw_glitch.GLITCH_CLASSES
    assert glitch.CLASS_MEDIAN_SNR == gw_glitch.CLASS_MEDIAN_SNR
    for cls in glitch.GLITCH_CLASSES:
        for sr in (1024.0, 2048.0):
            a = glitch.synthesize_glitch(np.random.default_rng(3), cls, 1.0, sr)
            b = gw_glitch.synthesize_glitch(np.random.default_rng(3), cls, 1.0, sr)
            np.testing.assert_array_equal(a, b, err_msg=cls)
    t = np.arange(512) / 512.0
    np.testing.assert_array_equal(glitch._sine_gaussian(t, 80.0, 3.0, 0.5, 2.0, 0.3),
                                  gw_glitch._sine_gaussian(t, 80.0, 3.0, 0.5, 2.0, 0.3))
    for kw in ({}, {"seed": 4, "noise_sigma": 0.5, "sample_rate": 1024.0}):
        (x, y), (xw, yw) = glitch.synthetic_glitch_dataset(3, **kw), gw_glitch.synthetic_glitch_dataset(3, **kw)
        assert x.dtype == xw.dtype and y.dtype == yw.dtype
        np.testing.assert_array_equal(x, xw)
        np.testing.assert_array_equal(y, yw)


@pytest.mark.parametrize("psd", ["estimated", "known", "known_tensor"])
def test_preprocess_glitch_strain_matches_gwkit(psd):
    sr, span = 1024.0, 8.0
    n = int(sr * span)
    x = np.random.default_rng(0).normal(size=(3, n)).astype(np.float32) * 1e-21
    x[1] += 5e-21 * np.sin(2 * np.pi * 90.0 * np.arange(n) / sr) * np.exp(-((np.arange(n) - n / 2) / 300.0) ** 2)
    p = get_psd("aLIGOZeroDetHighPower", n // 2 + 1, 1.0 / span, 15.0)
    p = p / p[p > 0].mean()
    kw = {} if psd == "estimated" else {"psd": p}
    port_kw = {} if psd == "estimated" else {"psd": torch.from_numpy(p.astype(np.float32)) if psd == "known_tensor"
                                               else p}
    y = x * 1e21 if psd != "estimated" else x  # a known normalized PSD goes with unit-scale strain
    for crop in (1.0, None):
        got = glitch.preprocess_glitch_strain(y, sr, crop_duration=crop, device="cpu", **port_kw)
        want = gw_glitch.preprocess_glitch_strain(y, sr, crop_duration=crop, **kw)
        assert got.dtype == np.float32 and got.shape == want.shape
        _close(got, want, 1e-4, f"crop {crop}")
    # a tensor is whitened on its own device
    got = glitch.preprocess_glitch_strain(torch.from_numpy(y), sr, **port_kw)
    _close(got, gw_glitch.preprocess_glitch_strain(y, sr, **kw), 1e-4, "tensor input")


def test_realistic_glitch_dataset_matches_gwkit(monkeypatch):
    """The corpus from the same draws as gwkit's: labels and order exact,
    the calibrated targets exact but for rounding, the median crop within
    1e-3 of its max; the crops and the achieved SNRs no farther from
    gwkit's than REALISTIC_CONDITIONING times the distance the port's own
    output moves when its draws move by one float32 ulp (plus 1e-4 of the
    largest value)."""
    draws = SameDraws(monkeypatch)
    kw = dict(seed=2, sample_rate=1024.0, batch=3, return_achieved=True)
    x, y, (ach, tgt) = glitch.realistic_glitch_dataset(3, device="cpu", **kw)
    xw, yw, (achw, tgtw) = gw_glitch.realistic_glitch_dataset(3, **kw)
    draws.k["port"], draws.ulp = 0, True
    xm, ym, (achm, _) = glitch.realistic_glitch_dataset(3, device="cpu", **kw)
    assert x.shape == xw.shape == (33, 1024) and x.dtype == np.float32
    np.testing.assert_array_equal(y, yw)
    np.testing.assert_array_equal(ym, y)
    _close(tgt, tgtw, 1e-12, "target SNR")
    assert np.median(np.abs(x - xw).max(-1) / np.abs(xw).max(-1)) <= 1e-3
    for what, got, want, moved in (("strain", x, xw, xm), ("achieved SNR", ach, achw, achm)):
        gap, own = np.abs(got - want).max(), np.abs(got - moved).max()
        assert 0 < own and gap <= REALISTIC_CONDITIONING * own + 1e-4 * np.abs(want).max(), (what, gap, own)


def test_realistic_glitch_snr_calibration():
    """gwkit's calibration gate on the port: the achieved post-pipeline SNR
    (through the data-estimated whitening) tracks the per-class target."""
    x, y, (ach, tgt) = glitch.realistic_glitch_dataset(6, seed=1, sample_rate=1024.0, return_achieved=True,
                                                       device="cpu")
    assert x.shape == (66, 1024) and np.isfinite(x).all()
    glitchy = tgt > 0
    ratio = ach[glitchy] / tgt[glitchy]
    assert 0.5 < float(np.median(ratio)) < 2.0
    assert float(np.quantile(ratio, 0.9) / np.quantile(ratio, 0.1)) < 2.0
    assert np.all(tgt[y == glitch.GLITCH_CLASSES.index("No Glitch")] == 0.0)
