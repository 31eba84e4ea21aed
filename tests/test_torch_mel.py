"""Port parity for the Whisper log-mel front end: ``gwkit_torch.ops``'s
stft, resample and mel against gwkit's on the same numpy inputs (f32 on the
CPU).

Tolerances: the filter bank and the window are numpy copies (atol 1e-12);
the STFT power and the resampler are f32 FFTs of two libraries (rtol 1e-5
of the largest value); the log-mel 2e-3 absolute, gwkit's own bound
against float64 (tests/test_mel.py): at bins 1e-8 of the peak power, which
the max - 8 clamp keeps, f32 FFT rounding is about 2e-4 in log10. The
fast path against the padded full path: 1e-5, as gwkit holds its own.
"""
import numpy as np
import pytest
import torch

from gwkit.ops import mel as gw_mel
from gwkit.ops import resample as gw_resample
from gwkit.ops import stft as gw_stft
from gwkit_torch.ops import mel, resample, stft


def test_hann_window_and_filter_bank_are_gwkit_s():
    for n, periodic in ((400, True), (400, False), (64, True)):
        np.testing.assert_allclose(stft.hann_window(n, periodic), gw_stft.hann_window(n, periodic),
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(mel.mel_filter_bank(), gw_mel.mel_filter_bank(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(mel.mel_filter_bank(129, 40, 20.0, 1000.0, 2048),
                               gw_mel.mel_filter_bank(129, 40, 20.0, 1000.0, 2048), rtol=0, atol=1e-12)


def test_frame_and_stft_power_match_gwkit():
    x = np.random.default_rng(0).normal(size=(2, 3, 2000)).astype(np.float32)
    np.testing.assert_array_equal(stft.frame(torch.from_numpy(x), 9, 400, 160).numpy(),
                                  np.asarray(gw_stft.frame(x, 9, 400, 160)))
    got = stft.stft_power(torch.from_numpy(x), 9).numpy()
    want = np.asarray(gw_stft.stft_power(x, 9))
    assert got.shape == want.shape == (2, 3, 9, 201)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,num", [(2048, 16000), (2047, 16000), (2048, 2049), (16000, 2048), (16001, 2048),
                                   (1000, 333), (512, 512)])
def test_resample_fourier_matches_gwkit(n, num):
    """Up and down, odd and even lengths: scipy's Nyquist conventions."""
    x = np.random.default_rng(n + num).normal(size=(3, n)).astype(np.float32)
    got = resample.resample_fourier(torch.from_numpy(x), num).numpy()
    want = np.asarray(gw_resample.resample_fourier(x, num))
    assert got.shape == want.shape == (3, num)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_resample_timeseries_matches_gwkit():
    x = np.random.default_rng(1).normal(size=(2, 2, 2048)).astype(np.float32)
    got = resample.resample_timeseries(torch.from_numpy(x)).numpy()
    want = np.asarray(gw_resample.resample_timeseries(x))
    assert got.shape == want.shape == (2, 2, 16000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n", [16000, 4096, 479900])
def test_whisper_log_mel_matches_gwkit(n):
    """16000 and 4096 take the fast path, 479900 the full reflect-padded one."""
    audio = np.random.default_rng(n).normal(size=(2, n)).astype(np.float32)
    got = mel.whisper_log_mel(torch.from_numpy(audio)).numpy()
    want = np.asarray(gw_mel.whisper_log_mel(audio))
    assert got.shape == want.shape == (2, 80, 3000)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_whisper_log_mel_short_context_matches_gwkit():
    audio = np.random.default_rng(3).normal(size=(3, 16000)).astype(np.float32)
    got = mel.whisper_log_mel(torch.from_numpy(audio), pad_to=256 * 160, num_frames=256).numpy()
    want = np.asarray(gw_mel.whisper_log_mel(audio, pad_to=256 * 160, num_frames=256))
    assert got.shape == want.shape == (3, 80, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    single = mel.whisper_log_mel(torch.from_numpy(audio[0]), pad_to=256 * 160, num_frames=256)
    assert single.shape == (80, 256)
    with pytest.raises(ValueError, match="exceeds pad_to"):
        mel.whisper_log_mel(torch.zeros(2, 256 * 160 + 1), pad_to=256 * 160, num_frames=256)


def test_fast_path_equals_full_path():
    audio = np.random.default_rng(4).normal(size=(2, 16000)).astype(np.float32)
    fast = mel.whisper_log_mel(torch.from_numpy(audio)).numpy()
    padded = np.zeros((2, 480000), np.float32)
    padded[:, :16000] = audio
    full = mel.whisper_log_mel(torch.from_numpy(padded)).numpy()
    np.testing.assert_allclose(fast, full, rtol=0, atol=1e-5)
