"""Whisper's log-mel front end at any number of mel bins (80 for Whisper up
to large-v2, 128 for large-v3), computed in full as ``reference.mel``
computes its 80: Fourier resampling to 16 kHz (``mel.resample``), zero
padding to ``frames`` * 160 samples, a centred STFT (n_fft 400, hop 160,
periodic hann, reflect padding), the slaney mel bank (``n_mels`` filters,
0-8 kHz), log10 with a 1e-10 floor, the per-sample clamp at max - 8 and
(x + 4) / 4."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gwbench.reference.mel import HOP, N_FFT, RATE, resample


def mel_bank(n_mels: int) -> np.ndarray:
    """(201, n_mels) slaney-scale, slaney-normalized triangular filters."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-30) / 1000.0) * 27.0 / np.log(6.4), 3.0 * f / 200.0)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), 200.0 * m / 3.0)

    fft_freqs = np.linspace(0.0, RATE // 2, N_FFT // 2 + 1)
    edges = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(8000.0), n_mels + 2))
    lower = (fft_freqs[:, None] - edges[None, :-2]) / (edges[1:-1] - edges[:-2])
    upper = (edges[None, 2:] - fft_freqs[:, None]) / (edges[2:] - edges[1:-1])
    return np.maximum(0.0, np.minimum(lower, upper)) * (2.0 / (edges[2:] - edges[:-2]))[None, :]


def log_mel(audio: torch.Tensor, n_mels: int, frames: int = 3000) -> torch.Tensor:
    """(B, n) 16 kHz audio, n <= frames * 160 -> (B, n_mels, frames) in float32."""
    samples = frames * HOP
    x = F.pad(audio.float(), (0, samples - audio.shape[-1]))
    x = F.pad(x[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    framed = x.unfold(-1, N_FFT, HOP)[:, :frames]  # the last frame dropped
    n = np.arange(N_FFT)
    window = torch.from_numpy(0.5 - 0.5 * np.cos(2.0 * np.pi * n / N_FFT)).float().to(x.device)
    power = torch.fft.rfft(framed * window, dim=-1).abs() ** 2
    mel = power @ torch.from_numpy(mel_bank(n_mels)).float().to(x.device)  # (B, frames, n_mels)
    logs = torch.log10(mel.clamp(min=1e-10)).transpose(1, 2)
    logs = torch.maximum(logs, logs.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (logs + 4.0) / 4.0


def features(strain: torch.Tensor, rate: int, n_mels: int, frames: int = 3000) -> torch.Tensor:
    """(B, n) strain at ``rate`` Hz -> (B, n_mels, frames) log-mel."""
    return log_mel(resample(strain, strain.shape[-1] * RATE // rate).float(), n_mels, frames)
