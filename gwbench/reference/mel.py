"""Whisper's log-mel front end on 2048 Hz strain, computed in full:
Fourier resampling to 16 kHz (``scipy.signal.resample``'s even-length
conventions), zero padding to 30 s (``frames`` * 160 samples), a centred STFT (n_fft
400, hop 160, periodic hann, reflect padding) over all 3000 frames, the slaney mel bank
(80 filters, 0-8 kHz), log10 with a 1e-10 floor, the per-sample clamp at
max - 8 and (x + 4) / 4."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

N_FFT, HOP, N_MELS, RATE = 400, 160, 80, 16000


def resample(x: torch.Tensor, num: int) -> torch.Tensor:
    """float64 Fourier resampling of the last axis to ``num`` samples."""
    n = x.shape[-1]
    spec = torch.fft.rfft(x.double(), dim=-1)
    out = torch.zeros(*x.shape[:-1], num // 2 + 1, dtype=spec.dtype, device=x.device)
    keep = min(n, num) // 2 + 1
    out[..., :keep] = spec[..., :keep]
    if num > n and n % 2 == 0:
        out[..., n // 2] *= 0.5
    elif num < n and num % 2 == 0:
        out[..., num // 2] *= 2.0
    return torch.fft.irfft(out, num, dim=-1) * (num / n)


def mel_bank() -> np.ndarray:
    """(201, 80) slaney-scale, slaney-normalized triangular filters."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-30) / 1000.0) * 27.0 / np.log(6.4), 3.0 * f / 200.0)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), 200.0 * m / 3.0)

    fft_freqs = np.linspace(0.0, RATE // 2, N_FFT // 2 + 1)
    edges = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(8000.0), N_MELS + 2))
    lower = (fft_freqs[:, None] - edges[None, :-2]) / (edges[1:-1] - edges[:-2])
    upper = (edges[None, 2:] - fft_freqs[:, None]) / (edges[2:] - edges[1:-1])
    return np.maximum(0.0, np.minimum(lower, upper)) * (2.0 / (edges[2:] - edges[:-2]))[None, :]


def log_mel(audio: torch.Tensor, frames: int = 3000) -> torch.Tensor:
    """(B, n) 16 kHz audio, n <= frames * 160 -> (B, 80, frames) in float32
    (Whisper's 30 s context: 3000 frames)."""
    samples = frames * HOP
    x = F.pad(audio.float(), (0, samples - audio.shape[-1]))
    x = F.pad(x[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    framed = x.unfold(-1, N_FFT, HOP)[:, :frames]  # the last frame dropped
    n = np.arange(N_FFT)
    window = torch.from_numpy(0.5 - 0.5 * np.cos(2.0 * np.pi * n / N_FFT)).float().to(x.device)
    power = torch.fft.rfft(framed * window, dim=-1).abs() ** 2
    mel = power @ torch.from_numpy(mel_bank()).float().to(x.device)  # (B, 3000, 80)
    logs = torch.log10(mel.clamp(min=1e-10)).transpose(1, 2)
    logs = torch.maximum(logs, logs.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (logs + 4.0) / 4.0


def features(strain: torch.Tensor, rate: int, frames: int = 3000) -> torch.Tensor:
    """(B, n) strain at ``rate`` Hz -> (B, 80, frames) log-mel."""
    return log_mel(resample(strain, strain.shape[-1] * RATE // rate).float(), frames)
