"""Whisper log-mel front end, batched on the tensor's device (counterpart
of ``gwkit/ops/mel.py``; ``transformers.WhisperFeatureExtractor``'s
semantics):

  pad audio with zeros to 30 s (480 000 samples at 16 kHz)
  -> STFT (n_fft 400, hop 160, periodic Hann, centred reflect padding, power 2)
  -> drop the final frame -> 3000 frames
  -> slaney mel filter bank (80 mels, 0..8 kHz) with a 1e-10 floor
  -> log10 -> clamp at (per-sample max - 8) -> (x + 4) / 4

As gwkit, the fast path computes only the frames that can touch real audio
(about 102 of 3000 for 1 s); every later frame is silence (power 0 -> the
floor -> log10 = -10) and is filled analytically. Inputs longer than
``pad_to - 200`` meet the reflect padding at the right edge and take the
full padded computation. The mel projection is a plain ``torch.einsum``
against the filter bank (gwkit computes it outside any Pallas kernel).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from gwkit_torch.ops.stft import stft_power
from gwkit_torch.utils.tracing import COUNTERS

N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
SAMPLE_RATE = 16000
CHUNK_LENGTH = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_LENGTH  # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000
_LOG_FLOOR = -10.0  # log10(1e-10)


def _hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    mels = 3.0 * freq / 200.0
    log_region = freq >= 1000.0
    return np.where(log_region, 15.0 + np.log(np.maximum(freq, 1e-30) / 1000.0) / (np.log(6.4) / 27.0), mels)


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    freq = 200.0 * mels / 3.0
    log_region = mels >= 15.0
    return np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (mels - 15.0)), freq)


@functools.lru_cache(maxsize=4)
def mel_filter_bank(num_frequency_bins: int = N_FFT // 2 + 1, num_mel_filters: int = N_MELS,
                    min_frequency: float = 0.0, max_frequency: float = 8000.0,
                    sampling_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular mel filters (num_freq,
    num_mel), float64: transformers' ``mel_filter_bank`` with norm="slaney",
    mel_scale="slaney" (Whisper's configuration)."""
    COUNTERS["builds"] += 1
    fft_freqs = np.linspace(0.0, sampling_rate // 2, num_frequency_bins)
    mel_freqs = np.linspace(_hz_to_mel_slaney(min_frequency), _hz_to_mel_slaney(max_frequency),
                            num_mel_filters + 2)
    filter_freqs = _mel_to_hz_slaney(mel_freqs)
    filter_diff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]  # (num_freq, num_mel + 2)
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    enorm = 2.0 / (filter_freqs[2:num_mel_filters + 2] - filter_freqs[:num_mel_filters])  # 2 / bandwidth
    return fb * enorm[None, :]


def _log_mel_frames(audio_padded: torch.Tensor, num_frames: int) -> torch.Tensor:
    """(B, T_padded) -> (B, n_mels, num_frames) of log10 mel power."""
    power = stft_power(audio_padded, num_frames, N_FFT, HOP_LENGTH)  # (B, F, 201)
    filters = torch.as_tensor(mel_filter_bank(), dtype=audio_padded.dtype, device=audio_padded.device)
    mel = torch.einsum("...fk,km->...mf", power, filters)
    return torch.log10(torch.clamp(mel, min=1e-10))


def whisper_log_mel(audio: torch.Tensor, *, pad_to: int = N_SAMPLES, num_frames: int = N_FRAMES) -> torch.Tensor:
    """Batched Whisper log-mel features: (B, N) audio -> (B, 80, num_frames)
    ((N,) -> (80, num_frames)). The audio is zero-padded to ``pad_to``
    samples implicitly; N must not exceed it."""
    squeeze = audio.dim() == 1
    if squeeze:
        audio = audio[None]
    B, N = audio.shape
    if N > pad_to:
        raise ValueError(f"audio length {N} exceeds pad_to {pad_to}")
    half = N_FFT // 2
    if N > pad_to - half:
        # the right edge meets the reflect padding: the full computation
        full = F.pad(audio, (0, pad_to - N))
        padded = F.pad(full[:, None], (half, half), mode="reflect")[:, 0]
        log_spec = _log_mel_frames(padded, num_frames)
    else:
        # fast path: only the frames overlapping [0, N) carry signal
        n_real = min(num_frames, -(-(N + half) // HOP_LENGTH))
        right_pad = (n_real - 1) * HOP_LENGTH + N_FFT - half - N
        padded = F.pad(audio, (0, max(0, right_pad)))
        padded = F.pad(padded[:, None], (half, 0), mode="reflect")[:, 0]
        real = _log_mel_frames(padded, n_real)  # (B, 80, n_real)
        fill = torch.full((B, N_MELS, num_frames - n_real), _LOG_FLOOR, dtype=audio.dtype, device=audio.device)
        log_spec = torch.cat([real, fill], dim=-1)
    # per-sample dynamic-range clamp and affine scaling
    max_val = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = (torch.maximum(log_spec, max_val - 8.0) + 4.0) / 4.0
    return log_spec[0] if squeeze else log_spec
