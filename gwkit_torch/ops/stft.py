"""Batched STFT primitives (counterpart of ``gwkit/ops/stft.py``).

Framing is one index gather (``x[..., idx]``, as gwkit's): never an
``index_select`` on an ``unfold`` view, which materializes the whole view.
The FFT runs over the last axis (``torch.fft.rfft``: cuFFT on the card).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def hann_window(length: int, periodic: bool = True) -> np.ndarray:
    """Periodic Hann window (transformers' ``window_function``), float64."""
    n = length + 1 if periodic else length
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / (n - 1)))
    return win[:length].astype(np.float64)


def frame(x: torch.Tensor, num_frames: int, frame_length: int, hop: int) -> torch.Tensor:
    """Overlapping frames (..., T) -> (..., num_frames, frame_length); the
    input must already be padded so every frame is in bounds."""
    starts = np.arange(num_frames) * hop
    idx = torch.from_numpy(starts[:, None] + np.arange(frame_length)[None, :]).to(x.device)
    return x[..., idx]


def stft_power(x: torch.Tensor, num_frames: int, frame_length: int = 400, hop: int = 160,
               window: Optional[np.ndarray] = None) -> torch.Tensor:
    """|STFT|^2 of pre-padded (..., T) input -> (..., num_frames, frame_length // 2 + 1)."""
    if window is None:
        window = hann_window(frame_length)
    frames = frame(x, num_frames, frame_length, hop) * torch.as_tensor(window, dtype=x.dtype, device=x.device)
    spec = torch.fft.rfft(frames, dim=-1)
    return (spec.real * spec.real + spec.imag * spec.imag).to(x.dtype)
