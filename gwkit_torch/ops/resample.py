"""FFT resampling with ``scipy.signal.resample`` parity (counterpart of
``gwkit/ops/resample.py``): 2048 Hz strain to Whisper's 16 kHz, batched on
the tensor's device."""
from __future__ import annotations

import torch


def resample_fourier(x: torch.Tensor, num: int) -> torch.Tensor:
    """Resample the last axis of a real signal to ``num`` samples via the FFT,
    with scipy's even-length Nyquist conventions: the Nyquist bin is halved
    when upsampling, and the new Nyquist bin doubled when downsampling to an
    even length."""
    n = x.shape[-1]
    if num == n:
        return x
    spec = torch.fft.rfft(x, dim=-1)
    nyq = min(n, num) // 2 + 1
    out_bins = num // 2 + 1
    if num > n:  # upsample: zero-pad the spectrum
        y = torch.zeros(x.shape[:-1] + (out_bins,), dtype=spec.dtype, device=x.device)
        y[..., :nyq] = spec[..., :nyq]
        if n % 2 == 0:
            y[..., n // 2] *= 0.5
    else:  # downsample: truncate the spectrum
        y = spec[..., :out_bins].clone()
        if num % 2 == 0:  # scipy folds the dropped mirrored bin into the new Nyquist
            y[..., num // 2] *= 2.0
    out = torch.fft.irfft(y, num, dim=-1)
    return (out * (num / n)).to(x.dtype)


def resample_timeseries(data: torch.Tensor, original_sampling_rate: int = 2048,
                        target_sampling_rate: int = 16000) -> torch.Tensor:
    """The reference's helper: ``len * target // original`` samples."""
    return resample_fourier(data, data.shape[-1] * target_sampling_rate // original_sampling_rate)
