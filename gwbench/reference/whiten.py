"""MLGWSC-1 whitening in float64 torch: a Welch median PSD (0.5 s hann
segments, half overlap, LAL's median bias), linearly interpolated to the
data's frequency grid, smoothed by inverse spectrum truncation (pycbc: the
inverse ASD zeroed at DC, Nyquist and below the cutoff, its impulse
response kept to ``max_filter_duration`` with a hann taper), then the data
divided by the truncated ASD and ``max_filter_duration / 2`` cropped at
both ends."""
from __future__ import annotations

import numpy as np
import torch


def median_bias(n: int) -> float:
    if n >= 1000:
        return float(np.log(2.0))
    return 1.0 + sum(1.0 / (2 * i + 1) - 1.0 / (2 * i) for i in range(1, (n - 1) // 2 + 1))


def middle(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The median, the mean of the two middle values on an even length."""
    n = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    lo = s.select(dim, (n - 1) // 2)
    return lo if n % 2 else 0.5 * (lo + s.select(dim, n // 2))


def welch(x: torch.Tensor, dt: float, seconds: float) -> torch.Tensor:
    L = int(round(seconds / dt))
    win = torch.from_numpy(np.hanning(L)).to(x)
    frames = x.unfold(-1, L, L // 2) * win
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2 * (2.0 * dt / float((win ** 2).sum()))
    return middle(power, dim=-2) / median_bias(frames.shape[-2])


def interp(psd: torch.Tensor, df_old: float, df_new: float, n_new: int) -> torch.Tensor:
    """Linear interpolation on a one-sided grid, edge values held."""
    xp = np.arange(psd.shape[-1]) * df_old
    x = np.arange(n_new) * df_new
    return torch.stack([torch.from_numpy(np.interp(x, xp, row)) for row in psd.cpu().numpy()]).to(psd)


def whiten(strain: torch.Tensor, dt: float, segment_duration: float, max_filter_duration: float,
           low_frequency_cutoff: float) -> torch.Tensor:
    """(D, N) raw strain -> (D, N - 2 * (max_filter_len // 2)) whitened, float64."""
    x = strain.double()
    n = x.shape[-1]
    df = 1.0 / (n * dt)
    psd = interp(welch(x, dt, segment_duration), 1.0 / segment_duration, df, n // 2 + 1)
    inv_asd = torch.where(psd > 0, 1.0 / torch.sqrt(psd.clamp(min=1e-300)), torch.zeros_like(psd))
    inv_asd[..., 0] = 0.0
    inv_asd[..., -1] = 0.0
    inv_asd[..., : int(low_frequency_cutoff / df)] = 0.0
    q = torch.fft.irfft(inv_asd, n, dim=-1)
    L = int(max_filter_duration / dt)
    half = L // 2
    taper = torch.from_numpy(np.hanning(L)).to(q)
    q[..., :half] *= taper[half:]
    q[..., n - half:] *= taper[:half]
    q[..., half: n - half] = 0.0
    trunc_asd = torch.fft.rfft(q, dim=-1).abs()  # 1 / sqrt(truncated PSD)
    white = torch.fft.irfft(torch.fft.rfft(x, dim=-1) * trunc_asd, n, dim=-1)
    return white[..., half: n - half]
