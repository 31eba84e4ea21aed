"""Welch PSD estimation and PSD interpolation (counterpart of the search-path
functions of ``gwkit/ops/psd.py``). One-sided PSDs of length N//2 + 1."""
from __future__ import annotations

import numpy as np
import torch

from gwkit_torch.ops.qtransform import median


def median_bias(n: int) -> float:
    """LAL/pycbc median bias factor for a median over n periodograms."""
    if n >= 1000:
        return float(np.log(2.0))
    ans = 1.0
    for i in range(1, (n - 1) // 2 + 1):
        ans += 1.0 / (2 * i + 1) - 1.0 / (2 * i)
    return ans


def welch_psd(x: torch.Tensor, delta_t: float, segment_duration: float = 0.5,
              avg_method: str = "median") -> torch.Tensor:
    """Welch PSD of (..., N) strain: symmetric hann window, 50% overlap,
    median averaging with bias correction (pycbc ``TimeSeries.psd``)."""
    n = x.shape[-1]
    seg_len = int(round(segment_duration / delta_t))
    stride = seg_len // 2
    nsegs = (n - seg_len) // stride + 1
    if nsegs < 1:
        raise ValueError("strain shorter than one PSD segment")
    window = np.hanning(seg_len)
    frames = x.unfold(-1, seg_len, stride) * torch.as_tensor(window, dtype=x.dtype, device=x.device)
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    periodograms = power * (2.0 * delta_t / float(np.sum(window ** 2)))  # (..., nsegs, flen)
    if avg_method == "median":
        return median(periodograms, dim=-2) / median_bias(nsegs)
    if avg_method == "mean":
        return periodograms.mean(dim=-2)
    raise ValueError(avg_method)


def interpolate_psd(psd: torch.Tensor, delta_f_old: float, delta_f_new: float,
                    flen_new: int) -> torch.Tensor:
    """Linear interpolation of a one-sided PSD onto another frequency grid,
    batched over leading axes (``jnp.interp`` arithmetic: edge values held)."""
    xp = torch.arange(psd.shape[-1], device=psd.device, dtype=torch.float32) * delta_f_old
    x = torch.arange(flen_new, device=psd.device, dtype=torch.float32) * delta_f_new
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    fp_lo, fp_hi = psd[..., i - 1], psd[..., i]
    dx = xp[i] - xp[i - 1]
    f = fp_lo + ((x - xp[i - 1]) / dx) * (fp_hi - fp_lo)
    f = torch.where(x < xp[0], psd[..., :1], f)
    return torch.where(x > xp[-1], psd[..., -1:], f)
