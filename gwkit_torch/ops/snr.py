"""Matched-filter SNR utilities (counterpart of ``gwkit/ops/snr.py``).

The optimal SNR of a signal h against a one-sided noise PSD S is
sigma = sqrt(4 delta_f sum_k |h~_k|^2 / S_k) over the band, with
h~ = delta_t rfft(h) (pycbc.filter.sigma). Network SNR is the quadrature sum
over detectors.

As in gwkit the sum runs in float32 on whatever scale it is given: callers
pass normalized strain and PSD. At physical scale |h~|^2 is about 1e-48,
below float32's range, and the result underflows.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def sigma_sq(signal_td: torch.Tensor, psd: torch.Tensor, delta_t: float,
             low_freq_cutoff: Optional[float] = None,
             high_freq_cutoff: Optional[float] = None) -> torch.Tensor:
    """sigma^2 of (..., N) time-domain signals against a one-sided PSD of
    length N//2+1 on the signals' device. PSD bins <= 0 are excluded."""
    n = signal_td.shape[-1]
    delta_f = 1.0 / (n * delta_t)
    hf = torch.fft.rfft(signal_td.float(), dim=-1) * delta_t
    freqs = np.arange(n // 2 + 1) * delta_f
    mask = np.ones(n // 2 + 1, bool)
    if low_freq_cutoff is not None:
        mask &= freqs >= low_freq_cutoff
    if high_freq_cutoff is not None:
        mask &= freqs < high_freq_cutoff
    pos = psd > 0
    keep = torch.from_numpy(mask).to(pos.device) & pos
    power = hf.real ** 2 + hf.imag ** 2
    integrand = torch.where(keep, power / torch.where(pos, psd, torch.ones_like(psd)), torch.zeros_like(power))
    return 4.0 * delta_f * integrand.sum(dim=-1)


def optimal_snr(signal_td, psd, delta_t, low_freq_cutoff=None, high_freq_cutoff=None):
    return torch.sqrt(sigma_sq(signal_td, psd, delta_t, low_freq_cutoff, high_freq_cutoff))


def network_snr(per_detector_snrs: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.sqrt(torch.square(per_detector_snrs).sum(dim=axis))
