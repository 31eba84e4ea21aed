"""Frequency-domain whitening with PyCBC inverse-spectrum-truncation
semantics (counterpart of ``gwkit/ops/whiten.py``): the MLGWSC-1 search
whitening with a Welch-estimated PSD (``whiten_estimate``) and bnslib's
known-PSD whitening (``whiten_psd``), both over the same truncation
(``inverse_spectrum_truncation``).

f32 numerics as gwkit's: raw strain is O(1e-21) and its PSD O(1e-42), below
f32's normal range. Whitening is scale-invariant and inverse spectrum
truncation 1-homogeneous, so the strain is first scaled to unit RMS and the
PSD to O(1), with every scale folded back exactly; nothing moves to f64 on
the card.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from gwkit_torch.ops.psd import interpolate_psd, welch_psd


def _normalize_psd(psd) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """(psd / c, c) with c the mean of the positive entries. A host f64
    numpy PSD is normalized in f64 before it becomes f32 (c is then a Python
    float, itself below f32's normal range)."""
    if isinstance(psd, np.ndarray):
        pos = psd > 0
        c_np = float(psd[pos].mean()) if pos.any() else 1.0
        return torch.from_numpy((psd / c_np).astype(np.float32)), c_np
    pos = psd > 0
    c = torch.where(pos, psd, torch.zeros_like(psd)).sum(dim=-1, keepdim=True) / torch.clamp(
        pos.sum(dim=-1, keepdim=True), min=1)
    c = torch.clamp(c, min=1e-38)
    return psd / c, c


def inverse_spectrum_truncation(psd, max_filter_len: int, low_frequency_cutoff: Optional[float] = None,
                                delta_f: float = 1.0, trunc_method: Optional[str] = "hann") -> torch.Tensor:
    """Smooth a PSD by truncating its inverse-ASD impulse response in time
    (pycbc.psd.inverse_spectrum_truncation): zero the inverse ASD at DC,
    Nyquist and below the cutoff; irfft; keep max_filter_len samples
    (hann-tapered) split across the start and end; rfft; 1/|.|^2.

    Normalized internally (the truncation is 1-homogeneous) and scaled back,
    so pass a PSD whose scale float32 represents, or use the whiten_*
    functions, which keep everything normalized. A host numpy PSD is
    truncated on the CPU; a tensor on its own device.
    """
    core, c = _normalize_psd(psd)
    return _ist_core(core, max_filter_len, low_frequency_cutoff, delta_f, trunc_method) * c


def _sqrt_scale(c):
    """sqrt of the PSD scale, in f64 when c is a host float (1e-42 is not
    f32-representable, its square root 1e-21 is)."""
    if isinstance(c, float):
        return np.float32(np.sqrt(c))
    return torch.sqrt(c)


def _robust_rms(x: torch.Tensor) -> torch.Tensor:
    """RMS over the last axis that survives f32 subnormal flushing for 1e-21
    strain: peak-normalize before squaring."""
    peak = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-30)
    rms = peak * torch.sqrt(((x / peak) ** 2).mean(dim=-1, keepdim=True))
    return torch.clamp(rms, min=1e-30)


def _ist_core(psd: torch.Tensor, max_filter_len: int, low_frequency_cutoff: Optional[float],
              delta_f: float, trunc_method: Optional[str]) -> torch.Tensor:
    """Inverse spectrum truncation of an O(1) PSD (pycbc semantics)."""
    flen = psd.shape[-1]
    n = (flen - 1) * 2
    pos = psd > 0
    inv_asd = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, psd, torch.ones_like(psd))),
                          torch.zeros_like(psd))
    inv_asd[..., 0] = 0.0
    inv_asd[..., -1] = 0.0
    if low_frequency_cutoff is not None:
        inv_asd[..., : int(low_frequency_cutoff / delta_f)] = 0.0
    q = torch.fft.irfft(inv_asd.to(torch.complex64), n, dim=-1)
    half = max_filter_len // 2
    if trunc_method == "hann":
        win = torch.as_tensor(np.hanning(max_filter_len), dtype=q.dtype, device=q.device)
        q[..., :half] *= win[half:]
        q[..., n - half:] *= win[:half]
    q[..., half: n - half] = 0.0
    trunc_asd = torch.fft.rfft(q, dim=-1)
    mag_sq = trunc_asd.real ** 2 + trunc_asd.imag ** 2
    return 1.0 / torch.clamp(mag_sq, min=1e-30)


def whiten_estimate(
    strain: torch.Tensor,
    delta_t: float = 1.0 / 2048.0,
    segment_duration: float = 0.5,
    max_filter_duration: float = 0.25,
    low_frequency_cutoff: Optional[float] = None,
    psd=None,
    remove_corrupted: bool = True,
    return_psd: bool = False,
):
    """MLGWSC-1 inference whitening, batched over (..., N).

    The PSD is Welch-median estimated from the data unless given (a tensor
    on the strain's grid or coarser, or a host numpy array). The result is
    cropped by max_filter_len // 2 samples on each side."""
    n = strain.shape[-1]
    sample_rate = 1.0 / delta_t
    delta_f = 1.0 / (n * delta_t)
    flen = n // 2 + 1
    rms = _robust_rms(strain.float())
    x = strain.float() / rms
    if psd is None:
        est = welch_psd(x, delta_t, segment_duration)
        unprocessed = est * rms[..., :1] ** 2
        est = interpolate_psd(est, 1.0 / segment_duration, delta_f, flen)
        core, c = _normalize_psd(est)
        inv_scale = 1.0 / torch.sqrt(c)
    else:
        unprocessed = psd
        if isinstance(psd, torch.Tensor) and psd.shape[-1] != flen:
            psd = interpolate_psd(psd, delta_f * (n // 2) / (psd.shape[-1] - 1), delta_f, flen)
        elif isinstance(psd, np.ndarray) and psd.shape[-1] != flen:
            grid_old = np.arange(psd.shape[-1]) * (1.0 / (2.0 * delta_t * (psd.shape[-1] - 1)))
            psd = np.interp(np.arange(flen) * delta_f, grid_old, psd)
        core, c_phys = _normalize_psd(psd)
        core = core.to(x.device)
        inv_scale = rms / _sqrt_scale(c_phys)
    max_filter_len = int(max_filter_duration * sample_rate)
    core = _ist_core(core, max_filter_len, low_frequency_cutoff, delta_f, "hann")
    inv_amp = torch.sqrt(1.0 / core) * inv_scale
    white = torch.fft.irfft(torch.fft.rfft(x, dim=-1) * inv_amp, n, dim=-1).to(strain.dtype)
    if remove_corrupted:
        white = white[..., max_filter_len // 2: n - max_filter_len // 2]
    return (white, unprocessed) if return_psd else white


def whiten_psd(strain: torch.Tensor, psd, delta_t: float, low_freq_cutoff: float = 20.0,
               max_filter_duration: float = 4.0) -> torch.Tensor:
    """bnslib known-PSD whitening, batched over (..., N).

    The PSD (one-sided, len N//2+1, matching delta_f; a tensor or a host
    numpy array) is truncated, the strain spectrum is zeroed below the
    cutoff and at Nyquist, divided by sqrt(PSD), and max_filter_len samples
    are cropped from both ends."""
    n = strain.shape[-1]
    delta_f = 1.0 / (n * delta_t)
    max_filter_len = int(max_filter_duration * (1.0 / delta_t))
    core, c = _normalize_psd(psd)
    core = _ist_core(core.to(strain.device), max_filter_len, low_freq_cutoff, delta_f, "hann")
    kmin = int(low_freq_cutoff / delta_f)
    strain_f = torch.fft.rfft(strain.float(), dim=-1)
    inv_amp = torch.sqrt(1.0 / core) / _sqrt_scale(c)
    k = torch.arange(n // 2 + 1, device=strain.device)
    mask = (k >= kmin) & (k != n // 2)
    strain_f = torch.where(mask, strain_f * inv_amp, torch.zeros_like(strain_f))
    white = torch.fft.irfft(strain_f, n, dim=-1).to(strain.dtype)
    return white[..., max_filter_len: n - max_filter_len]
