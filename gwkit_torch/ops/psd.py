"""Power-spectral-density utilities (counterpart of ``gwkit/ops/psd.py``).
One-sided PSDs of length N//2 + 1, units strain^2/Hz.

The host half is gwkit's numpy code, copied so that it equals gwkit's bit
for bit: the analytic aLIGO design curve (``aligo_zdhp_psd``), the seeded
family of perturbed design PSDs with their line forest (``psd_variant``),
PSDs by name or ASCII file (``get_psd``, ``load_psd_file``) and their cache
(``NamedPSDCache``). The device half works on tensors: Welch estimation
with median averaging (``welch_psd``) and PSD interpolation.
"""
from __future__ import annotations

import os
import zlib
from typing import Dict, Tuple

import numpy as np
import torch

from gwkit_torch.ops.qtransform import median


def aligo_zdhp_psd(flen: int, delta_f: float, low_freq_cutoff: float = 9.0) -> np.ndarray:
    """Analytic approximation of the aLIGO ZeroDetHighPower design PSD.

    S(f) = 1e-49 * (x^-4.14 - 5 x^-2 + 111 (1 - x^2 + x^4/2)/(1 + x^2/2)),
    x = f / 215 Hz  (standard closed-form fit of the design curve).
    Zero below ``low_freq_cutoff`` (pycbc convention).
    """
    f = np.arange(flen) * delta_f
    x = np.maximum(f, 1e-3) / 215.0
    psd = 1e-49 * (x ** -4.14 - 5.0 / x ** 2 + 111.0 * (1.0 - x ** 2 + 0.5 * x ** 4) / (1.0 + 0.5 * x ** 2))
    psd[f < low_freq_cutoff] = 0.0
    return psd


def flat_psd(flen: int, delta_f: float, amplitude: float = 1.0, low_freq_cutoff: float = 0.0) -> np.ndarray:
    f = np.arange(flen) * delta_f
    psd = np.full(flen, amplitude, dtype=np.float64)
    psd[f < low_freq_cutoff] = 0.0
    return psd


# Narrow instrumental line families present in every O3 LIGO PSD estimate
# (public GWOSC O3 line lists): 60 Hz power mains + harmonics, the test-mass
# suspension-fiber "violin" modes near 500 Hz and their harmonics, and the
# photon-calibrator lines. Center frequencies differ slightly per detector.
_PSD_LINES = {
    "H1": {
        "mains": 60.0,
        "violin": (502.0, 1009.0, 1484.0),
        "cal": (17.1, 16.4, 35.9, 331.9, 1083.7),
    },
    "L1": {
        "mains": 60.0,
        "violin": (505.0, 1012.0, 1496.0),
        "cal": (17.3, 16.3, 34.7, 331.3, 434.9, 1083.1),
    },
}


def psd_variant(
    flen: int,
    delta_f: float,
    low_freq_cutoff: float = 9.0,
    detector: str = "H1",
    index: int = 0,
) -> np.ndarray:
    """Deterministic family of perturbed aLIGO design PSDs.

    Stand-in for the challenge's 20 per-detector O3a PSD-estimate files
    (MLGWSC-1's `generate_data.py:332-333` hard-codes cluster
    paths that do not ship). Three measured-PSD features are modeled:

    * broadband drift: the ZDHP design curve times a smooth seeded
      log-frequency perturbation (low-order cosines, ~±25% in ASD) plus an
      overall sensitivity scale — run-to-run spectral-shape variation;
    * the instrumental line forest (:data:`_PSD_LINES`): 60 Hz mains
      harmonics, violin modes with harmonic clusters, calibration lines —
      narrow Lorentzian peaks 2–5 decades above the local broadband level,
      with per-variant amplitude/width jitter (lines wander between PSD
      estimates in real data, their centers do not);
    * per-detector asymmetry via detector-keyed line tables and seeds.

    Within-segment non-stationarity is NOT representable by a PSD; ds3's
    per-segment fresh variant (ChallengePSDSelector) models between-segment
    drift instead. Real PSD files drop in via :func:`load_psd_file`.
    """
    base = aligo_zdhp_psd(flen, delta_f, low_freq_cutoff)
    f = np.arange(flen) * delta_f
    # zlib.crc32 rather than hash(): stable across processes (PYTHONHASHSEED)
    rng = np.random.default_rng(zlib.crc32(f"{detector}:{int(index)}".encode()))
    logf = np.log(np.maximum(f, low_freq_cutoff) / 215.0)
    pert = np.zeros(flen)
    for k in range(1, 5):
        pert += rng.normal(0.0, 0.12 / k) * np.cos(k * logf + rng.uniform(0, 2 * np.pi))
    level = rng.normal(0.0, 0.15)
    out = base * np.exp(2.0 * (pert + level))  # factor 2: perturb the ASD

    lines = _PSD_LINES.get(detector, _PSD_LINES["H1"])
    f_nyq = (flen - 1) * delta_f
    centers, log_amps = [], []
    for h in range(1, int(f_nyq // lines["mains"]) + 1):
        centers.append(h * lines["mains"])
        # mains fundamental strongest, harmonics decay but stay prominent
        log_amps.append(rng.uniform(3.0, 5.0) - 0.5 * (h - 1))
    for v in lines["violin"]:
        # violin modes are split multiplets; model 2-3 close peaks per cluster
        for _ in range(int(rng.integers(2, 4))):
            centers.append(v + rng.normal(0.0, 1.5))
            log_amps.append(rng.uniform(3.0, 6.0))
    for c in lines["cal"]:
        centers.append(c)
        log_amps.append(rng.uniform(2.0, 4.0))
    line_factor = np.ones(flen)
    for f0, la in zip(centers, log_amps):
        if f0 <= low_freq_cutoff or f0 >= f_nyq:
            continue
        # Gaussian profile, not Lorentzian: a forest of 1/Δf² tails from
        # 10^3-10^6-amplitude lines would lift the broadband floor between
        # lines, which measured PSDs do not show — Gaussian tails vanish a
        # few linewidths out. Width >= ~one bin so coarse grids still see
        # the line.
        sigma = max(rng.uniform(0.05, 0.3), 0.6 * delta_f)
        line_factor += (10.0 ** la) * np.exp(-0.5 * ((f - f0) / sigma) ** 2)
    out = out * line_factor
    out[f < low_freq_cutoff] = 0.0
    return out


PSD_BUILDERS = {
    "aLIGOZeroDetHighPower": aligo_zdhp_psd,
    "flat": flat_psd,
}


def get_psd(name_or_path: str, flen: int, delta_f: float, low_freq_cutoff: float = 9.0) -> np.ndarray:
    """PSD by analytic name or file path (bnslib.py:2031-2084 semantics)."""
    if name_or_path in PSD_BUILDERS:
        return PSD_BUILDERS[name_or_path](flen, delta_f, low_freq_cutoff)
    if os.path.isfile(name_or_path):
        return load_psd_file(name_or_path, flen, delta_f, low_freq_cutoff)
    raise ValueError(f"Unknown PSD '{name_or_path}' (not a builder name or file)")


def load_psd_file(
    path: str, flen: int, delta_f: float, low_freq_cutoff: float = 9.0, is_asd_file: bool = True
) -> np.ndarray:
    """Load a two-column (frequency, ASD|PSD) ASCII file onto an (flen, delta_f)
    grid via linear interpolation (bnslib.py:1991-2029 / pycbc.psd.from_txt)."""
    data = np.loadtxt(path)
    freqs, vals = data[:, 0], data[:, 1]
    if is_asd_file:
        vals = vals ** 2
    grid = np.arange(flen) * delta_f
    psd = np.interp(grid, freqs, vals, left=vals[0], right=vals[-1])
    psd[grid < low_freq_cutoff] = 0.0
    return psd


class NamedPSDCache:
    """Cache PSDs by (name, flen, delta_f, f_low) — bnslib.py:2086-2140."""

    def __init__(self, psd_names=None):
        self._cache: Dict[Tuple, np.ndarray] = {}
        self.psd_names = list(psd_names) if psd_names is not None else []

    def get(self, flen: int, delta_f: float, low_freq_cutoff: float, psd_name: str | None = None):
        if psd_name is None:
            if len(self.psd_names) != 1:
                raise ValueError("psd_name required when cache holds multiple names")
            psd_name = self.psd_names[0]
        key = (psd_name, flen, round(delta_f, 12), round(low_freq_cutoff, 12))
        if key not in self._cache:
            self._cache[key] = get_psd(psd_name, flen, delta_f, low_freq_cutoff)
        return self._cache[key]

    def get_from_timeseries(self, ts_len: int, delta_t: float, low_freq_cutoff: float, psd_name=None):
        flen = ts_len // 2 + 1
        delta_f = 1.0 / (ts_len * delta_t)
        return self.get(flen, delta_f, low_freq_cutoff, psd_name)


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
