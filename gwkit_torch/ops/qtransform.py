"""Batched constant-Q transform (Q-scan) in PyTorch (counterpart of
``gwkit/ops/qtransform.py``, per-window path with ``time_decimation=1``).

The static plan (``make_qplan`` and its helpers) is gwkit's numpy code,
copied: rows bucketed by their native power-of-two tile length, gather
tables into the rfft, bilinear interpolation taps and matrices. ``qscan``
then runs one ``torch.fft.ifft`` per bucket (gwkit's dense iDFT matmuls for
short buckets were a TPU matrix-unit choice), median-normalizes each row,
interpolates to the fixed spectrogram shape and keeps per sample the plane
with the largest peak normalized energy.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch


def next_power_of_two(x: float) -> int:
    return int(2 ** np.ceil(np.log2(max(x, 1.0))))


def q_values(q_range: Tuple[float, float], mismatch: float = 0.2) -> List[float]:
    """Log-spaced Q values covering q_range at the given mismatch (GWpy QTiling)."""
    deltam = 2.0 * np.sqrt(mismatch / 3.0)
    cumum = np.log(q_range[1] / q_range[0]) / np.sqrt(2.0)
    nplanes = int(max(np.ceil(cumum / deltam), 1))
    dq = cumum / nplanes
    return [q_range[0] * np.exp(np.sqrt(2.0) * dq * (i + 0.5)) for i in range(nplanes)]


def plane_frequencies(q: float, duration: float, sample_rate: float,
                      f_range: Tuple[float, float] | None = None,
                      mismatch: float = 0.2) -> np.ndarray:
    """Log-spaced frequency rows of one Q plane (GWpy QPlane)."""
    deltam = 2.0 * np.sqrt(mismatch / 3.0)
    if f_range is None:
        f_range = (0.0, np.inf)
    minf, maxf = f_range
    if minf == 0.0:
        minf = 50.0 * q / (2.0 * np.pi * duration)
    if np.isinf(maxf):
        maxf = sample_rate / 2.0 / (1.0 + np.sqrt(11.0) / q)
    fcum_mismatch = np.log(maxf / minf) * np.sqrt(2.0 + q ** 2) / 2.0
    nfreq = int(max(1, np.ceil(fcum_mismatch / deltam)))
    fstep = fcum_mismatch / nfreq
    fstepmin = 1.0 / duration
    freqs = [
        (minf * np.exp(2.0 / np.sqrt(2.0 + q ** 2) * (i + 0.5) * fstep)) // fstepmin * fstepmin
        for i in range(nfreq)
    ]
    return np.unique(np.asarray(freqs))


@dataclasses.dataclass(frozen=True)
class QBucket:
    """Rows sharing one native tile length L (the row's GWpy ``ntiles``)."""
    length: int                 # native iFFT length L for these rows
    rows: np.ndarray            # plane-major row indices (n_L,)
    gather_idx: np.ndarray      # (n_L, L) int32 into rfft bins
    gather_weight: np.ndarray   # (n_L, L) float32 bisquare window values


@dataclasses.dataclass(frozen=True)
class QPlan:
    """Static geometry for one batched Q-scan configuration."""
    duration: float
    sample_rate: float
    qs: Tuple[float, ...]
    n_common: int
    n_rows: Tuple[int, ...]              # rows per plane
    row_freqs: Tuple[np.ndarray, ...]    # frequencies per plane
    freq_interp: Tuple[np.ndarray, ...]  # per plane (f_bins, n_rows)
    shape: Tuple[int, int]
    buckets: Tuple[QBucket, ...]
    row_inv: np.ndarray                  # bucket-concat position of each plane-major row
    row_f: np.ndarray                    # row center frequency (Hz)
    row_q: np.ndarray                    # row Q value


def _bilinear_taps(n_in: int, n_out: int):
    """(lo, hi, w): out[i] = in[lo[i]]*(1-w[i]) + in[hi[i]]*w[i], half-pixel centers."""
    lo = np.zeros(n_out, np.int32)
    hi = np.zeros(n_out, np.int32)
    w = np.zeros(n_out, np.float32)
    if n_in == 1:
        return lo, hi, w
    scale = n_in / n_out
    for i in range(n_out):
        x = (i + 0.5) * scale - 0.5
        x = min(max(x, 0.0), n_in - 1.0)
        lo[i] = int(np.floor(x))
        hi[i] = min(lo[i] + 1, n_in - 1)
        w[i] = x - lo[i]
    return lo, hi, w


def _bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) linear-interpolation matrix with half-pixel centers."""
    m = np.zeros((n_out, n_in))
    if n_in == 1:
        m[:, 0] = 1.0
        return m
    scale = n_in / n_out
    for i in range(n_out):
        x = (i + 0.5) * scale - 0.5
        x = min(max(x, 0.0), n_in - 1.0)
        lo = int(np.floor(x))
        hi = min(lo + 1, n_in - 1)
        w = x - lo
        m[i, lo] += 1.0 - w
        m[i, hi] += w
    return m


@functools.lru_cache(maxsize=8)
def make_qplan(
    duration: float = 1.0,
    sample_rate: float = 2048.0,
    q_range: Tuple[float, float] = (4.0, 128.0),
    spectrogram_shape: Tuple[int, int] = (128, 128),
    mismatch: float = 0.2,
) -> QPlan:
    n = int(round(duration * sample_rate))
    n_freq_bins = n // 2 + 1
    qs = q_values(q_range, mismatch)
    deltam = 2.0 * np.sqrt(mismatch / 3.0)

    all_freqs, n_rows, rows_meta = [], [], []
    max_ntiles = 1
    for q in qs:
        freqs = plane_frequencies(q, duration, sample_rate, mismatch=mismatch)
        qprime = q / np.sqrt(11.0)
        ws_list, nt_list = [], []
        for f in freqs:
            ws_list.append(2 * int(f / qprime * duration) + 1)
            ntiles = next_power_of_two(duration * 2.0 * np.pi * f / q / deltam)
            nt_list.append(ntiles)
            max_ntiles = max(max_ntiles, ntiles)
        rows_meta.append((freqs, ws_list, nt_list))
        all_freqs.append(freqs)
        n_rows.append(len(freqs))

    row_offset = 0
    by_len: Dict[int, list] = {}  # L -> [(global_row, src_k, dst_k, window)]
    for (freqs, ws_list, nt_list), q in zip(rows_meta, qs):
        qprime = q / np.sqrt(11.0)
        for r, (f, windowsize, ntiles) in enumerate(zip(freqs, ws_list, nt_list)):
            half = (windowsize - 1) // 2
            k = np.arange(windowsize) - half
            xfreqs = (k / duration) * qprime / f
            norm = ntiles / (duration * sample_rate) * np.sqrt(315.0 * qprime / (128.0 * f))
            window = (1.0 - xfreqs ** 2) ** 2 * norm
            src_k = int(round(f * duration)) + k
            valid = (src_k >= 0) & (src_k < n_freq_bins)
            by_len.setdefault(ntiles, []).append(
                (row_offset + r, src_k[valid], np.mod(k, ntiles)[valid], window[valid]))
        row_offset += len(freqs)

    buckets, order = [], []
    for L in sorted(by_len):
        entries = by_len[L]
        gi = np.zeros((len(entries), L), np.int32)
        gw = np.zeros((len(entries), L), np.float32)
        for i, (row, s_k, d_k, win) in enumerate(entries):
            gi[i, d_k] = s_k
            gw[i, d_k] = win.astype(np.float32)
            order.append(row)
        buckets.append(QBucket(length=int(L), rows=np.asarray([e[0] for e in entries], np.int32),
                               gather_idx=gi, gather_weight=gw))
    row_inv = np.argsort(np.asarray(order, np.int64)).astype(np.int32)

    t_bins, f_bins = spectrogram_shape[1], spectrogram_shape[0]
    freq_interp = tuple(_bilinear_matrix(len(f), f_bins).astype(np.float32) for f in all_freqs)
    return QPlan(
        duration=duration,
        sample_rate=sample_rate,
        qs=tuple(qs),
        n_common=max_ntiles,
        n_rows=tuple(n_rows),
        row_freqs=tuple(all_freqs),
        freq_interp=freq_interp,
        shape=(f_bins, t_bins),
        buckets=tuple(buckets),
        row_inv=row_inv,
        row_f=np.concatenate([m[0] for m in rows_meta]).astype(np.float64),
        row_q=np.concatenate([np.full(len(m[0]), q, np.float64) for m, q in zip(rows_meta, qs)]),
    )


def median(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """``jnp.median`` semantics: on an even length, the mean of the two middle
    values (``torch.median`` returns the lower one)."""
    n = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    lo = s.narrow(dim, (n - 1) // 2, 1)
    out = lo if n % 2 else 0.5 * (lo + s.narrow(dim, n // 2, 1))
    return out if keepdim else out.squeeze(dim)


class _PlanTensors:
    """A plan's tables on one device (built once per (plan, device))."""

    def __init__(self, plan: QPlan, device: torch.device):
        t_bins = plan.shape[1]
        self.buckets = []
        for b in plan.buckets:
            lo, hi, w = _bilinear_taps(b.length, t_bins)
            self.buckets.append(tuple(torch.from_numpy(a).to(device) for a in (
                b.gather_idx.astype(np.int64), b.gather_weight, lo.astype(np.int64),
                hi.astype(np.int64), w)))
        self.row_inv = torch.from_numpy(plan.row_inv.astype(np.int64)).to(device)
        self.freq_interp = [torch.from_numpy(m).to(device) for m in plan.freq_interp]


# (id(plan), device) -> (plan, tables); holding the plan keeps its id unique
_PLAN_TABLES: Dict[Tuple[int, str], Tuple[QPlan, _PlanTensors]] = {}


def _plan_tensors(plan: QPlan, device: torch.device) -> _PlanTensors:
    key = (id(plan), str(device))
    hit = _PLAN_TABLES.get(key)
    if hit is None:
        hit = _PLAN_TABLES[key] = (plan, _PlanTensors(plan, device))
    return hit[1]


def qscan(strain: torch.Tensor, plan: QPlan | None = None, *, duration: float = 1.0,
          sample_rate: float = 2048.0, q_range: Tuple[float, float] = (4.0, 128.0),
          spectrogram_shape: Tuple[int, int] = (128, 128), norm: str = "median",
          median_stride: int = 1) -> torch.Tensor:
    """Q-scan of (B, N) strain -> (B, f_bins, t_bins) normalized energy.

    ``median_stride`` > 1 estimates a row's median from every k-th sample;
    each bucket clamps the stride so at least 64 samples (or the whole row)
    enter the estimate."""
    if plan is None:
        plan = make_qplan(duration, sample_rate, q_range, spectrogram_shape)
    tinterp, rowmax = _row_energies(strain, plan, norm, median_stride)
    return _plane_select(tinterp, rowmax, plan, _plan_tensors(plan, strain.device).freq_interp)


def _row_energies(strain: torch.Tensor, plan: QPlan, norm: str, median_stride: int):
    """Every row's normalized energy on the output time grid (B, rows,
    t_bins) and its peak (B, rows), rows in plane-major order."""
    tabs = _plan_tensors(plan, strain.device)
    fseries = torch.fft.rfft(strain.float(), dim=-1)  # (B, F)
    tinterp_parts, rowmax_parts = [], []
    for bucket, (gidx, gw, lo, hi, w) in zip(plan.buckets, tabs.buckets):
        L = bucket.length
        spec = fseries[:, gidx] * gw  # (B, n_L, L)
        y = torch.fft.ifft(spec, dim=-1)
        energy = y.real ** 2 + y.imag ** 2
        if norm == "median":
            s = min(median_stride, max(1, L // 64))
            denom = median(energy[..., ::s] if s > 1 else energy, dim=-1, keepdim=True)
        elif norm == "mean":
            denom = energy.mean(dim=-1, keepdim=True)
        else:
            denom = torch.ones_like(energy[..., :1])
        denom = torch.clamp(denom, min=1e-30)
        tlow = energy[..., lo]
        thigh = energy[..., hi]
        tinterp_parts.append((tlow + w * (thigh - tlow)) / denom)
        rowmax_parts.append(energy.amax(dim=-1) / denom[..., 0])
    tinterp = torch.cat(tinterp_parts, dim=1)[:, tabs.row_inv]  # (B, rows, t_bins)
    rowmax = torch.cat(rowmax_parts, dim=1)[:, tabs.row_inv]    # (B, rows)
    return tinterp, rowmax


def plane_peaks(rowmax: torch.Tensor, plan: QPlan) -> torch.Tensor:
    """(B, rows) row peaks -> (B, nplanes) plane peaks, the selection key."""
    return torch.stack([part.amax(dim=-1) for part in rowmax.split(list(plan.n_rows), dim=1)], dim=1)


def _plane_select(tinterp: torch.Tensor, rowmax: torch.Tensor, plan: QPlan,
                  freq_interp) -> torch.Tensor:
    """Per-plane frequency interpolation + per-sample best-plane selection
    (largest peak normalized energy, first on a tie as ``jnp.argmax``);
    returns (B, f_bins, t_bins)."""
    best = torch.argmax(plane_peaks(rowmax, plan), dim=1)
    specs = [torch.einsum("fr,brt->bft", m, part)
             for m, part in zip(freq_interp, tinterp.split(list(plan.n_rows), dim=1))]
    stacked = torch.stack(specs, dim=1)  # (B, nplanes, f, t)
    return stacked[torch.arange(stacked.shape[0], device=stacked.device), best]
