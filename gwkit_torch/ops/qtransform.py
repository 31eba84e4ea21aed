"""Batched constant-Q transform (Q-scan) in PyTorch (counterpart of
``gwkit/ops/qtransform.py``): the per-window scan, with gwkit's
``time_decimation`` fold, and the streaming one.

The static plan (``make_qplan`` and its helpers) is gwkit's numpy code,
copied: rows bucketed by their native power-of-two tile length, gather
tables into the rfft, bilinear interpolation taps and matrices. ``qscan``
then runs one ``torch.fft.ifft`` per bucket (gwkit's dense iDFT matmuls for
short buckets were a TPU matrix-unit choice), median-normalizes each row,
interpolates to the fixed spectrogram shape and keeps per sample the plane
with the largest peak normalized energy.

The streaming scan (``make_stream_plan``, ``stream_energies``,
``stream_crops``, ``qscan_stream``) transforms a whole chunk of whitened
strain once, one band iFFT per Q row, and serves each 1 s window by
cropping its span from every row's energy series. It is not the per-window
transform: the chunk transform sees data past the window's edges where the
per-window one wraps around, so the two differ near a window's edges by
design. gwkit computes the band iDFTs as f32 matmuls for the TPU's matrix
unit (``_ifft_energy_mxu``); here they are ``torch.fft.ifft`` (cuFFT on the
card), about 1e-5 of the bucket maximum apart.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from gwkit_torch.utils.tracing import COUNTERS, annotate


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
    COUNTERS["builds"] += 1
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
    """A plan's tables on one device (built once per (plan, device)). The
    bilinear taps depend only on a row's length, so they are built per
    length on first use: a bucket folded by ``time_decimation`` to L // d
    takes the taps of that length, never those of L."""

    def __init__(self, plan: QPlan, device: torch.device):
        self.device = device
        self.t_bins = plan.shape[1]
        self.buckets = [tuple(torch.from_numpy(a).to(device)
                              for a in (b.gather_idx.astype(np.int64), b.gather_weight)) for b in plan.buckets]
        self.row_inv = torch.from_numpy(plan.row_inv.astype(np.int64)).to(device)
        self.freq_interp = [torch.from_numpy(m).to(device) for m in plan.freq_interp]
        self._taps: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}

    def taps(self, length: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(lo, hi, w) from a row of ``length`` samples to the output grid."""
        hit = self._taps.get(length)
        if hit is None:
            lo, hi, w = _bilinear_taps(length, self.t_bins)
            hit = self._taps[length] = (torch.from_numpy(lo.astype(np.int64)).to(self.device),
                                        torch.from_numpy(hi.astype(np.int64)).to(self.device),
                                        torch.from_numpy(w).to(self.device))
        return hit


# (id(plan), device) -> (plan, tables); holding the plan keeps its id unique
_PLAN_TABLES: Dict[Tuple[int, str], Tuple[QPlan, _PlanTensors]] = {}


def _plan_tensors(plan: QPlan, device: torch.device) -> _PlanTensors:
    key = (id(plan), str(device))
    hit = _PLAN_TABLES.get(key)
    if hit is None:
        COUNTERS["builds"] += 1
        hit = _PLAN_TABLES[key] = (plan, _PlanTensors(plan, device))
    return hit[1]


def qscan(strain: torch.Tensor, plan: QPlan | None = None, *, duration: float = 1.0,
          sample_rate: float = 2048.0, q_range: Tuple[float, float] = (4.0, 128.0),
          spectrogram_shape: Tuple[int, int] = (128, 128), norm: str = "median",
          median_stride: int = 1, time_decimation: int = 1) -> torch.Tensor:
    """Q-scan of (B, N) strain -> (B, f_bins, t_bins) normalized energy.

    ``median_stride`` > 1 estimates a row's median from every k-th sample;
    each bucket clamps the stride so at least 64 samples (or the whole row)
    enter the estimate.

    ``time_decimation`` d > 1 (gwkit's legacy knob) folds each bucket of
    length L with L // d >= t_bins to L // d: its spectrum's d slices are
    summed, which gives the row's energies at every d-th sample exactly
    (:func:`_tile_energy`). The normalizer, the peak and the interpolation
    taps are then taken on the folded grid, so the spectrogram differs
    slightly from d = 1's."""
    if plan is None:
        plan = make_qplan(duration, sample_rate, q_range, spectrogram_shape)
    with annotate("gw.qscan"):
        tinterp, rowmax = _row_energies(strain, plan, norm, median_stride, time_decimation)
        return _plane_select(tinterp, rowmax, plan, _plan_tensors(plan, strain.device).freq_interp)


def _normalizer(energy: torch.Tensor, norm: str, stride: int) -> torch.Tensor:
    """A row's normalizer over its last axis (median of every ``stride``-th
    sample, mean, or 1), at least 1e-30; the axis is kept."""
    if norm == "median":
        denom = median(energy[..., ::stride] if stride > 1 else energy, dim=-1, keepdim=True)
    elif norm == "mean":
        denom = energy.mean(dim=-1, keepdim=True)
    else:
        denom = torch.ones_like(energy[..., :1])
    return torch.clamp(denom, min=1e-30)


def _tile_energy(spec: torch.Tensor, d: int = 1, rescale: bool = False) -> torch.Tensor:
    """|iFFT|^2 of (..., L) band spectra. With d > 1 the spectrum is first
    folded to L // d (its d slices summed): the result is the energy at
    every d-th sample, times d^2, which ``rescale`` divides out (gwkit
    skips that pass where a median or mean normalizer cancels it)."""
    if d > 1:
        spec = spec.reshape(*spec.shape[:-1], d, spec.shape[-1] // d).sum(dim=-2)
    y = torch.fft.ifft(spec, dim=-1)
    energy = y.real ** 2 + y.imag ** 2
    if d > 1 and rescale:
        energy = energy * (1.0 / d ** 2)
    return energy


def _row_energies(strain: torch.Tensor, plan: QPlan, norm: str, median_stride: int, time_decimation: int = 1):
    """Every row's normalized energy on the output time grid (B, rows,
    t_bins) and its peak (B, rows), rows in plane-major order."""
    tabs = _plan_tensors(plan, strain.device)
    d = max(1, int(time_decimation))
    fseries = torch.fft.rfft(strain.float(), dim=-1)  # (B, F)
    tinterp_parts, rowmax_parts = [], []
    for bucket, (gidx, gw) in zip(plan.buckets, tabs.buckets):
        # gwkit folds only rows that keep at least t_bins samples: shorter
        # ones would blur below the output grid for little saving
        fold = d if d > 1 and bucket.length // d >= tabs.t_bins else 1
        energy = _tile_energy(fseries[:, gidx] * gw, fold, rescale=norm == "none")  # (B, n_L, L // fold)
        L = energy.shape[-1]
        denom = _normalizer(energy, norm, min(median_stride, max(1, L // 64)))
        lo, hi, w = tabs.taps(L)
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


# ---------------------------------------------------------------------------
# The streaming Q-scan (gwkit's ``--qscan-stream``): one band iFFT per Q row
# over a whole chunk of whitened strain, every window cropped from it.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamBucket:
    """One window-plan bucket's rows, transformed at chunk scale.

    Holds each row's band as compact vectors (center bin, half-width,
    qprime/f, normalization); :func:`stream_energies` rebuilds the band
    windows from them. The dense (n_rows, L_b) tables are properties, for
    tests and small geometries."""
    window_length: int          # L_w: the row's native per-window ntiles
    length: int                 # L_b = L_w * chunk_seconds / window_duration
    chunk_seconds: int
    n_bins: int                 # chunk rfft bins (index validity bound)
    rows: np.ndarray            # plane-major row indices (same as QBucket)
    centers: np.ndarray         # (n_rows,) int32 rfft bin of each row center
    halves: np.ndarray          # (n_rows,) int32 band half-width in bins
    qpof: np.ndarray            # (n_rows,) f64 qprime / f
    normv: np.ndarray           # (n_rows,) f64 row normalization constant

    def _signed_offsets(self) -> np.ndarray:
        j = np.arange(self.length)
        return ((j + self.length // 2) % self.length) - self.length // 2

    @property
    def gather_idx(self) -> np.ndarray:
        k = self._signed_offsets()
        idx = self.centers[:, None] + k[None, :]
        valid = ((np.abs(k)[None, :] <= self.halves[:, None])
                 & (idx >= 0) & (idx < self.n_bins))
        return np.where(valid, idx, 0).astype(np.int32)

    @property
    def gather_weight(self) -> np.ndarray:
        k = self._signed_offsets()
        idx = self.centers[:, None] + k[None, :]
        valid = ((np.abs(k)[None, :] <= self.halves[:, None])
                 & (idx >= 0) & (idx < self.n_bins))
        xf = np.clip((k[None, :] / self.chunk_seconds) * self.qpof[:, None], -1.0, 1.0)
        w = (1.0 - xf ** 2) ** 2 * self.normv[:, None]
        return np.where(valid, w, 0.0).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    base: QPlan                 # the per-window plan (rows/planes/interp)
    chunk_seconds: int          # chunk duration (s; power of two)
    chunk_samples: int          # chunk_seconds * sample_rate
    buckets: Tuple[StreamBucket, ...]


@functools.lru_cache(maxsize=8)
def make_stream_plan(
    duration: float = 1.0,
    sample_rate: float = 2048.0,
    q_range: Tuple[float, float] = (4.0, 128.0),
    spectrogram_shape: Tuple[int, int] = (128, 128),
    mismatch: float = 0.2,
    chunk_seconds: int = 16,
) -> StreamPlan:
    """Chunk-scale band geometry for every row of the per-window Q plan.

    Each row keeps its window-plan center frequency and Q; its bisquare band
    is re-evaluated on the chunk's rfft grid (df = 1/chunk_seconds) over the
    same fractional support, and its energy series length scales to
    L_b = ntiles * chunk_seconds / duration: the row's per-window sampling
    rate sustained across the chunk, so a crop of L_w samples lands on the
    per-window grid's instants. The per-row normalization constant is the
    window plan's (for norm median or mean any per-row constant cancels).
    """
    COUNTERS["builds"] += 1
    base = make_qplan(duration, sample_rate, q_range, spectrogram_shape, mismatch)
    t_c = int(chunk_seconds)
    if t_c % duration != 0 or t_c <= duration:
        raise ValueError("chunk_seconds must be a multiple of (and exceed) duration")
    c_samples = int(round(t_c * sample_rate))
    n_bins = c_samples // 2 + 1
    sbuckets = []
    for b in base.buckets:
        l_w = b.length
        l_b = int(l_w * t_c / duration)
        f = base.row_f[b.rows]
        q = base.row_q[b.rows]
        qprime = q / np.sqrt(11.0)
        halves = (f / qprime * t_c).astype(np.int64)
        assert (2 * halves + 1 <= l_b).all(), "band wider than the row's chunk grid"
        normv = l_w / (duration * sample_rate) * np.sqrt(315.0 * qprime / (128.0 * f))
        sbuckets.append(StreamBucket(
            window_length=l_w, length=l_b, chunk_seconds=t_c, n_bins=n_bins,
            rows=b.rows,
            centers=np.round(f * t_c).astype(np.int32),
            halves=halves.astype(np.int32),
            qpof=(qprime / f).astype(np.float64),
            normv=normv.astype(np.float64),
        ))
    return StreamPlan(base=base, chunk_seconds=t_c, chunk_samples=c_samples,
                      buckets=tuple(sbuckets))


class _StreamTensors:
    """A stream plan's tables on one device (built once per (plan,
    device)): per bucket the rows' band windows (the same f32 arithmetic as
    gwkit's, which builds them inside its program) and the output-grid taps
    of a window crop."""

    def __init__(self, plan: StreamPlan, device: torch.device):
        t_bins = plan.base.shape[1]
        self.windows, self.taps = [], []
        for sb in plan.buckets:
            k = np.arange(sb.length) - sb.length // 2  # natural-order signed offsets
            xf = np.clip((k / sb.chunk_seconds).astype(np.float32)[None, :] * sb.qpof.astype(np.float32)[:, None],
                         np.float32(-1.0), np.float32(1.0))
            w = np.where(np.abs(k)[None, :] <= sb.halves[:, None],
                         (np.float32(1.0) - xf ** 2) ** 2 * sb.normv.astype(np.float32)[:, None], np.float32(0.0))
            self.windows.append(torch.from_numpy(w.astype(np.float32)).to(device))
            # a crop's taps: xtap are the output bins' window-relative
            # positions; floor(frac + xtap) is flo or flo + 1
            l_w = sb.window_length
            xtap = np.clip((np.arange(t_bins) + 0.5) * (l_w / t_bins) - 0.5, 0.0, l_w - 1.0)
            flo = np.floor(xtap).astype(np.int64)
            step = np.diff(flo)
            strided = len(flo) > 1 and (step == step[0]).all() and step[0] >= 1
            self.taps.append((
                (int(flo[0]), int(step[0])) if strided else torch.from_numpy(flo).to(device),
                torch.from_numpy((xtap - flo).astype(np.float32)).to(device)))


# (id(plan), device) -> (plan, tables); holding the plan keeps its id unique
_STREAM_TABLES: Dict[Tuple[int, str], Tuple[StreamPlan, _StreamTensors]] = {}


def _stream_tensors(plan: StreamPlan, device: torch.device) -> _StreamTensors:
    key = (id(plan), str(device))
    hit = _STREAM_TABLES.get(key)
    if hit is None:
        COUNTERS["builds"] += 1
        hit = _STREAM_TABLES[key] = (plan, _StreamTensors(plan, device))
    return hit[1]


def stream_energies(chunk: torch.Tensor, plan: StreamPlan) -> Tuple[torch.Tensor, ...]:
    """Per-bucket (D, n_rows, L_b) f32 Q-row energy series of one strain
    chunk (D, chunk_samples): computed once a chunk and shared by every
    window cropped from it.

    One rfft of the chunk; per bucket, every row's band in natural order
    (rfft bins [c - L/2, c + L/2), zero outside the spectrum) as a slice of
    the padded spectrum, times the row's bisquare window, then one batched
    iFFT and |.|^2. Natural order is the iFFT's signed-offset order shifted
    by L/2, which multiplies the series by (-1)^m, and |.|^2 erases that.
    The complex spectra are freed bucket by bucket."""
    with annotate("gw.qscan"):
        tabs = _stream_tensors(plan, chunk.device)
        fseries = torch.fft.rfft(chunk.float(), dim=-1)  # (D, n_bins)
        n_bins = fseries.shape[-1]
        out = []
        for sb, w in zip(plan.buckets, tabs.windows):
            half_l = sb.length // 2
            padded = torch.nn.functional.pad(fseries, (half_l, max(0, int(sb.centers.max()) + half_l - n_bins)))
            # row i's band is the slice padded[:, c_i : c_i + L]
            spec = torch.stack([padded[:, c: c + sb.length] for c in sb.centers.tolist()], dim=1) * w  # (D, n_rows, L)
            y = torch.fft.ifft(spec, dim=-1)
            del spec
            out.append(y.real ** 2 + y.imag ** 2)
            del y
        return tuple(out)


def _stream_rows(energies: Tuple[torch.Tensor, ...], starts_sec: torch.Tensor, plan: StreamPlan,
                 norm: str, median_stride: int):
    """Every row's normalized energy on the output time grid (B, D, rows,
    t_bins) and its peak (B, D, rows), rows in plane-major order, for B
    windows starting ``starts_sec`` (f32, seconds from the chunk's start)."""
    base = plan.base
    t_bins = base.shape[1]
    tabs = _stream_tensors(plan, energies[0].device)
    tparts, mparts = [], []
    for sb, energy, (tap0, ufrac) in zip(plan.buckets, energies, tabs.taps):
        l_w, l_b = sb.window_length, sb.length
        pos0 = starts_sec * (l_w / base.duration)  # (B,) fractional row-grid window starts
        # one contiguous crop of l_w + 3 native samples a window; the taps
        # below are slices of it. At the chunk's end i0 is clamped and frac
        # may exceed 1.
        i0 = torch.clamp(torch.floor(pos0).to(torch.int64), 0, l_b - (l_w + 3))
        frac = pos0 - i0.float()
        idx = i0[:, None] + torch.arange(l_w + 3, device=i0.device)[None, :]
        crop = energy[:, :, idx].permute(2, 0, 1, 3)  # (B, D, n_rows, l_w+3)
        # the normalizer and peak from the native samples at round(pos0) = i0 + (frac >= 0.5)
        s = min(median_stride, max(1, l_w // 64))
        ro = (frac >= 0.5)[:, None, None, None]
        mcrop = torch.where(ro, crop[..., 1:l_w + 1:s], crop[..., 0:l_w:s])
        denom = _normalizer(mcrop, norm, 1)[..., 0]  # (B, D, n_rows)
        mparts.append(mcrop.amax(dim=-1) / denom)
        # 2-tap interpolation onto the output grid: three taps of the crop
        # (strided slices where the tap step is uniform) blended by
        # u = frac + (xtap - flo)
        if isinstance(tap0, tuple):
            f0, st = tap0
            taps = [crop[..., f0 + d: f0 + d + st * t_bins: st] for d in (0, 1, 2)]
        else:
            taps = [crop.index_select(-1, tap0 + d) for d in (0, 1, 2)]
        ub = (frac[:, None] + ufrac[None])[:, None, None, :]
        tint = torch.where(ub < 1.0, (1.0 - ub) * taps[0] + ub * taps[1],
                           (2.0 - ub) * taps[1] + (ub - 1.0) * taps[2])
        tparts.append(tint / denom[..., None])
    row_inv = _plan_tensors(base, energies[0].device).row_inv
    return torch.cat(tparts, dim=2)[:, :, row_inv], torch.cat(mparts, dim=2)[:, :, row_inv]


def stream_crops(energies: Tuple[torch.Tensor, ...], starts_sec: torch.Tensor, plan: StreamPlan, *,
                 norm: str = "median", median_stride: int = 1) -> torch.Tensor:
    """Q spectrograms (B, D, f_bins, t_bins) of B windows cropped from a
    chunk's row energies; ``starts_sec`` (B,) are the windows' starts in
    seconds from the chunk's start (f32, may be fractional). The
    normalizer (median or mean over time) and the best-plane peak come from
    a strided crop of each row's native samples, as :func:`qscan`'s
    ``median_stride``; the plane is chosen per (window, detector)."""
    with annotate("gw.qscan"):
        tinterp, rowmax = _stream_rows(energies, starts_sec, plan, norm, median_stride)
        b_win, d_det = tinterp.shape[:2]
        base = plan.base
        out = _plane_select(tinterp.reshape(b_win * d_det, -1, base.shape[1]), rowmax.reshape(b_win * d_det, -1),
                            base, _plan_tensors(base, tinterp.device).freq_interp)
        return out.reshape(b_win, d_det, *base.shape)


def qscan_stream(chunk: torch.Tensor, starts_sec: torch.Tensor, plan: StreamPlan, *,
                 norm: str = "median", median_stride: int = 1) -> torch.Tensor:
    """One-shot streaming Q-scan: :func:`stream_energies` then
    :func:`stream_crops`. The search calls the two halves apart, so that a
    whitening block's energies serve every batch of its windows; each half
    opens its own ``gw.qscan`` span."""
    return stream_crops(stream_energies(chunk, plan), starts_sec, plan, norm=norm,
                        median_stride=median_stride)
