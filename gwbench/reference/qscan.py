"""The Q-scan of 1 s windows in float32 torch: GWpy's Q tiling (log-spaced
Q planes, log-spaced frequency rows, each row's bisquare band of the window's
spectrum inverse-transformed at its own power-of-two length), each row's
energy normalized by its median and interpolated (linear, half-pixel
centres) to the output's time bins, each plane's rows interpolated likewise
to the output's frequency bins, and per window the plane with the largest
normalized energy kept."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gwbench.reference.whiten import middle


def q_values(q_range, mismatch):
    deltam = 2.0 * math.sqrt(mismatch / 3.0)
    cumum = math.log(q_range[1] / q_range[0]) / math.sqrt(2.0)
    n = int(max(math.ceil(cumum / deltam), 1))
    dq = cumum / n
    return [q_range[0] * math.exp(math.sqrt(2.0) * dq * (i + 0.5)) for i in range(n)]


def plane_rows(q, duration, sample_rate, mismatch):
    deltam = 2.0 * math.sqrt(mismatch / 3.0)
    minf = 50.0 * q / (2.0 * math.pi * duration)
    maxf = sample_rate / 2.0 / (1.0 + math.sqrt(11.0) / q)
    fcum = math.log(maxf / minf) * math.sqrt(2.0 + q ** 2) / 2.0
    nfreq = int(max(1, math.ceil(fcum / deltam)))
    fstep = fcum / nfreq
    freqs = [(minf * math.exp(2.0 / math.sqrt(2.0 + q ** 2) * (i + 0.5) * fstep)) // (1.0 / duration)
             * (1.0 / duration) for i in range(nfreq)]
    return np.unique(np.asarray(freqs))


class QScan:
    """The tiling of ``duration`` s windows at ``sample_rate`` on ``device``."""

    def __init__(self, duration=1.0, sample_rate=2048.0, q_range=(4.0, 128.0), shape=(128, 128),
                 mismatch=0.2, device="cpu"):
        n = int(round(duration * sample_rate))
        nbins = n // 2 + 1
        deltam = 2.0 * math.sqrt(mismatch / 3.0)
        self.shape = tuple(shape)
        self.planes: List[List[Tuple[int, torch.Tensor, torch.Tensor, List[int]]]] = []
        self.n_rows: List[int] = []
        for q in q_values(q_range, mismatch):
            freqs = plane_rows(q, duration, sample_rate, mismatch)
            qprime = q / math.sqrt(11.0)
            by_len: Dict[int, list] = {}
            for r, f in enumerate(freqs):
                size = 2 * int(f / qprime * duration) + 1
                L = 2 ** int(math.ceil(math.log2(max(duration * 2.0 * math.pi * f / q / deltam, 1.0))))
                k = np.arange(size) - (size - 1) // 2
                xf = (k / duration) * qprime / f
                window = (1.0 - xf ** 2) ** 2 * (L / (duration * sample_rate)) * math.sqrt(315.0 * qprime / (128.0 * f))
                src = int(round(f * duration)) + k
                ok = (src >= 0) & (src < nbins)
                idx = np.zeros(L, np.int64)
                wts = np.zeros(L, np.float64)
                idx[np.mod(k[ok], L)] = src[ok]
                wts[np.mod(k[ok], L)] = window[ok]
                by_len.setdefault(L, []).append((r, idx, wts))
            groups = []
            for L, rows in sorted(by_len.items()):
                groups.append((L, torch.from_numpy(np.stack([i for _, i, _ in rows])).to(device),
                               torch.from_numpy(np.stack([w for _, _, w in rows]).astype(np.float32)).to(device),
                               [r for r, _, _ in rows]))
            self.planes.append(groups)
            self.n_rows.append(len(freqs))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(B, n) whitened windows -> (B, f_bins, t_bins)."""
        f_bins, t_bins = self.shape
        spec = torch.fft.rfft(x.float(), dim=-1)
        B = x.shape[0]
        planes, peaks = [], []
        for groups, n_rows in zip(self.planes, self.n_rows):
            rows = torch.empty(B, n_rows, t_bins, device=x.device)
            rowmax = torch.empty(B, n_rows, device=x.device)
            for L, idx, wts, order in groups:
                y = torch.fft.ifft(spec[:, idx] * wts, dim=-1)
                energy = y.real ** 2 + y.imag ** 2  # (B, rows, L)
                med = middle(energy, dim=-1).clamp(min=1e-30)
                t = F.interpolate(energy.reshape(-1, 1, L), size=t_bins, mode="linear", align_corners=False)
                rows[:, order] = t.reshape(B, len(order), t_bins) / med[..., None]
                rowmax[:, order] = energy.amax(dim=-1) / med
            planes.append(F.interpolate(rows.transpose(1, 2), size=f_bins, mode="linear",
                                        align_corners=False).transpose(1, 2))
            peaks.append(rowmax.amax(dim=-1))
        best = torch.argmax(torch.stack(peaks, dim=1), dim=1)
        return torch.stack(planes, dim=1)[torch.arange(B, device=x.device), best]
