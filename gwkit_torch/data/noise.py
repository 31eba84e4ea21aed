"""Gaussian noise synthesis from PSDs, batched on the card (counterpart of
``gwkit/data/noise.py``).

Colored-noise recipe: one-sided PSD S_k, N samples at delta_t -> complex
spectrum Z_k = (a_k + i b_k) sqrt(S_k N / (4 delta_t)), a, b ~ N(0, 1);
x = irfft(Z), so that E[PSD(x)] = S. DC is zero and Nyquist real.

Random draws come from a seeded ``torch.Generator`` on the target device.
gwkit draws from ``jax.random`` keys, whose splitting the port does not
reproduce, and a torch seed gives the same stream only on the same device
type: seeded outputs agree run to run per device type, not across packages
or between the card and the CPU. ``colored_noise_core`` takes the two draws
explicitly, so the same draws give the same noise anywhere.

Data generation (``gwkit_torch/data/generate.py``, the realistic glitch
corpus) takes every draw through :func:`seeded_draws`: one generator per
stream, an integer tuple such as (seed, segment, detector, chunk), seeded
through ``np.random.SeedSequence``. A stream's draws do not depend on what
else is drawn, batched or skipped, so a resumed run needs no replay, and
tests substitute this one function to feed both packages the same draws.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from gwkit_torch.device import DeviceLike, resolve_device
from gwkit_torch.ops.psd import get_psd


def colored_noise_core(a: torch.Tensor, b: torch.Tensor, n: int, delta_t: float,
                       psd: torch.Tensor) -> torch.Tensor:
    """(..., N) noise from the normal draws ``a``, ``b`` of shape
    (..., N//2+1) and a PSD broadcastable to them, on their device.

    PSDs must be normalized to a representable f32 scale; to generate
    physical 1e-21 strain, generate with psd/c and multiply by sqrt(c)."""
    amp = torch.sqrt(psd * n / (4.0 * delta_t))
    z = torch.complex(a, b) * amp
    z[..., 0] = 0.0
    z[..., -1] = a[..., -1] * torch.sqrt(psd[..., -1] * n / (2.0 * delta_t))
    return torch.fft.irfft(z, n, dim=-1)


# the second element of every data-generation stream, so that no two uses of
# one seed share draws
STREAM_CHALLENGE, STREAM_REAL_NOISE, STREAM_TRAINING, STREAM_GLITCH = 0, 1, 2, 3


def seeded_draws(stream: Sequence[int], shape, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two standard-normal draws (a, b) of ``shape`` of one noise
    realization, from a ``torch.Generator`` on ``device`` seeded by the
    integer tuple ``stream`` through ``np.random.SeedSequence``."""
    seed = int(np.random.SeedSequence([int(s) for s in stream]).generate_state(1, np.uint64)[0] >> np.uint64(1))
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(shape, generator=gen, device=device)
    b = torch.randn(shape, generator=gen, device=device)
    return a, b


def seeded_colored_noise(streams: Sequence[Sequence[int]], n: int, delta_t: float,
                         psd: torch.Tensor) -> torch.Tensor:
    """(len(streams), ..., N) noise, realization i from stream i's
    :func:`seeded_draws`; ``psd`` (..., N//2+1) on the target device is
    shared by every realization."""
    shape = psd.shape[:-1] + (n // 2 + 1,)
    draws = [seeded_draws(s, shape, psd.device) for s in streams]
    a = torch.stack([d[0] for d in draws])
    b = torch.stack([d[1] for d in draws])
    return colored_noise_core(a, b, n, delta_t, psd)


def colored_noise(generator: torch.Generator, n: int, delta_t: float, psd: torch.Tensor) -> torch.Tensor:
    """One realization per leading PSD batch dim: psd (..., N//2+1) -> (..., N),
    the draws taken from ``generator`` on the PSD's device."""
    shape = psd.shape[:-1] + (n // 2 + 1,)
    a = torch.randn(shape, generator=generator, device=psd.device)
    b = torch.randn(shape, generator=generator, device=psd.device)
    return colored_noise_core(a, b, n, delta_t, psd)


class NoiseGenerator:
    """Chunked, seeded colored-noise generation (bnslib.py:1588-1705 surface).

    ``get(n_samples, duration)`` returns (n_samples, N) f32 noise on the
    device at physical scale from the named or given PSD, generated in
    chunks along the batch axis to bound device memory. ``device=None`` is
    the card, and raises without one."""

    def __init__(self, psd: "str | np.ndarray" = "aLIGOZeroDetHighPower", sample_rate: float = 2048.0,
                 low_freq_cutoff: float = 15.0, seed: int = 0, chunk_samples: int = 256,
                 device: DeviceLike = None):
        self.psd_spec = psd
        self.sample_rate = sample_rate
        self.low_freq_cutoff = low_freq_cutoff
        self.seed = seed
        self.chunk_samples = chunk_samples
        self.device = resolve_device(device)

    def _psd(self, n: int) -> Tuple[torch.Tensor, float]:
        flen = n // 2 + 1
        delta_f = self.sample_rate / n
        if isinstance(self.psd_spec, str):
            psd = get_psd(self.psd_spec, flen, delta_f, self.low_freq_cutoff)
        else:
            psd = np.asarray(self.psd_spec)
        pos = psd > 0
        c = float(psd[pos].mean()) if pos.any() else 1.0
        return torch.from_numpy((psd / c).astype(np.float32)).to(self.device), c

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.seed)

    def get(self, n_samples: int, duration: float) -> torch.Tensor:
        n = int(round(duration * self.sample_rate))
        psd_n, c = self._psd(n)
        out = torch.empty((n_samples, n), dtype=torch.float32, device=self.device)
        gen = self._generator()
        scale = float(np.sqrt(c))
        for s in range(0, n_samples, self.chunk_samples):
            e = min(s + self.chunk_samples, n_samples)
            batch_psd = psd_n.expand(e - s, psd_n.shape[-1])
            out[s:e] = colored_noise(gen, n, 1.0 / self.sample_rate, batch_psd) * scale
        return out

    def stream(self, total_duration: float, chunk_duration: float = 3600.0) -> torch.Tensor:
        """Hour-chunked continuous noise (generate_data.py:404-434 semantics):
        chunks are generated independently, so chunk boundaries are not
        phase-continuous (irrelevant after whitening)."""
        chunks = []
        remaining = total_duration
        gen = self._generator()
        while remaining > 0:
            dur = min(chunk_duration, remaining)
            n = int(round(dur * self.sample_rate))
            psd_n, c = self._psd(n)
            chunks.append(colored_noise(gen, n, 1.0 / self.sample_rate, psd_n) * float(np.sqrt(c)))
            remaining -= dur
        return torch.cat(chunks, dim=-1)


class WhiteNoiseGenerator:
    """White Gaussian noise of standard deviation ``sigma`` (bnslib.py:1707-1748
    surface), f32 on the device (``None``: the card)."""

    def __init__(self, sample_rate: float = 2048.0, seed: int = 0, sigma: float = 1.0,
                 device: DeviceLike = None):
        self.sample_rate = sample_rate
        self.seed = seed
        self.sigma = sigma
        self.device = resolve_device(device)

    def get(self, n_samples: int, duration: float) -> torch.Tensor:
        n = int(round(duration * self.sample_rate))
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return torch.randn((n_samples, n), generator=gen, device=self.device) * self.sigma
