"""Device-resident injection datasets (counterpart of ``gwkit/data/datasets.py``).

* :class:`InjectionDataset` — noises [N, D, T], waveforms [M, D, T] (M <=
  N); index i < M yields ``noise_i + U(snr_lo, snr_hi) * waveform_i`` with
  the one-hot label [1, 0], index >= M yields the pure noise with [0, 1] and
  SNR 0. HDF5 groups ``training``/``validation`` hold ``waveforms`` and
  ``noises``.
* :func:`concat_datasets`, :func:`load_concat_datasets` — several files as
  one dataset, all injection rows first.
* :func:`sample_pretrain_pairs` — InfoNCE pairs: two independently noised
  views of one waveform, or with probability p two pure-noise draws.
* :class:`PartitionedDataset` — the efficiency test's index layout:
  injections pairing waveform ``idx // noises_per_signal + wave_lo`` with
  noise ``idx + comb_lo`` first, then pure noise from ``[pure_lo,
  pure_hi)``; the SNR range is set at run time (curriculum and efficiency
  sweeps).

The arrays live on the device and batches are gathered and mixed there.
Random draws (the SNRs, the shuffling, the pretraining pairs) come from a
``torch.Generator`` seeded from the run's config: the distributions are
gwkit's, but JAX's threefry streams are not reproduced, so the same seed
gives other draws than gwkit's. ``h5py`` is imported only where HDF5 is
read.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from gwkit_torch.device import DeviceLike, resolve_device

WAVE_LABEL = (1.0, 0.0)
NOISE_LABEL = (0.0, 1.0)


def _uniform(generator: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    return (lo + (hi - lo) * torch.rand(shape, generator=generator)).to(device)


@dataclasses.dataclass
class InjectionDataset:
    """noises [N, D, T], waveforms [M, D, T]; the first M indices are
    injections. ``device=None`` is the CUDA card (raises without one)."""

    noises: torch.Tensor
    waveforms: torch.Tensor
    snr_range: Tuple[float, float] = (5.0, 15.0)
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        as_f32 = lambda a: (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a)))
        self.noises = as_f32(self.noises).float().to(self.device)
        self.waveforms = as_f32(self.waveforms).float().to(self.device)
        assert self.noises.shape[1:] == self.waveforms.shape[1:]
        assert len(self.waveforms) <= len(self.noises)

    def __len__(self) -> int:
        return len(self.noises)

    @property
    def n_waveforms(self) -> int:
        return len(self.waveforms)

    def snrs(self, *args):
        """Get or set the SNR range."""
        if len(args) == 0:
            return self.snr_range
        self.snr_range = tuple(args[0]) if len(args) == 1 else (args[0], args[1])

    def sample_batch(self, generator: torch.Generator, indices: torch.Tensor):
        """Gather and mix a batch on the device: (x [B, D, T], y [B, 2], snr [B])."""
        idx = torch.as_tensor(indices, device=self.device).long()
        b, m = idx.shape[0], self.n_waveforms
        noise = self.noises[idx]
        labels = torch.tensor([WAVE_LABEL, NOISE_LABEL], device=self.device)
        if m == 0:  # noise-only dataset (e.g. efficiency FAP-threshold scoring)
            return noise, labels[1].expand(b, 2).clone(), torch.zeros(b, device=self.device)
        wave = self.waveforms[idx.clamp(max=m - 1)]
        is_wave = idx < m
        snr = _uniform(generator, (b,), *self.snr_range, self.device)
        x = noise + torch.where(is_wave[:, None, None], snr[:, None, None] * wave, torch.zeros_like(wave))
        y = labels[(~is_wave).long()]
        return x, y, torch.where(is_wave, snr, torch.zeros_like(snr))

    def batches(self, generator: torch.Generator, batch_size: int, shuffle: bool = True,
                drop_remainder: bool = True) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """One epoch of device batches; without ``drop_remainder`` the last
        batch is wrap-padded to ``batch_size``."""
        n = len(self)
        order = torch.randperm(n, generator=generator).numpy() if shuffle else np.arange(n)
        n_batches = n // batch_size if drop_remainder else -(-n // batch_size)
        for i in range(n_batches):
            idx = order[i * batch_size:(i + 1) * batch_size]
            if len(idx) < batch_size:
                idx = np.pad(idx, (0, batch_size - len(idx)), mode="wrap")
            yield self.sample_batch(generator, torch.from_numpy(np.ascontiguousarray(idx)))

    def save(self, h5file, group_name: str) -> None:
        """Write the two arrays into a new group of an open ``h5py.File``."""
        if group_name in h5file:
            raise IOError(f"Group '{group_name}' already exists.")
        g = h5file.create_group(group_name)
        g.create_dataset("waveforms", data=self.waveforms.cpu().numpy())
        g.create_dataset("noises", data=self.noises.cpu().numpy())

    @classmethod
    def load(cls, h5file, group_name: str, snr_range=(5.0, 15.0),
             device: DeviceLike = None) -> "InjectionDataset":
        if group_name not in h5file:
            raise IOError(f"Group '{group_name}' not found.")
        g = h5file[group_name]
        return cls(noises=g["noises"][()], waveforms=g["waveforms"][()], snr_range=snr_range,
                   device=device)


def concat_datasets(datasets: Sequence[InjectionDataset], snr_range=(5.0, 15.0),
                    device: DeviceLike = None) -> InjectionDataset:
    """Several datasets as one, re-packed so that every injection row comes
    first (the index convention of :class:`InjectionDataset`)."""
    cpu = lambda t: t.cpu().numpy()
    noises = np.concatenate([cpu(ds.noises[:ds.n_waveforms]) for ds in datasets]
                            + [cpu(ds.noises[ds.n_waveforms:]) for ds in datasets], axis=0)
    waveforms = np.concatenate([cpu(ds.waveforms) for ds in datasets], axis=0)
    return InjectionDataset(noises=noises, waveforms=waveforms, snr_range=snr_range, device=device)


def load_concat_datasets(paths: Sequence[str], snr_range=(5.0, 15.0), device: DeviceLike = None):
    """Every HDF5 file's ``training`` and ``validation`` groups, concatenated:
    (train, valid) on ``device``; each file is staged on the CPU first."""
    import h5py

    device = resolve_device(device)
    trains, valids = [], []
    for path in paths:
        with h5py.File(path, "r") as f:
            trains.append(InjectionDataset.load(f, "training", snr_range, "cpu"))
            valids.append(InjectionDataset.load(f, "validation", snr_range, "cpu"))
    return concat_datasets(trains, snr_range, device), concat_datasets(valids, snr_range, device)


def sample_pretrain_pairs(generator: torch.Generator, noises: torch.Tensor, waveforms: torch.Tensor,
                          batch_indices: torch.Tensor, snr_range: Tuple[float, float] = (5.0, 15.0),
                          noise_only_prob: float = 0.25):
    """(X1, X2), each [B, D, T]: one waveform at one SNR plus two independent
    noises, or with probability ``noise_only_prob`` two pure-noise draws."""
    dev = noises.device
    b, n = batch_indices.shape[0], noises.shape[0]
    n1 = noises[torch.randint(0, n, (b,), generator=generator).to(dev)]
    n2 = noises[torch.randint(0, n, (b,), generator=generator).to(dev)]
    wave = waveforms[torch.as_tensor(batch_indices).long().to(dev)]
    snr = _uniform(generator, (b, 1, 1), *snr_range, dev)
    noise_only = torch.rand((b, 1, 1), generator=generator).to(dev) < noise_only_prob
    scaled = torch.where(noise_only, torch.zeros_like(snr), snr) * wave
    return n1 + scaled, n2 + scaled


@dataclasses.dataclass
class PartitionedDataset:
    """Index ranges partition the injection and pure-noise pools: the first
    ``(wave_hi - wave_lo) * noises_per_signal`` indices are injections, the
    rest pure noise. Waveforms and noises are [N, T] or [N, D, T].
    ``device=None`` is the CUDA card (raises without one)."""

    waveforms: torch.Tensor
    noises: torch.Tensor
    snr_range: Tuple[float, float]
    wave_limits: Tuple[int, int]
    noise_combined_limits: Tuple[int, int]
    noise_pure_limits: Tuple[int, int]
    noises_per_signal: int = 1
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        as_tensor = lambda a: a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        self.waveforms = as_tensor(self.waveforms).float().to(self.device)
        self.noises = as_tensor(self.noises).float().to(self.device)
        self.signal_samples = (self.wave_limits[1] - self.wave_limits[0]) * self.noises_per_signal
        assert self.signal_samples == self.noise_combined_limits[1] - self.noise_combined_limits[0]

    def __len__(self) -> int:
        return self.signal_samples + (self.noise_pure_limits[1] - self.noise_pure_limits[0])

    def snrs(self, *args):
        """Get or set the SNR range."""
        if len(args) == 0:
            return self.snr_range
        self.snr_range = tuple(args[0]) if len(args) == 1 else (args[0], args[1])

    def sample_batch(self, generator: torch.Generator, indices: torch.Tensor):
        """(x, y [B, 2], snr [B]) on the device; x has the waveforms' trailing shape."""
        idx = torch.as_tensor(indices, device=self.device).long()
        nw, nn = self.waveforms.shape[0], self.noises.shape[0]
        is_wave = idx < self.signal_samples
        wave_idx = (torch.div(idx, self.noises_per_signal, rounding_mode="floor")
                    + self.wave_limits[0]).clamp(0, nw - 1)
        noise_idx = torch.where(is_wave, (idx + self.noise_combined_limits[0]).clamp(0, nn - 1),
                                (idx - self.signal_samples + self.noise_pure_limits[0]).clamp(0, nn - 1))
        noise, wave = self.noises[noise_idx], self.waveforms[wave_idx]
        snr = _uniform(generator, (idx.shape[0],), *self.snr_range, self.device)
        expand = (...,) + (None,) * (noise.dim() - 1)
        x = noise + torch.where(is_wave[expand], snr[expand] * wave, torch.zeros_like(wave))
        labels = torch.tensor([WAVE_LABEL, NOISE_LABEL], device=self.device)
        return x, labels[(~is_wave).long()], torch.where(is_wave, snr, torch.zeros_like(snr))
