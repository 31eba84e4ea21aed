"""Gravity Spy glitch data (counterpart of the training half of
``gwkit/data/glitch.py``): the 11-class taxonomy and the labeled strain
dataset with its label-preserving augmentation. The preprocessing and the
synthetic and realistic generators are data generation and are not ported
yet (ROADMAP Queue 1 item 15).

Random draws (the epoch order, the augmentation) come from a
``torch.Generator``: the distributions are gwkit's, JAX's streams are not.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from gwkit_torch.device import DeviceLike, resolve_device
from gwkit_torch.train.datasets_util import epoch_indices

# the 11-way taxonomy of the reference's shipped model (classification report)
GLITCH_CLASSES = (
    "1080 Lines",
    "Blip",
    "Blip Low Freq",
    "Fast Scattering",
    "GW",
    "Koi Fish",
    "No Glitch",
    "Power Line",
    "Scattered Light",
    "Tomte",
    "Whistle",
)
CLASS_TO_INDEX = {name: i for i, name in enumerate(GLITCH_CLASSES)}


class LabeledDataset:
    """Labeled strain (N, T) with integer labels (N,), on ``device``
    (``None``: the CUDA card; raises without one), with the ``batches``
    protocol. ``augment`` applies :func:`_augment_batch` to each batch."""

    def __init__(self, strain, labels, augment: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.strain = torch.as_tensor(np.asarray(strain, np.float32)).to(self.device)
        self.labels = torch.as_tensor(np.asarray(labels, np.int64)).to(self.device)
        self.augment = augment

    def __len__(self) -> int:
        return len(self.labels)

    def batches(self, generator: torch.Generator, batch_size: int, shuffle: bool = True,
                drop_remainder: bool = True) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """One epoch of (strain (B, T), labels (B,)) device batches."""
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator))
        for idx in epoch_indices(len(self), batch_size, seed, shuffle, drop_remainder):
            idx = torch.from_numpy(np.ascontiguousarray(idx)).to(self.device)
            x = self.strain[idx]
            if self.augment:
                x = _augment_batch(generator, x)
            yield x, self.labels[idx]


def _augment_batch(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Per row: a circular shift within +-n/10 samples (+-0.1 s of a 1 s
    window), a sign flip with probability 1/2 and an amplitude from
    U(0.7, 1.4); all three are symmetries of the whitened-strain task."""
    b, n = x.shape
    max_shift = n // 10
    shifts = torch.randint(-max_shift, max_shift + 1, (b,), generator=generator)
    sign = torch.where(torch.rand(b, generator=generator) < 0.5, 1.0, -1.0)
    amp = 0.7 + 0.7 * torch.rand(b, generator=generator)
    idx = (torch.arange(n)[None, :] - shifts[:, None]) % n  # roll row i by shifts[i]
    rolled = torch.gather(x, 1, idx.to(x.device))
    return rolled * (sign * amp).to(x.device, x.dtype)[:, None]
