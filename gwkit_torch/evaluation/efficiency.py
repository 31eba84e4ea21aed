"""Detection efficiency: the true-alarm probability against SNR at fixed
false-alarm probabilities (counterpart of ``gwkit/evaluation/efficiency.py``).

Noise-only scores set one threshold per FAP, the k-th largest noise score
with ``k = max(int(FAP * N_noise), 1)``; each SNR's injections, scored at
that fixed SNR, give the fraction above each threshold. Scores stay on the
scorer's device until a dataset's pass ends and move to the host once.
"""
from __future__ import annotations

import logging
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch


class EfficiencyEstimator:
    """``score_fn(x_batch) -> signal scores`` (a tensor); the datasets are
    :class:`gwkit_torch.data.datasets.InjectionDataset`-like: ``snrs()``
    and ``batches()``."""

    def __init__(self, wave_dataset, noise_dataset, snrs: Sequence[float], batch_size: int = 16,
                 faps: Sequence[float] = (1e-2, 1e-3, 1e-4)):
        self.wave_dataset = wave_dataset
        self.noise_dataset = noise_dataset
        self.snrs = list(snrs)
        self.batch_size = batch_size
        self.faps = list(faps)

    def _collect_scores(self, dataset, score_fn: Callable, seed: int) -> np.ndarray:
        generator = torch.Generator().manual_seed(seed)
        scores = [score_fn(batch[0]).reshape(-1)
                  for batch in dataset.batches(generator, self.batch_size, shuffle=False, drop_remainder=False)]
        # the last batch is wrap-padded to the batch size: each sample counts once
        return torch.cat(scores).float().cpu().numpy()[: len(dataset)]

    def scores(self, score_fn: Callable, seed: int = 0) -> Tuple[np.ndarray, List[np.ndarray]]:
        """(the noise set's scores, each SNR's injection scores)."""
        self.noise_dataset.snrs((0.0, 0.0))
        noise = self._collect_scores(self.noise_dataset, score_fn, seed)
        waves = []
        for snr in self.snrs:
            self.wave_dataset.snrs((snr, snr))
            waves.append(self._collect_scores(self.wave_dataset, score_fn, seed))
        return noise, waves

    def thresholds(self, noise_scores: np.ndarray) -> np.ndarray:
        """The k-th largest noise score at each FAP, k = max(int(FAP * N), 1)."""
        ranked = np.sort(noise_scores)
        counts = (np.asarray(self.faps) * len(noise_scores)).astype(int)
        return np.array([ranked[-max(c, 1)] for c in counts])

    def table(self, noise_scores: np.ndarray, wave_scores: List[np.ndarray]) -> np.ndarray:
        """Efficiencies (len(snrs), len(faps)) from :meth:`scores`' arrays."""
        thresholds = self.thresholds(noise_scores)
        logging.info("efficiency thresholds at FAPs %s: %s", self.faps, thresholds)
        return np.stack([(w[:, None] > thresholds[None, :]).mean(axis=0) for w in wave_scores], axis=0)

    def __call__(self, score_fn: Callable, seed: int = 0) -> np.ndarray:
        """Efficiencies of shape (len(snrs), len(faps))."""
        return self.table(*self.scores(score_fn, seed))


def write_efficiency_table(path: str, snrs, faps, efficiencies: np.ndarray) -> None:
    """The reference's out_efficiencies_*.txt layout: a header row of FAPs,
    then one row per SNR."""
    with open(path, "w") as f:
        f.write("# SNR\t" + "\t".join(f"FAP={fap:g}" for fap in faps) + "\n")
        for snr, row in zip(snrs, efficiencies):
            f.write(f"{snr:g}\t" + "\t".join(f"{v:.6f}" for v in row) + "\n")
