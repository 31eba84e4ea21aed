"""Host-side batching helpers shared by the datasets (counterpart of
``gwkit/train/datasets_util.py``)."""
from __future__ import annotations

import numpy as np


def epoch_indices(n: int, batch_size: int, seed: int, shuffle: bool = True, drop_remainder: bool = True):
    """Yield index arrays of exactly ``batch_size`` (a kept tail is wrap-padded)."""
    order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    n_batches = n // batch_size if drop_remainder else -(-n // batch_size)
    for b in range(n_batches):
        idx = order[b * batch_size:(b + 1) * batch_size]
        if len(idx) < batch_size:
            idx = np.pad(idx, (0, batch_size - len(idx)), mode="wrap")
        yield idx
