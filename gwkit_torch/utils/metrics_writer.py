"""Training metrics sinks (counterpart of ``gwkit/utils/metrics_writer.py``):
TSV scalars always, TensorBoard when it imports (imported lazily). An
instance is a ``Trainer`` ``metrics_callback``."""
from __future__ import annotations

import os
from typing import Dict


class MetricsWriter:
    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.tsv_path = os.path.join(logdir, "scalars.tsv")
        self._tsv = open(self.tsv_path, "a", buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(logdir)
            except Exception:
                self._tb = None

    def __call__(self, step: int, metrics: Dict[str, float]) -> None:
        for key, val in metrics.items():
            self._tsv.write(f"{step}\t{key}\t{val}\n")
            if self._tb is not None:
                self._tb.add_scalar(key, val, step)

    def close(self) -> None:
        self._tsv.close()
        if self._tb is not None:
            self._tb.close()
