"""Early stopping on validation loss (a copy of ``gwkit/train/early_stopping.py``).

Parity with the reference's EarlyStopper (Signal_vs_Noise/src/utils.py:12-27,
duplicated in Glitch_classification/src/utils.py — deduplicated here) and the
patience counter inside SupervisedTrainer.fit (MLGWSC-1/train.py:610-614).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class EarlyStopper:
    patience: int = 15
    min_delta: float = 0.0
    counter: int = 0
    min_validation_loss: float = float("inf")

    def early_stop(self, validation_loss: float) -> bool:
        if validation_loss < self.min_validation_loss:
            self.min_validation_loss = validation_loss
            self.counter = 0
        elif validation_loss > self.min_validation_loss + self.min_delta:
            self.counter += 1
            if self.counter >= self.patience:
                return True
        return False
