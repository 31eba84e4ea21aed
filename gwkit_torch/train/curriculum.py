"""Curriculum-learning SNR schedulers (a copy of ``gwkit/train/curriculum.py``,
which is plain Python).

Parity with Efficiency_test/src/tools.py:195-331: a ladder of SNR ranges is
stepped down during training; stepping optionally resets the optimizer state.
The scheduler owns the current range; the dataset's sampling reads it.

Variants:
  * PlateauCLScheduler   — step when a metric plateaus for `patience` epochs
  * ThresholdCLScheduler — step when a metric crosses a threshold
  * EpochCLScheduler     — step every `patience` epochs
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

SNRRange = Tuple[float, float]


class CurriculumScheduler:
    """Base: iterate over snr_ranges; optionally reset optimizer state on step."""

    def __init__(
        self,
        snr_ranges: Sequence[SNRRange],
        verbose: bool = True,
        on_step: Optional[Callable[[], None]] = None,
    ):
        self.snr_ranges = list(snr_ranges)
        self.verbose = verbose
        self.on_step = on_step  # e.g. lambda: reset optimizer state
        self.done = False
        self.interrupt = False
        self._iter = iter(self.snr_ranges)
        self._next = next(self._iter)
        self.current: SNRRange = self._next
        self._advance()

    def _advance(self) -> None:
        old = self.current
        self.current = self._next
        if self.verbose:
            print(f"# Reducing SNR range from {old[0]:f}-{old[1]:f} to {self.current[0]:f}-{self.current[1]:f}")
        try:
            self._next = next(self._iter)
        except StopIteration:
            self.done = True
        if self.on_step is not None:
            self.on_step()

    def step(self, *metrics) -> None:  # pragma: no cover - abstract
        raise NotImplementedError


class PlateauCLScheduler(CurriculumScheduler):
    def __init__(self, *args, patience=4, threshold=1e-4, threshold_mode="rel",
                 optimization_mode="min", metric_index=0, allow_interrupt=False, **kwargs):
        super().__init__(*args, **kwargs)
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.optimization_mode = optimization_mode
        self.metric_index = metric_index
        self.allow_interrupt = allow_interrupt
        self.best: Optional[float] = None
        self.num_bad_epochs: Optional[int] = None

    def _is_better(self, a: float) -> bool:
        if self.best is None:
            return True
        sign = 1.0 if self.optimization_mode == "max" else -1.0
        if self.threshold_mode == "rel":
            bound = self.best * (1.0 + sign * self.threshold)
        elif self.threshold_mode == "abs":
            bound = self.best + sign * self.threshold
        else:
            raise NotImplementedError(self.threshold_mode)
        return a > bound if self.optimization_mode == "max" else a < bound

    def step(self, *metrics) -> None:
        current = float(metrics[self.metric_index])
        if self._is_better(current):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs = (self.num_bad_epochs or 0) + 1
        if self.num_bad_epochs is not None and self.num_bad_epochs > self.patience:
            if self.done:
                if self.allow_interrupt:
                    self.interrupt = True
            else:
                self._advance()
                self.best = None
                self.num_bad_epochs = None


class ThresholdCLScheduler(CurriculumScheduler):
    def __init__(self, *args, threshold=0.2, optimization_mode="min", metric_index=0, **kwargs):
        super().__init__(*args, **kwargs)
        self.threshold = threshold
        self.optimization_mode = optimization_mode
        self.metric_index = metric_index

    def step(self, *metrics) -> None:
        current = float(metrics[self.metric_index])
        crossed = current <= self.threshold if self.optimization_mode == "min" else current >= self.threshold
        if crossed and not self.done:
            self._advance()


class EpochCLScheduler(CurriculumScheduler):
    def __init__(self, *args, patience=4, **kwargs):
        super().__init__(*args, **kwargs)
        self.patience = patience
        self.num_epochs = 0

    def step(self, *metrics) -> None:
        self.num_epochs += 1
        if self.num_epochs > self.patience and not self.done:
            self.num_epochs = 0
            self._advance()
