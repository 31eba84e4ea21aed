"""Faults planted under a cell's timed path, for the checks that show the
comparison catches them: each wraps the port's entry that the cell's driver
times (``Task.score`` for the search, ``Task.forward`` for classification)
and breaks what it returns.

  half_batch  half of the batch left out: its answers the mean of the rest
  altered     an answer altered where it is produced: +1 on the first row
"""
from __future__ import annotations

import contextlib

import torch

ENTRY = {"search": "score", "classify": "forward"}  # the Task method each driver times


def half_batch(out: torch.Tensor) -> torch.Tensor:
    h = out.shape[0] // 2
    return torch.cat([out[:h], out[:h].mean(dim=0, keepdim=True).expand(out.shape[0] - h, *out.shape[1:])])


def altered(out: torch.Tensor) -> torch.Tensor:
    out = out.clone()
    out[0] = out[0] + 1.0
    return out


FAULTS = {"half_batch": half_batch, "altered": altered}


@contextlib.contextmanager
def planted(driver: str, fault: str):
    """``Task``'s entry for ``driver`` returns ``FAULTS[fault]`` of its
    answers for the duration (set before the cell is built)."""
    from gwkit_torch.train.tasks import Task

    name = ENTRY[driver]
    original = getattr(Task, name)
    setattr(Task, name, lambda self, x: FAULTS[fault](original(self, x)))
    try:
        yield
    finally:
        setattr(Task, name, original)
