"""Real-event scoring (counterpart of ``gwkit/search/realevents.py``): long
strain around a catalog event is cut into overlapping windows (2048
samples at 2048 Hz, a step of 204 = 0.1 s) by the device slicer, each
window is scored by the two-channel classifier, and each event's sigmoid
score series is written to HDF5. ``h5py`` is imported only to write.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict

import numpy as np
import torch

from gwkit_torch.search.slicer import DeviceSlicer, Segment, SlicerConfig


def score_event_segments(task, events: Dict[str, np.ndarray], sample_rate: float = 2048.0, window: int = 2048,
                         step: int = 204, batch_size: int = 64, trainable=None,
                         white: bool = True) -> Dict[str, np.ndarray]:
    """``events``: {event name: strain (2, N)}, already whitened unless
    ``white=False`` (then the slicer whitens it), scored on the task's
    device (``None``: the CUDA card; raises without one). Returns {event name: sigmoid score per window}. ``trainable`` replaces
    the task's trainables for this call."""
    if trainable is not None:
        task = dataclasses.replace(task, trainable=trainable)
    cfg = SlicerConfig(step_size=step / sample_rate, slice_length=window, batch_size=batch_size, peak_offset=0.0)
    out: Dict[str, np.ndarray] = {}
    for name, strain in events.items():
        seg = Segment(key=name, strain=np.asarray(strain), start_time=0.0, delta_t=1.0 / sample_rate)
        scores = []
        for windows, _, valid in DeviceSlicer(seg, cfg, white=white, device=task.device).batches():
            s = torch.sigmoid(task.forward(windows).reshape(-1))[: len(valid)]
            scores.append(s[torch.from_numpy(valid).to(s.device)])
        out[name] = torch.cat(scores).float().cpu().numpy() if scores else np.zeros(0, np.float32)
        logging.info("event %s: %d windows, max score %.4f", name, len(out[name]),
                     out[name].max() if len(out[name]) else float("nan"))
    return out


def write_event_scores(path: str, scores: Dict[str, np.ndarray]) -> None:
    """The layout of results_2_detectors_real_events.hdf: one dataset per event."""
    import h5py

    with h5py.File(path, "w") as f:
        for name, vals in scores.items():
            f.create_dataset(name, data=np.asarray(vals, np.float32))
