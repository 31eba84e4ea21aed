"""Continuous-search engine: segments -> windows -> scores -> triggers
(counterpart of ``gwkit/search/engine.py``, single host).

Per segment the strain is whitened on the task's device, windows are
gathered there in batches, and ``score_fn`` (the task's Q-adapter ->
encoder -> head forward, USR logits) scores each batch. Scores stay on the
device until the segment is done, so batches queue back to back; windows
above the threshold become (time, score) triggers.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from gwkit_torch.device import DeviceLike, resolve_device
from gwkit_torch.search.cluster import get_clusters
from gwkit_torch.search.slicer import (DeviceSlicer, Segment, SlicerConfig, read_segments,
                                       stream_segments)


@dataclasses.dataclass
class SearchResult:
    triggers: Dict[str, List[List[float]]]
    all_vals: np.ndarray
    n_windows: int
    strain_seconds: float
    wall_seconds: float

    @property
    def throughput_x_realtime(self) -> float:
        return self.strain_seconds / max(self.wall_seconds, 1e-9)


def score_segments(
    score_fn: Callable[[torch.Tensor], torch.Tensor],
    segments: Iterable[Segment],
    slicer_cfg: SlicerConfig = SlicerConfig(),
    trigger_threshold: float = -0.5,
    white: bool = False,
    whitened_out: Optional[str] = None,
    detectors: Optional[List[str]] = None,
    verbose: bool = False,
    device: DeviceLike = None,
) -> SearchResult:
    """Run ``score_fn(windows (B, D, L)) -> scores (B,)`` over every segment.

    Returns per-segment trigger lists ([time, score] with score above the
    threshold) and the concatenated raw score stream (``all_vals``). The
    wall time ends after the last scores reached the host. ``device`` is
    where windows are whitened and gathered, the device ``score_fn`` runs
    on; ``None`` is the CUDA card (raises without one)."""
    device = resolve_device(device)
    triggers: Dict[str, List[List[float]]] = {}
    all_vals: List[np.ndarray] = []
    n_windows = 0
    strain_seconds = 0.0
    t0 = time.time()
    for seg in segments:
        slicer = DeviceSlicer(seg, slicer_cfg, white=white, device=device)
        if whitened_out is not None:
            _write_whitened(whitened_out, seg, slicer, detectors)
        pending = [(score_fn(windows), times, valid) for windows, times, valid in slicer.batches()]
        seg_triggers: List[List[float]] = []
        for dev_scores, times, valid in pending:
            scores = dev_scores.float().cpu().numpy().reshape(-1)[: len(valid)]
            all_vals.append(scores[valid].astype(np.float32))
            keep = (scores > trigger_threshold) & valid
            seg_triggers.extend([float(ts), float(sc)] for ts, sc in zip(times[keep], scores[keep]))
        triggers[slicer.key] = seg_triggers
        n_windows += len(slicer)
        strain_seconds += seg.strain.shape[1] * seg.delta_t
        if verbose:
            logging.info("segment %s: %d windows, %d triggers", seg.key, len(slicer), len(seg_triggers))
    return SearchResult(
        triggers=dict(sorted(triggers.items())),
        all_vals=np.concatenate(all_vals) if all_vals else np.zeros(0, np.float32),
        n_windows=n_windows,
        strain_seconds=strain_seconds,
        wall_seconds=time.time() - t0,
    )


def _write_whitened(path: str, seg: Segment, slicer: DeviceSlicer, detectors) -> None:
    if slicer.dss is None:  # the blocked path whitens block by block
        logging.warning("segment %s exceeds the whitening block size; skipping "
                        "--debug-whitened-file output for it", seg.key)
        return
    import h5py

    with h5py.File(path, "a") as wf:
        dets = detectors or [f"det{i}" for i in range(seg.strain.shape[0])]
        for i, det in enumerate(dets):
            wf.require_group(det).create_dataset(seg.key, data=slicer.dss[i].cpu().numpy())


def get_triggers(
    task,
    inputfile: str,
    step_size: float = 0.1,
    trigger_threshold: float = -0.5,
    white: bool = False,
    whitened_file: Optional[str] = None,
    low_frequency_cutoff: float = 20.0,
    batch_size: int = 128,
    verbose: bool = False,
    stream: bool = False,
) -> Tuple[Dict[str, List[List[float]]], np.ndarray, SearchResult]:
    """The reference get_triggers flow on a search task (usually mlgwsc,
    USR): read the file's segments (all up front, or with ``stream`` one
    ahead on a reader thread), score them on ``task.device``."""
    segments = stream_segments(inputfile) if stream else read_segments(inputfile)
    cfg = SlicerConfig(step_size=step_size, low_frequency_cutoff=low_frequency_cutoff,
                       batch_size=batch_size)
    result = score_segments(task.score, segments, cfg, trigger_threshold=trigger_threshold,
                            white=white, whitened_out=whitened_file, verbose=verbose,
                            device=task.device)
    return result.triggers, result.all_vals, result


def write_search_output(path: str, triggers: Dict[str, List[List[float]]], all_vals: np.ndarray,
                        cluster_threshold: float = 0.35,
                        raw_triggers_path: Optional[str] = None) -> None:
    """Cluster and write the reference HDF5 output (time/stat/var/all_vals)."""
    import h5py

    if raw_triggers_path is not None:
        with h5py.File(raw_triggers_path, "w") as dbg:
            for key, trig_list in triggers.items():
                dbg.create_dataset(key, data=np.asarray(trig_list, dtype=np.float32))
    times, stats, tvars = get_clusters(triggers, cluster_threshold)
    with h5py.File(path, "w") as out:
        out.create_dataset("time", data=times)
        out.create_dataset("stat", data=stats)
        out.create_dataset("var", data=tvars)
        out.create_dataset("all_vals", data=np.asarray(all_vals, np.float32))
