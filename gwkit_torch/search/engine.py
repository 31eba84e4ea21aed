"""Continuous-search engine: segments -> windows -> scores -> triggers
(counterpart of ``gwkit/search/engine.py``).

Per segment the strain is whitened on the task's device, windows are
gathered there in batches, and ``score_fn`` (the task's Q-adapter ->
encoder -> head forward, USR logits) scores each batch. Scores stay on the
device until the segment is done, so batches queue back to back; windows
above the threshold become (time, score) triggers.

Several processes (``gwkit_torch.parallel``): a search over a file shards
its segments across processes at the key level and merges the trigger
lists through a shared directory (:func:`get_triggers`); with a mesh,
:func:`score_segments` splits each batch's windows over the "data" ranks
and gathers the scores back into batch order.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from gwkit_torch.device import DeviceLike, resolve_device
from gwkit_torch.parallel.distributed import gather_trigger_lists, host_key_filter, process_count, process_index
from gwkit_torch.parallel.mesh import Mesh, gather_rows, local_rows
from gwkit_torch.search.cluster import get_clusters
from gwkit_torch.search.slicer import (DeviceSlicer, Segment, SlicerConfig, native_streamable,
                                       read_segments, stream_segments)


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
    mesh: Optional[Mesh] = None,
    stream_score_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    stream_plan_args: Optional[tuple] = None,
    stream_norm: str = "median",
    stream_median_stride: int = 1,
) -> SearchResult:
    """Run ``score_fn(windows (B, D, L)) -> scores (B,)`` over every segment.

    Returns per-segment trigger lists ([time, score] with score above the
    threshold) and the concatenated raw score stream (``all_vals``). The
    wall time ends after the last scores reached the host. ``device`` is
    where windows are whitened and gathered, the device ``score_fn`` runs
    on; ``None`` is the CUDA card (raises without one).

    ``stream_score_fn`` ((B, D, F, T) Q spectrograms -> (B,)) with
    ``stream_plan_args`` selects the streaming Q-scan for blocked (long)
    segments (``DeviceSlicer.fused_scores_stream``); short segments keep
    the per-window path, as in gwkit. The two differ near window edges by
    design.

    ``mesh``: each rank of the "data" axis scores its rows of every batch
    (the batch size must divide by the data size) and the scores are
    all-gathered back into batch order, so every rank holds the whole score
    stream, as gwkit's global array. As in gwkit, the streaming Q-scan is
    not combined with a mesh."""
    device = resolve_device(device)
    if mesh is not None:
        score_fn, stream_score_fn = _data_sharded(score_fn, mesh, slicer_cfg.batch_size), None
    triggers: Dict[str, List[List[float]]] = {}
    all_vals: List[np.ndarray] = []
    n_windows = 0
    strain_seconds = 0.0
    t0 = time.time()
    for seg in segments:
        slicer = DeviceSlicer(seg, slicer_cfg, white=white, device=device)
        if whitened_out is not None:
            _write_whitened(whitened_out, seg, slicer, detectors)
        if stream_score_fn is not None and slicer._blocked:
            pending = list(slicer.fused_scores_stream(stream_score_fn, stream_plan_args, norm=stream_norm,
                                                      median_stride=stream_median_stride))
        else:
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


def _data_sharded(score_fn, mesh: Mesh, batch_size: int):
    """``score_fn`` on this data rank's rows of each batch, the scores
    gathered back over "data" into batch order."""
    rows = local_rows(mesh, batch_size)

    def score(windows: torch.Tensor) -> torch.Tensor:
        return gather_rows(score_fn(windows[rows]).contiguous(), mesh)

    return score


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


def stream_search_kwargs(task) -> dict:
    """:func:`score_segments`' streaming arguments from a task's Q-adapter
    geometry (scores from ``task.score_spec``)."""
    qcfg = getattr(task, "qcfg", None)
    if getattr(task, "score_spec", None) is None or qcfg is None:
        raise ValueError("qscan_stream requires a task with a Q-scan front end (score_spec + qcfg)")
    return dict(stream_score_fn=task.score_spec,
                stream_plan_args=(qcfg.kernel_length, float(qcfg.sample_rate), qcfg.q_range,
                                  qcfg.spectrogram_shape, 0.2),
                stream_norm=qcfg.qscan_norm, stream_median_stride=qcfg.median_stride)


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
    stream: Optional[bool] = None,
    shard_dir: Optional[str] = None,
    qscan_stream: bool = False,
) -> Tuple[Dict[str, List[List[float]]], np.ndarray, SearchResult]:
    """The reference get_triggers flow on a search task (usually mlgwsc,
    USR), scored on ``task.device``.

    ``stream``: None (the default) chooses by :func:`native_streamable`:
    when every dataset is contiguous uncompressed f64/f32 and the host-IO
    library builds, segments stream with the C++ whole-array prefetcher
    (segment i+1 read by a C++ thread while segment i is scored), else all
    are read up front. ``True`` forces streaming (a Python reader thread for
    other files), ``False`` eager reads. Outputs are the same in every mode.

    Several processes (``process_count() > 1``): each scores a round-robin
    share of the segments, chosen before any dataset is opened, and the
    per-segment trigger lists are merged through ``shard_dir`` (a shared
    filesystem path); ``all_vals`` stays this process's.
    ``qscan_stream`` takes the streaming Q-scan for long segments, from
    the task's Q-adapter geometry."""
    stream_kwargs = stream_search_kwargs(task) if qscan_stream else {}
    device = resolve_device(task.device)
    if stream is None:
        stream = native_streamable(inputfile)
    n_proc = process_count()
    key_filter = host_key_filter(process_index(), n_proc) if n_proc > 1 else None
    segments = (stream_segments(inputfile, key_filter=key_filter) if stream
                else read_segments(inputfile, key_filter=key_filter))
    cfg = SlicerConfig(step_size=step_size, low_frequency_cutoff=low_frequency_cutoff,
                       batch_size=batch_size)
    result = score_segments(task.score, segments, cfg, trigger_threshold=trigger_threshold,
                            white=white, whitened_out=whitened_file, verbose=verbose,
                            device=device, **stream_kwargs)
    if n_proc > 1:
        result = dataclasses.replace(result, triggers=gather_trigger_lists(result.triggers, shard_dir))
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
