"""Stream evaluation: per-file score series -> events -> FAR and sensitivity
sweep (a copy of ``gwkit/evaluation/stream.py``, which is numpy on the host).

The network's per-window scores are assembled into one continuous ranking
series (softmax probability or USR logit difference); triggers, clusters
and events are extracted, true and false positives split against the
injection table, and ranking thresholds swept into FAR (per month) against
sensitive-volume curves. ``h5py`` is imported only where score files are read.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np

from gwkit_torch.evaluation.mlgwsc import mchirp
from gwkit_torch.evaluation.sensitivity import volume_montecarlo
from gwkit_torch.search.cluster import (
    SECONDS_PER_MONTH,
    events_above_threshold,
    get_cluster_boundaries,
    get_event_list_from_triggers,
    get_triggers_from_series,
    split_true_and_false_positives,
)


@dataclasses.dataclass
class StreamEvalResult:
    ranking_thresholds: np.ndarray
    far_per_month: np.ndarray
    sensitive_fraction: np.ndarray
    sensitive_volume: np.ndarray
    sensitive_distance: np.ndarray
    events: list


def evaluate_score_stream(
    values: np.ndarray,
    sample_times: np.ndarray,
    injections: Dict[str, np.ndarray],
    trigger_thresh: float = 0.2,
    ranking_thresholds: Optional[Sequence[float]] = None,
    cluster_tolerance: float = 1.0,
    event_tolerance: float = 3.0,
) -> StreamEvalResult:
    """Sweep ranking thresholds over one score stream.

    ``injections``: dict with 'tc' (+ optional 'mass1','mass2','distance'
    for sensitive-volume estimation).
    """
    triggers = get_triggers_from_series(values, sample_times, trigger_thresh)
    clusters = get_cluster_boundaries(triggers, cluster_tolerance)
    events = get_event_list_from_triggers(triggers, clusters)
    injtimes = np.sort(np.asarray(injections["tc"]))
    duration = sample_times[-1] - sample_times[0] if len(sample_times) > 1 else 1.0

    if ranking_thresholds is None:
        stats = np.asarray([ev[1] for ev in events])
        ranking_thresholds = (
            np.quantile(stats, np.linspace(0, 1, 50)) if len(stats) else np.linspace(0, 1, 10)
        )
    ranking_thresholds = np.asarray(ranking_thresholds)

    has_params = all(k in injections for k in ("mass1", "mass2", "distance"))
    fars, fracs, vols, dists = [], [], [], []
    for thresh in ranking_thresholds:
        sig = events_above_threshold(events, float(thresh))
        tp, fp = split_true_and_false_positives(sig, injtimes, event_tolerance, assume_sorted=True)
        fars.append(len(fp) / duration * SECONDS_PER_MONTH)
        # which injections were found
        if len(tp):
            tp_times = np.asarray([ev[0] for ev in tp])
            idx = np.clip(np.searchsorted(injtimes, tp_times), 0, len(injtimes) - 1)
            left = np.clip(idx - 1, 0, len(injtimes) - 1)
            pick = np.where(
                np.abs(injtimes[left] - tp_times) <= np.abs(injtimes[idx] - tp_times), left, idx
            )
            found = np.unique(pick)
        else:
            found = np.asarray([], int)
        fracs.append(len(found) / max(len(injtimes), 1))
        if has_params:
            missed = np.setdiff1d(np.arange(len(injtimes)), found)
            order = np.argsort(np.asarray(injections["tc"]))
            m1 = np.asarray(injections["mass1"])[order]
            m2 = np.asarray(injections["mass2"])[order]
            dist = np.asarray(injections["distance"])[order]
            f_d = dist[found] if len(found) else np.array([0.0])
            f_mc = mchirp(m1[found], m2[found]) if len(found) else np.array([1.0])
            m_d = dist[missed] if len(missed) else np.array([1.0])
            m_mc = mchirp(m1[missed], m2[missed]) if len(missed) else np.array([np.inf])
            vol, _ = volume_montecarlo(f_d, m_d, f_mc, m_mc, "distance", "volume", "distance")
            vols.append(vol)
            dists.append((3.0 * vol / (4.0 * np.pi)) ** (1.0 / 3.0))
        else:
            vols.append(np.nan)
            dists.append(np.nan)
    return StreamEvalResult(
        ranking_thresholds=ranking_thresholds,
        far_per_month=np.asarray(fars),
        sensitive_fraction=np.asarray(fracs),
        sensitive_volume=np.asarray(vols),
        sensitive_distance=np.asarray(dists),
        events=events,
    )


def scores_to_series(
    window_scores: np.ndarray,
    window_times: np.ndarray,
    mode: str = "usr",
) -> tuple[np.ndarray, np.ndarray]:
    """Window scores -> ranking series. mode 'softmax': scores are p(signal);
    'usr': raw logits (logit-difference ranking when given (N,2) outputs —
    evaluate_test_data.py's subtraction-layer swap)."""
    scores = np.asarray(window_scores)
    if scores.ndim == 2 and scores.shape[1] == 2:
        scores = scores[:, 0] - scores[:, 1] if mode == "usr" else scores[:, 0]
    return scores.reshape(-1), np.asarray(window_times).reshape(-1)


def start_time_from_filename(fn: str) -> float:
    """Reference filename convention: the GPS start rides in the second
    '-'-separated token, with files after the first shifted by one stride
    (evaluate_test_data.py:20-25 ``get_start_time``)."""
    start = int(fn.split("-")[1])
    return float(start) if start == 0 else start + 0.1


def convert_activation(data: np.ndarray, data_activation: str = "linear",
                       ranking: str = "softmax") -> np.ndarray:
    """(N, 2) network outputs -> 1D ranking series, with the reference's
    activation matrix (evaluate_test_data.py:341-364): linear outputs rank
    either by logit difference ('linear' ranking) or by softmax probability;
    softmax outputs can only rank by their own p(signal) column."""
    data = np.asarray(data)
    if data_activation == "linear":
        if ranking == "linear":
            return data.T[0] - data.T[1]
        if ranking == "softmax":
            e0 = np.exp(data.T[0])
            e1 = np.exp(data.T[1])
            return e0 / (e0 + e1)
        raise ValueError(f"unrecognized ranking {ranking!r}")
    if data_activation == "softmax":
        if ranking == "softmax":
            return np.asarray(data.T[0])
        raise ValueError(
            "cannot use a linear ranking statistic on softmax-activated data")
    raise ValueError(f"unrecognized data_activation {data_activation!r}")


def load_score_files(
    data_dir: str,
    epoch_offset: float = 0.0,
    delta_t: float = 0.1,
    data_activation: str = "linear",
    ranking: str = "softmax",
) -> list:
    """Read every per-file score HDF5 in ``data_dir`` ('data' dataset of
    shape (N, 2); GPS start encoded in the filename) into
    (values, start_time) pairs sorted by start time — the reference's
    ``load_data`` (evaluate_test_data.py:323-372) without the pycbc
    TimeSeries dependency. Unreadable files are skipped, like the
    reference's bare ``except``."""
    import h5py

    if not os.path.isdir(data_dir):
        raise ValueError(f"path {data_dir} for loading data not found")
    out = []
    for fn in sorted(os.listdir(data_dir)):
        path = os.path.join(data_dir, fn)
        if not os.path.isfile(path):
            continue
        try:
            with h5py.File(path, "r") as f:
                data = f["data"][()]
            epoch = start_time_from_filename(fn) + epoch_offset
        except Exception:
            logging.debug("skipping unreadable score file %s", path)
            continue
        out.append((convert_activation(data, data_activation, ranking), epoch))
    return sorted(out, key=lambda pair: pair[1])


def assemble_score_series(
    series_list: list, delta_t: float = 0.1
) -> tuple[np.ndarray, np.ndarray]:
    """Stitch per-file (values, start_time) pairs into ONE contiguous score
    series + sample-time axis (evaluate_test_data.py:374-387
    ``assemble_time_series``): gaps are zero-filled, later files overwrite
    overlaps."""
    if not series_list:
        raise ValueError("no score files to assemble")
    start = min(t for _, t in series_list)
    end = max(t + len(v) * delta_t for v, t in series_list)
    n = int(round((end - start) / delta_t)) + 1
    values = np.zeros(n, dtype=np.float64)
    for v, t in series_list:
        i0 = int(round((t - start) / delta_t))
        values[i0 : i0 + len(v)] = v
    times = start + delta_t * np.arange(n)
    return values, times
