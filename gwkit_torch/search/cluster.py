"""Trigger extraction and time clustering, the host epilogue (a copy of
``gwkit/search/cluster.py``).

Two families, as in gwkit:

* MLGWSC-1 style (``get_clusters``): greedy clustering of per-segment
  trigger lists; a gap above ``cluster_threshold`` starts a new cluster and
  the max-stat member represents it, with a fixed timing variance of 0.2 s.
* bnslib style: threshold a score time series, expand cluster boundaries
  while triggers are closer than ``boundary_time`` (note ``>=`` there
  against ``get_clusters``' ``>``), take the max within each cluster as the
  event; then the true/false positive split, the false-alarm rate and the
  sensitive fraction.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from gwkit_torch.utils.tracing import annotate

SECONDS_PER_MONTH = 30 * 24 * 60 * 60


def get_clusters(
    triggers: Dict[str, Sequence[Sequence[float]]], cluster_threshold: float = 0.35
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cluster per-segment trigger lists; returns (times, stats, vars).

    Parity with MLGWSC-1/inference.py:140-166: clusters never span segment
    keys; a time gap above ``cluster_threshold`` starts a new cluster; each
    cluster is represented by its maximum-statistic trigger with a fixed
    timing variance of 0.2 s."""
    times, vals, tvars = [], [], []
    with annotate("gw.cluster"):
        for trig_list in triggers.values():
            if len(trig_list) == 0:
                continue
            arr = np.asarray(trig_list, dtype=np.float64)
            gaps = np.diff(arr[:, 0])
            starts = np.r_[0, np.where(gaps > cluster_threshold)[0] + 1]
            ends = np.r_[starts[1:], len(arr)]
            for s, e in zip(starts, ends):
                k = s + int(np.argmax(arr[s:e, 1]))
                times.append(arr[k, 0])
                vals.append(arr[k, 1])
                tvars.append(0.2)
        return np.asarray(times), np.asarray(vals), np.asarray(tvars)


# ----------------------------------------------------------------------------
# bnslib-style series clustering (Efficiency_test stream evaluation)
# ----------------------------------------------------------------------------

def get_triggers_from_series(
    values: np.ndarray, sample_times: np.ndarray, thresh: float
) -> np.ndarray:
    """Threshold a score series -> 2 x K array of (times, values)
    (bnslib.py:216-240)."""
    idxs = np.where(values > thresh)[0]
    if len(idxs) == 0:
        return np.zeros((2, 0))
    return np.stack([sample_times[idxs], values[idxs]])


def get_cluster_boundaries(triggers, boundary_time: float = 1.0) -> List[List[float]]:
    """Expand cluster [start, end] boundaries while successive trigger times
    are within boundary_time (bnslib.py:242-300)."""
    trigger_times = np.asarray(triggers[0] if np.ndim(triggers) == 2 else triggers)
    if len(trigger_times) == 0:
        return []
    gaps = np.diff(trigger_times)
    starts = np.r_[0, np.where(gaps >= boundary_time)[0] + 1]
    ends = np.r_[starts[1:] - 1, len(trigger_times) - 1]
    return [[float(trigger_times[s]), float(trigger_times[e])] for s, e in zip(starts, ends)]


def get_event_list_from_triggers(triggers, cluster_boundaries) -> List[Tuple[float, float]]:
    """Max-value trigger inside each cluster boundary -> event list
    (bnslib.py:322-346)."""
    events = []
    t = np.asarray(triggers[0])
    v = np.asarray(triggers[1])
    order = np.argsort(t)
    t, v = t[order], v[order]
    for cstart, cend in cluster_boundaries:
        s = np.searchsorted(t, cstart, side="left")
        e = np.searchsorted(t, cend, side="right")
        if s == e:
            continue
        k = s + int(np.argmax(v[s:e]))
        events.append((float(t[k]), float(v[k])))
    return events


def get_event_list(values: np.ndarray, sample_times: np.ndarray, cluster_boundaries) -> List[Tuple[float, float]]:
    """Max of the score *series* within each cluster boundary -> events
    (bnslib.py:302-320 — the series-based sibling of
    get_event_list_from_triggers)."""
    events = []
    for cstart, cend in cluster_boundaries:
        s = np.searchsorted(sample_times, cstart, side="left")
        e = np.searchsorted(sample_times, cend, side="right")
        if s >= e:
            continue
        k = s + int(np.argmax(values[s:e]))
        events.append((float(sample_times[k]), float(values[k])))
    return events


def get_closest_injection_times(
    injection_times: np.ndarray, times, return_indices: bool = False, assume_sorted: bool = False
):
    """Closest injection time for each event time (bnslib.py:517-630 surface)."""
    injtimes = injection_times if assume_sorted else np.sort(injection_times)
    times = np.asarray(times)
    idx = np.searchsorted(injtimes, times, side="right")
    left = np.clip(idx - 1, 0, len(injtimes) - 1)
    right = np.clip(idx, 0, len(injtimes) - 1)
    pick = np.where(np.abs(injtimes[left] - times) <= np.abs(injtimes[right] - times), left, right)
    if return_indices:
        return injtimes[pick], pick
    return injtimes[pick]


def events_above_threshold(event_list, thresh: float):
    return [ev for ev in event_list if ev[1] > thresh]


def split_true_and_false_positives(
    event_list, injection_times: np.ndarray, tolerance: float = 3.0, assume_sorted: bool = False
):
    """Events within `tolerance` of an injection are true positives
    (bnslib.py:419-515; vectorized, no worker pool needed)."""
    injtimes = injection_times if assume_sorted else np.sort(injection_times)
    if len(event_list) == 0:
        return [], []
    times = np.asarray([ev[0] for ev in event_list])
    idx = np.searchsorted(injtimes, times, side="right")
    left = np.abs(times - injtimes[np.clip(idx - 1, 0, len(injtimes) - 1)])
    right = np.abs(times - injtimes[np.clip(idx, 0, len(injtimes) - 1)])
    diff = np.minimum(left, right)
    tp = [ev for ev, d in zip(event_list, diff) if d <= tolerance]
    fp = [ev for ev, d in zip(event_list, diff) if d > tolerance]
    return tp, fp


def false_alarm_rate(
    values, sample_times, injection_times, trigger_thresh=0.2, ranking_thresh=0.5,
    cluster_tolerance=1.0, event_tolerance=3.0,
) -> float:
    """False alarms per month at the given thresholds (bnslib.py:632-681)."""
    triggers = get_triggers_from_series(values, sample_times, trigger_thresh)
    clusters = get_cluster_boundaries(triggers, cluster_tolerance)
    events = events_above_threshold(get_event_list_from_triggers(triggers, clusters), ranking_thresh)
    _, fp = split_true_and_false_positives(events, injection_times, event_tolerance)
    duration = sample_times[-1] - sample_times[0] if len(sample_times) else 1.0
    return len(fp) / duration * SECONDS_PER_MONTH


def sensitive_fraction(
    values, sample_times, injection_times, trigger_thresh=0.2, ranking_thresh=0.5,
    cluster_tolerance=1.0, event_tolerance=3.0,
) -> float:
    """Detected fraction of injections (bnslib.py:683-725)."""
    triggers = get_triggers_from_series(values, sample_times, trigger_thresh)
    clusters = get_cluster_boundaries(triggers, cluster_tolerance)
    events = events_above_threshold(get_event_list_from_triggers(triggers, clusters), ranking_thresh)
    tp, _ = split_true_and_false_positives(events, injection_times, event_tolerance)
    return float(len(tp)) / max(len(injection_times), 1)
