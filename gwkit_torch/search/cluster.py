"""Trigger clustering (copy of ``gwkit/search/cluster.py::get_clusters``,
the MLGWSC-1 host epilogue)."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def get_clusters(
    triggers: Dict[str, Sequence[Sequence[float]]], cluster_threshold: float = 0.35
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cluster per-segment trigger lists; returns (times, stats, vars).

    Parity with MLGWSC-1/inference.py:140-166: clusters never span segment
    keys; a time gap above ``cluster_threshold`` starts a new cluster; each
    cluster is represented by its maximum-statistic trigger with a fixed
    timing variance of 0.2 s."""
    times, vals, tvars = [], [], []
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
