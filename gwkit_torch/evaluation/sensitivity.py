"""Monte-Carlo sensitive volume/distance (a copy of
``gwkit/evaluation/sensitivity.py``).

Implements the standard importance-weighted MC estimator used by
pycbc.sensitivity.volume_montecarlo, which bnslib's ``sensitive_distance``
calls with (distribution_param='distance', distribution='volume',
limits_param='distance') (bnslib.py:795-890): found/missed injections at
distances d_i drawn from a known distribution are reweighted to uniform-in-
volume; V = V_tot * sum(w_found) / sum(w_all) with a binomial-style error.

Distance-power table (weights w ∝ d^p * mchirp^q):
  distribution   p     q (chirp-mass weighting)
  'log'          3     0
  'uniform'      2     5/6
  'distancesquared' 1  5/3
  'volume'       0     5/2
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from gwkit_torch.evaluation.mlgwsc import mchirp
from gwkit_torch.search.cluster import (events_above_threshold, get_cluster_boundaries,
                                        get_event_list_from_triggers, get_triggers_from_series,
                                        split_true_and_false_positives)

_D_POWER = {"log": 3.0, "uniform": 2.0, "distancesquared": 1.0, "volume": 0.0}
_MCHIRP_POWER = {"log": 0.0, "uniform": 5.0 / 6.0, "distancesquared": 5.0 / 3.0, "volume": 5.0 / 2.0}


def volume_montecarlo(
    found_d: np.ndarray,
    missed_d: np.ndarray,
    found_mchirp: np.ndarray,
    missed_mchirp: np.ndarray,
    distribution_param: str = "distance",
    distribution: str = "volume",
    limits_param: str = "distance",
) -> Tuple[float, float]:
    """Returns (sensitive volume, standard error)."""
    if distribution_param not in ("distance", "chirp_distance") or limits_param != "distance":
        raise NotImplementedError("only (chirp-)distance-parameterized injections supported")
    d_power = _D_POWER[distribution]
    # pycbc applies the chirp-mass weighting ONLY for chirp-distance-
    # parameterized injection distributions
    mc_power = _MCHIRP_POWER[distribution] if distribution_param == "chirp_distance" else 0.0

    found_d = np.asarray(found_d, float)
    missed_d = np.asarray(missed_d, float)
    all_d = np.concatenate([found_d, missed_d])
    max_distance = all_d.max() if len(all_d) else 0.0
    vtot = (4.0 / 3.0) * np.pi * max_distance ** 3

    if mc_power:
        mchirp_norm = np.concatenate([found_mchirp, missed_mchirp]).max()
        found_w = found_d ** d_power * (np.asarray(found_mchirp) / mchirp_norm) ** mc_power
        missed_w = missed_d ** d_power * (np.asarray(missed_mchirp) / mchirp_norm) ** mc_power
    else:
        found_w = found_d ** d_power
        missed_w = missed_d ** d_power
    all_w = np.concatenate([found_w, missed_w])
    norm = all_w.sum()
    if norm == 0:
        return 0.0, 0.0
    mc_sum = found_w.sum()
    vol = vtot * mc_sum / norm
    # MC sample variance of the {w_found, 0} samples
    n = len(all_w)
    mean_w = mc_sum / n
    mean_w_sq = (found_w ** 2).sum() / n
    var = (mean_w_sq - mean_w ** 2) / n
    vol_err = vtot * n * np.sqrt(var) / norm
    return float(vol), float(vol_err)


def sensitive_distance(
    values: np.ndarray,
    sample_times: np.ndarray,
    injection_times: np.ndarray,
    injection_m1: np.ndarray,
    injection_m2: np.ndarray,
    injection_dist: np.ndarray,
    trigger_thresh: float = 0.2,
    ranking_thresh: float = 0.5,
    cluster_tolerance: float = 1.0,
    event_tolerance: float = 3.0,
) -> float:
    """bnslib.py:795-890: distance to which the search detects sources, from
    a score time series + injection table."""
    triggers = get_triggers_from_series(values, sample_times, trigger_thresh)
    clusters = get_cluster_boundaries(triggers, cluster_tolerance)
    events = events_above_threshold(get_event_list_from_triggers(triggers, clusters), ranking_thresh)
    tp, _ = split_true_and_false_positives(events, injection_times, event_tolerance)

    injection_times = np.asarray(injection_times)
    if len(tp):
        tp_times = np.asarray([ev[0] for ev in tp])
        sorted_idx = np.argsort(injection_times)
        pos = np.searchsorted(injection_times[sorted_idx], tp_times)
        pos = np.clip(pos, 0, len(injection_times) - 1)
        left = np.clip(pos - 1, 0, len(injection_times) - 1)
        choose_left = np.abs(injection_times[sorted_idx][left] - tp_times) <= np.abs(
            injection_times[sorted_idx][pos] - tp_times
        )
        found_idxs = np.unique(sorted_idx[np.where(choose_left, left, pos)])
    else:
        found_idxs = np.asarray([], int)
    missed_idxs = np.setdiff1d(np.arange(len(injection_times)), found_idxs)

    if len(found_idxs):
        found_dist = injection_dist[found_idxs]
        found_mchirp = mchirp(injection_m1[found_idxs], injection_m2[found_idxs])
    else:
        found_dist, found_mchirp = np.array([0.0]), np.array([1.0])
    if len(missed_idxs):
        missed_dist = injection_dist[missed_idxs]
        missed_mchirp = mchirp(injection_m1[missed_idxs], injection_m2[missed_idxs])
    else:
        missed_dist, missed_mchirp = np.array([1.0]), np.array([np.inf])

    vol, _ = volume_montecarlo(found_dist, missed_dist, found_mchirp, missed_mchirp,
                               "distance", "volume", "distance")
    return float((3.0 * vol / (4.0 * np.pi)) ** (1.0 / 3.0))
