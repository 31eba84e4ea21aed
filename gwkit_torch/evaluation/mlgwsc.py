"""MLGWSC-1 challenge evaluation: FAR curve and sensitive distance (a copy
of ``gwkit/evaluation/mlgwsc.py``, with ``h5py`` imported only where a file
is read).

Output-exact port of the challenge protocol (MLGWSC-1/evaluate.py:13-278,
itself from the public gwastro/ml-mock-data-challenge-1): given foreground /
background event lists (time, stat, var) and the injection table, compute
true/false positives, FAR-vs-stat curves, and the Monte-Carlo sensitive
volume/distance sweep (optionally chirp-distance weighted). The inner
"best true positive per injection" loop of the reference is replaced by a
vectorized grouped-max; outputs are identical.
"""
from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np


def find_injection_times(fgfiles: List[str], injfile: str, padding_start=0, padding_end=0):
    """Total foreground duration + boolean mask of injections inside it
    (evaluate.py:13-63)."""
    import h5py

    duration = 0.0
    spans = []
    for fpath in fgfiles:
        with h5py.File(fpath, "r") as fp:
            det = list(fp.keys())[0]
            for key in fp[det].keys():
                ds = fp[f"{det}/{key}"]
                start = ds.attrs["start_time"]
                end = start + len(ds) * ds.attrs["delta_t"]
                duration += end - start
                start += padding_start
                end -= padding_end
                if end > start:
                    spans.append((start, end))
    with h5py.File(injfile, "r") as fp:
        injtimes = fp["tc"][()]
    mask = np.zeros(len(injtimes), bool)
    for start, end in spans:
        mask |= (start <= injtimes) & (injtimes <= end)
    return duration, mask


def find_closest_index(array: np.ndarray, value, assume_sorted: bool = False) -> np.ndarray:
    """Index of the closest element of `array` for each `value`
    (evaluate.py:66-97)."""
    if len(array) == 0:
        raise ValueError("Cannot find closest index for empty input array.")
    if not assume_sorted:
        array = np.sort(array)
    right = np.searchsorted(array, value, side="right")
    left = np.maximum(right - 1, 0)
    right_c = np.minimum(right, len(array) - 1)
    take_left = (right == len(array)) | (np.abs(array[left] - value) < np.abs(array[right_c] - value))
    return np.where(take_left, left, right_c)


def mchirp(mass1, mass2):
    return (mass1 * mass2) ** (3.0 / 5.0) / (mass1 + mass2) ** (1.0 / 5.0)


def get_stats(
    fgevents: np.ndarray,
    bgevents: np.ndarray,
    injparams: Dict[str, np.ndarray],
    duration: float | None = None,
    chirp_distance: bool = False,
) -> Dict[str, np.ndarray]:
    """Challenge statistics (evaluate.py:104-278).

    fgevents/bgevents: arrays of shape (3, K): [times, stats, max-tp-distance].
    injparams: dict with 'tc' and 'distance' (+ 'mass1'/'mass2' when
    chirp_distance). Returns the same keys the reference writes.
    """
    ret: Dict[str, np.ndarray] = {}
    injtimes = injparams["tc"]
    dist = injparams["distance"]
    massc = mchirp(injparams["mass1"], injparams["mass2"]) if chirp_distance else None
    if duration is None:
        duration = injtimes.max() - injtimes.min()

    order = fgevents[0].argsort()
    fgevents = fgevents[:, order]

    idxs = find_closest_index(injtimes, fgevents[0])
    diff = np.abs(injtimes[idxs] - fgevents[0])
    tp_mask = diff <= fgevents[2]
    tpidxs = np.flatnonzero(tp_mask)
    fpidxs = np.flatnonzero(~tp_mask)

    ret["fg-events"] = fgevents
    ret["found-indices"] = idxs
    ret["missed-indices"] = np.setdiff1d(np.arange(len(injtimes)), idxs)
    ret["true-positive-event-indices"] = tpidxs
    ret["false-positive-event-indices"] = fpidxs
    ret["sorting-indices"] = order
    ret["true-positive-diffs"] = diff[tpidxs]
    ret["false-positive-diffs"] = diff[fpidxs]
    ret["true-positives"] = fgevents[:, tpidxs]
    ret["false-positives"] = fgevents[:, fpidxs]

    # FAR curves: false alarms with stat above each sorted stat, per second
    logging.info("Calculating foreground FAR")
    fg_noise_stats = np.sort(fgevents[1, fpidxs])
    ret["fg-far"] = (len(fg_noise_stats) - np.arange(len(fg_noise_stats)) - 1) / duration
    logging.info("Calculating background FAR")
    noise_stats = np.sort(bgevents[1])
    ret["far"] = (len(noise_stats) - np.arange(len(noise_stats)) - 1) / duration

    # Best true-positive statistic per found injection (vectorized grouped max)
    best_stat = np.full(len(injtimes), -np.inf)
    np.maximum.at(best_stat, idxs[tpidxs], fgevents[1, tpidxs])
    found_idx = np.flatnonzero(np.isfinite(best_stat))
    found_injections = np.stack([found_idx.astype(float), best_stat[found_idx]])

    # Sensitive volume / distance sweep over background thresholds
    logging.info("Calculating sensitivity")
    sidxs = found_injections[1].argsort()
    found_injections = found_injections[:, sidxs]
    max_distance = dist.max()
    vtot = (4.0 / 3.0) * np.pi * max_distance ** 3
    Ninj = len(dist)
    if chirp_distance:
        found_mchirp_total = massc[found_injections[0].astype(int)]
        mchirp_max = massc.max()
        mc_norm = mchirp_max ** (5.0 / 2.0) * len(massc)
    else:
        mc_norm = Ninj
    prefactor = vtot / mc_norm

    nfound = len(found_injections[1]) - np.searchsorted(found_injections[1], noise_stats, side="right")
    if chirp_distance:
        fidxs = np.searchsorted(found_injections[1], noise_stats, side="right")
        found_mchirp_total = np.flip(found_mchirp_total)
        cumsum = np.flip(np.cumsum(found_mchirp_total ** (5.0 / 2.0)))
        cumsum = np.concatenate([cumsum, np.zeros(1)])
        mc_sum = cumsum[fidxs]
        Ninj = np.sum((mchirp_max / massc) ** (5.0 / 2.0))
        cumsumsq = np.flip(np.cumsum(found_mchirp_total ** 5))
        cumsumsq = np.concatenate([cumsumsq, np.zeros(1)])
        sample_variance = cumsumsq[fidxs] / Ninj - (mc_sum / Ninj) ** 2
    else:
        mc_sum = nfound
        sample_variance = nfound / Ninj - (nfound / Ninj) ** 2
    vol = prefactor * mc_sum
    vol_err = prefactor * (Ninj * sample_variance) ** 0.5

    ret["sensitive-volume"] = vol
    ret["sensitive-distance"] = (3.0 * vol / (4.0 * np.pi)) ** (1.0 / 3.0)
    ret["sensitive-volume-error"] = vol_err
    ret["sensitive-fraction"] = nfound / Ninj
    return ret


def read_events(paths: List[str]) -> np.ndarray:
    """Stack (time, stat, var) event files (evaluate.py:354-372)."""
    import h5py

    events = []
    for fpath in paths:
        with h5py.File(fpath, "r") as fp:
            events.append(
                np.vstack([fp["time"], fp["stat"], fp["var"][: len(fp["time"])]])
            )
    return np.concatenate(events, axis=-1)
