"""The traffic generator: every mix under ``traffic/`` is a file of
parameters that one of the two kinds here reads. Inputs come from the run's
seed alone, through numpy's PCG64 (``np.random.default_rng(seed)``), so the
same seed gives the same inputs and every seed the same sizes.

  segments  a stream of ``distinct`` two-detector strain segments of
            ``segment_seconds`` at ``sample_rate``, N(0, 1) * ``amplitude``
            (gwkit's bench method), cycled by the driver
  windows   a pool of ``pool_batches`` batches of ``batch`` one-detector-pair
            windows of N(0, 1) noise, ``signal_fraction`` of each batch with a
            chirp at SNR U(``snr``) (each detector scaled to unit norm, then
            by the SNR), cycled by the driver
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def segments(mix: dict, seed: int) -> List[np.ndarray]:
    """``distinct`` arrays (detectors, segment_seconds * sample_rate), float32."""
    if mix["kind"] != "segments":
        raise ValueError(f"not a segment stream: {mix['kind']}")
    rng = np.random.default_rng(seed)
    n = int(round(mix["segment_seconds"] * mix["sample_rate"]))
    amp = np.float32(mix["amplitude"])
    return [rng.standard_normal((mix["detectors"], n), dtype=np.float32) * amp for _ in range(mix["distinct"])]


def chirps(n: int, rng: np.random.Generator, mix: dict) -> np.ndarray:
    """(n, detectors, samples) chirp-like waveforms, each detector row of unit
    norm: a linear chirp from f0 to f1 over tc with a Gaussian envelope at tc
    and an independent phase per detector."""
    c = mix["chirp"]
    fs, dets = mix["sample_rate"], mix["detectors"]
    t = np.arange(int(round(mix["window_seconds"] * fs))) / fs
    f0 = rng.uniform(*c["f0"], size=(n, 1, 1))
    f1 = rng.uniform(*c["f1"], size=(n, 1, 1))
    tc = rng.uniform(*c["tc"], size=(n, 1, 1))
    phi = rng.uniform(0.0, 2.0 * np.pi, size=(n, dets, 1))
    phase = 2.0 * np.pi * (f0 * t + 0.5 * (f1 - f0) * t ** 2 / tc) + phi
    h = np.sin(phase) * np.exp(-((t - tc) / c["width"]) ** 2)
    return h / np.linalg.norm(h, axis=-1, keepdims=True)


def windows(mix: dict, seed: int) -> Dict[str, np.ndarray]:
    """{"strain": (pool_batches, batch, detectors, samples) float32,
    "signal": (pool_batches, batch) bool, "snr": (pool_batches, batch)}."""
    if mix["kind"] != "windows":
        raise ValueError(f"not a window pool: {mix['kind']}")
    rng = np.random.default_rng(seed)
    P, B, D = mix["pool_batches"], mix["batch"], mix["detectors"]
    N = int(round(mix["window_seconds"] * mix["sample_rate"]))
    strain = rng.standard_normal((P, B, D, N), dtype=np.float32)
    n_sig = int(round(B * mix["signal_fraction"]))
    signal = np.zeros((P, B), bool)
    for p in range(P):  # the same number of chirps in every batch, at seeded positions
        signal[p, rng.permutation(B)[:n_sig]] = True
    snr = np.where(signal, rng.uniform(*mix["snr"], size=(P, B)), 0.0)
    h = chirps(int(signal.sum()), rng, mix)
    strain[signal] += (h * snr[signal][:, None, None]).astype(np.float32)
    return {"strain": strain, "signal": signal, "snr": snr}
