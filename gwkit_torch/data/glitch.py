"""Gravity Spy glitch data (counterpart of ``gwkit/data/glitch.py``): the
11-class taxonomy, the reference corpus's preprocessing, the synthetic and
realistic corpora, and the labeled strain dataset with its label-preserving
augmentation.

The reference builds its corpus by fetching real O3 strain around Gravity
Spy triggers, whitening it (4 s PSD segments), highpassing it at 30 Hz and
cropping 1 s around the glitch
(Glitch_classification/utils/generate_glitch_dataset.py:19-116).
:func:`preprocess_glitch_strain` is that pipeline, its whitening on the
device and the 8th-order Butterworth ``sosfiltfilt`` on the host with
scipy, as in gwkit; :func:`synthesize_glitch` and
:func:`synthetic_glitch_dataset` are gwkit's numpy morphologies, bit for
bit; :func:`realistic_glitch_dataset` embeds them in PSD-colored noise.

Random draws (the realistic corpus's noise, the epoch order, the
augmentation) come from torch generators: the distributions are gwkit's,
JAX's streams are not.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import scipy.signal
import torch

from gwkit_torch.device import DeviceLike, resolve_device
from gwkit_torch.ops.whiten import whiten_estimate
from gwkit_torch.train.datasets_util import epoch_indices

# the 11-way taxonomy of the reference's shipped model (classification report)
GLITCH_CLASSES = (
    "1080 Lines",
    "Blip",
    "Blip Low Freq",
    "Fast Scattering",
    "GW",
    "Koi Fish",
    "No Glitch",
    "Power Line",
    "Scattered Light",
    "Tomte",
    "Whistle",
)
CLASS_TO_INDEX = {name: i for i, name in enumerate(GLITCH_CLASSES)}


def preprocess_glitch_strain(
    strain,
    sample_rate: float = 2048.0,
    segment_duration: float = 4.0,
    highpass_hz: float = 30.0,
    crop_duration: float = 1.0,
    psd=None,
    device: DeviceLike = None,
) -> np.ndarray:
    """(B, N) raw strain around a trigger -> (B, crop) whitened/highpassed
    windows centered on the trigger (generate_glitch_dataset.py semantics:
    whiten with 4 s PSD segments, 30 Hz highpass, 1 s center crop).
    ``crop_duration=None`` skips the center crop (callers that crop by GPS
    time themselves, e.g. gwkit_torch.data.fetch). ``psd`` whitens with a
    KNOWN one-sided PSD instead of the data-estimated one; with it the
    pipeline is exactly linear in ``strain`` (needed for amplitude
    calibration: data-estimated whitening is scale-invariant, see
    :func:`realistic_glitch_dataset`). A tensor is whitened on its own
    device, a host array on ``device`` (``None``: the card)."""
    if not isinstance(strain, torch.Tensor):
        strain = torch.as_tensor(np.asarray(strain, np.float32), device=resolve_device(device))
    white = whiten_estimate(strain, delta_t=1.0 / sample_rate, segment_duration=segment_duration,
                            max_filter_duration=1.0, psd=psd).cpu().numpy()
    sos = scipy.signal.butter(8, highpass_hz, "highpass", fs=sample_rate, output="sos")
    filtered = scipy.signal.sosfiltfilt(sos, white, axis=-1)
    if crop_duration is None:
        return np.ascontiguousarray(filtered, dtype=np.float32)
    n_crop = int(crop_duration * sample_rate)
    mid = filtered.shape[-1] // 2
    return np.ascontiguousarray(filtered[:, mid - n_crop // 2: mid + n_crop - n_crop // 2], dtype=np.float32)


def _sine_gaussian(t, f0, q, t0, amp, phase=0.0):
    tau = q / (2 * np.pi * f0)
    return amp * np.exp(-(((t - t0) / tau) ** 2)) * np.sin(2 * np.pi * f0 * (t - t0) + phase)


def synthesize_glitch(
    rng: np.random.Generator, class_name: str, duration: float = 1.0, sample_rate: float = 2048.0
) -> np.ndarray:
    """One whitened-domain glitch morphology for the given class."""
    n = int(duration * sample_rate)
    t = np.arange(n) / sample_rate
    t0 = duration / 2 + rng.uniform(-0.05, 0.05)
    a = rng.uniform(3.0, 10.0)
    # Morphology parameters follow the Gravity Spy class descriptions
    # (Zevin et al. 2017): Blips are sub-cycle broadband transients well
    # above 100 Hz, Blip Low Freq the same shape below ~60 Hz, Tomtes are
    # longer rounded-triangle transients near 70 Hz, and Koi Fish are loud
    # blips with a harmonic "body + fins" structure spanning low and high
    # frequency at once.
    if class_name == "Blip":
        return _sine_gaussian(t, rng.uniform(100, 400), rng.uniform(0.8, 2.0), t0, a)
    if class_name == "Blip Low Freq":
        return _sine_gaussian(t, rng.uniform(20, 60), rng.uniform(0.8, 2.0), t0, a)
    if class_name == "Tomte":
        f_mid = rng.uniform(50, 100)
        # gentle downward sweep across the envelope (rounded-triangle look)
        q = rng.uniform(4, 8)
        tau = q / (2 * np.pi * f_mid)
        freq = f_mid * (1.0 - 0.3 * np.clip((t - t0) / (3 * tau), -1, 1))
        phase = 2 * np.pi * np.cumsum(freq) / sample_rate
        return a * np.exp(-(((t - t0) / tau) ** 2)) * np.sin(phase)
    if class_name == "Koi Fish":
        comps = [
            (rng.uniform(25, 45), rng.uniform(1.5, 2.5), 1.0),
            (rng.uniform(70, 140), rng.uniform(2.0, 3.0), 0.9),
            (rng.uniform(200, 450), rng.uniform(2.5, 3.5), 0.7),
            (rng.uniform(600, 900), rng.uniform(3.0, 4.0), 0.6),
        ]
        return sum(_sine_gaussian(t, f, q, t0, 1.3 * a * w) for f, q, w in comps)
    if class_name == "Whistle":
        f_start, f_end = rng.uniform(400, 900), rng.uniform(100, 300)
        width = rng.uniform(0.1, 0.3)
        env = np.exp(-(((t - t0) / width) ** 2))
        freq = f_start + (f_end - f_start) * (t - t0 + width) / (2 * width)
        phase = 2 * np.pi * np.cumsum(freq) / sample_rate
        return a * env * np.sin(phase)
    if class_name == "Power Line":
        f = 60.0 * rng.integers(1, 4)
        env = np.exp(-(((t - t0) / rng.uniform(0.1, 0.3)) ** 2))
        return a * 0.5 * env * np.sin(2 * np.pi * f * t)
    if class_name == "1080 Lines":
        env = np.exp(-(((t - t0) / rng.uniform(0.2, 0.4)) ** 2))
        return a * 0.5 * env * np.sin(2 * np.pi * rng.uniform(1000, 1160) * t)
    if class_name == "Scattered Light":
        f_arch = rng.uniform(20, 60)
        mod = rng.uniform(2, 6)
        phase = 2 * np.pi * (f_arch * t + (f_arch / mod) * np.sin(2 * np.pi * mod * t) / (2 * np.pi))
        env = np.exp(-(((t - t0) / 0.4) ** 2))
        return a * 0.7 * env * np.sin(phase)
    if class_name == "Fast Scattering":
        sig = np.zeros(n)
        for k in range(rng.integers(3, 6)):
            sig += _sine_gaussian(t, rng.uniform(30, 80), rng.uniform(4, 8), rng.uniform(0.2, 0.8), a * 0.6)
        return sig
    if class_name == "GW":
        # inspiral chirp (frequency sweeping up, amplitude rising)
        tc = t0 + 0.1
        tau = np.maximum(tc - t, 1e-3)
        freq = np.clip(35.0 * (tau / 1.0) ** (-3.0 / 8.0), 0, 512)
        phase = -2 * np.pi * np.cumsum(freq) / sample_rate
        env = (tau ** (-0.25)) * (t < tc) * np.exp(-np.maximum(t - tc, 0))
        return a * 0.5 * env / np.max(env + 1e-9) * np.sin(phase)
    # "No Glitch"
    return np.zeros(n)


def synthetic_glitch_dataset(
    n_per_class: int,
    seed: int = 0,
    duration: float = 1.0,
    sample_rate: float = 2048.0,
    noise_sigma: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(strain [N, T], labels [N]) over all 11 classes, whitened-domain
    units; host numpy."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    n = int(duration * sample_rate)
    for ci, cls in enumerate(GLITCH_CLASSES):
        for _ in range(n_per_class):
            sig = synthesize_glitch(rng, cls, duration, sample_rate)
            xs.append(sig + rng.normal(0, noise_sigma, n))
            ys.append(ci)
    xs = np.asarray(xs, np.float32)
    ys = np.asarray(ys, np.int32)
    order = rng.permutation(len(xs))
    return xs[order], ys[order]


# Median single-detector SNRs per Gravity Spy class, loosely following the
# O3 catalog's per-class 'snr' column statistics (the CSV schema the real
# reference consumes, generate_glitch_dataset.py:19-31): Koi Fish are loud,
# Scattered Light / No Glitch weak. Samples draw SNR ~ median * lognormal.
CLASS_MEDIAN_SNR = {
    "1080 Lines": 10.0, "Blip": 11.0, "Blip Low Freq": 9.0,
    "Fast Scattering": 9.0, "GW": 12.0, "Koi Fish": 25.0, "No Glitch": 0.0,
    "Power Line": 10.0, "Scattered Light": 8.0, "Tomte": 10.0, "Whistle": 11.0,
}


def realistic_glitch_dataset(
    n_per_class: int,
    seed: int = 0,
    duration: float = 1.0,
    sample_rate: float = 2048.0,
    span: float = 8.0,
    psd_name: str = "aLIGOZeroDetHighPower",
    batch: int = 64,
    return_achieved: bool = False,
    device: DeviceLike = None,
):
    """(strain [N, T], labels [N]) with the morphologies embedded in
    PSD-colored noise and passed through the reference's pipeline, on
    ``device`` (``None``: the card; raises without one).

    Each glitch is colored by the detector ASD, injected into ``span``
    seconds of colored noise at a per-class SNR drawn from a
    Gravity-Spy-like distribution (CLASS_MEDIAN_SNR * lognormal(0.35)),
    then data-whitened (4 s Welch segments), 30 Hz highpassed, and cropped
    to [t_glitch - 0.8 s, t_glitch + 0.2 s) (generate_glitch_dataset.py:
    31-72). Output is normalized to unit (robust) background std.

    Injection amplitudes are calibrated against the KNOWN noise PSD (a
    fixed linear filter), not by self-whitening the noiseless glitch, which
    is scale-invariant. ``return_achieved=True`` also returns the
    per-sample (achieved, target) SNRs, "achieved" measured through the
    data-estimated whitening the crops go through (a non-circular check of
    the calibration). The noise of class c's batch starting at s is stream
    (seed, STREAM_GLITCH, c, s) of :func:`gwkit_torch.data.noise.seeded_draws`.
    """
    from gwkit_torch.data.noise import STREAM_GLITCH, seeded_colored_noise
    from gwkit_torch.ops.psd import get_psd

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_span = int(span * sample_rate)
    n_crop = int(duration * sample_rate)
    psd = np.asarray(get_psd(psd_name, n_span // 2 + 1, 1.0 / span, 15.0), np.float64)
    pos = psd > 0
    c = float(psd[pos].mean()) if pos.any() else 1.0
    psd_n = torch.from_numpy((psd / c).astype(np.float32)).to(dev)
    asd_n = np.sqrt(np.where(pos, psd / c, 0.0)).astype(np.float32)

    mid = n_span // 2
    xs, ys = [], []
    achieved, targets = [], []
    for ci, cls in enumerate(GLITCH_CLASSES):
        for s in range(0, n_per_class, batch):
            b = min(batch, n_per_class - s)
            # whitened-domain morphologies placed at the span center
            gw = np.stack([synthesize_glitch(rng, cls, duration, sample_rate) for _ in range(b)])
            placed = np.zeros((b, n_span), np.float32)
            placed[:, mid - n_crop // 2: mid + n_crop - n_crop // 2] = gw
            colored = np.fft.irfft(np.fft.rfft(placed, axis=-1) * asd_n, n_span, axis=-1)

            noise = seeded_colored_noise([(seed, STREAM_GLITCH, ci, s)], n_span, 1.0 / sample_rate,
                                         psd_n.expand(b, psd_n.shape[0]))[0]
            # the calibration pass whitens with the KNOWN noise PSD, so the
            # pipeline is linear: L2(lam * colored) = lam * L2(colored)
            pure = preprocess_glitch_strain(torch.as_tensor(colored, dtype=torch.float32, device=dev), sample_rate,
                                            crop_duration=None, psd=psd_n)
            bg = preprocess_glitch_strain(noise, sample_rate, crop_duration=None, psd=psd_n)
            bg_std = np.median(np.abs(bg), axis=-1) / 0.6745
            unit_snr = np.sqrt((pure ** 2).sum(axis=-1)) / np.maximum(bg_std, 1e-30)
            if cls == "No Glitch":
                lam = np.zeros(b)
            else:
                target = CLASS_MEDIAN_SNR[cls] * rng.lognormal(0.0, 0.35, b)
                lam = target / np.maximum(unit_snr, 1e-12)
            data = noise.cpu().numpy() + lam[:, None] * colored
            white = preprocess_glitch_strain(torch.as_tensor(data, dtype=torch.float32, device=dev), sample_rate,
                                             crop_duration=None)
            if return_achieved:
                # through the data-estimated pipeline the crops go through
                wn = preprocess_glitch_strain(noise, sample_rate, crop_duration=None)
                bg2 = np.median(np.abs(wn), axis=-1) / 0.6745
                ach = np.sqrt(((white - wn) ** 2).sum(axis=-1)) / np.maximum(bg2, 1e-30)
                achieved.extend(ach.tolist())
                targets.extend((lam * unit_snr).tolist())
            # the reference's asymmetric crop: [t_glitch - 0.8 s, t_glitch + 0.2 s)
            m2 = white.shape[-1] // 2
            lo = m2 - int(0.8 * sample_rate)
            crop = white[:, lo: lo + n_crop]
            crop = crop / np.maximum(np.median(np.abs(crop), axis=-1, keepdims=True) / 0.6745, 1e-30)
            xs.append(crop.astype(np.float32))
            ys.extend([ci] * b)
    xs = np.concatenate(xs)
    ys = np.asarray(ys, np.int32)
    order = rng.permutation(len(xs))
    if return_achieved:
        return xs[order], ys[order], (np.asarray(achieved)[order], np.asarray(targets)[order])
    return xs[order], ys[order]


class LabeledDataset:
    """Labeled strain (N, T) with integer labels (N,), on ``device``
    (``None``: the CUDA card; raises without one), with the ``batches``
    protocol. ``augment`` applies :func:`_augment_batch` to each batch."""

    def __init__(self, strain, labels, augment: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.strain = torch.as_tensor(np.asarray(strain, np.float32)).to(self.device)
        self.labels = torch.as_tensor(np.asarray(labels, np.int64)).to(self.device)
        self.augment = augment

    def __len__(self) -> int:
        return len(self.labels)

    def batches(self, generator: torch.Generator, batch_size: int, shuffle: bool = True,
                drop_remainder: bool = True) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """One epoch of (strain (B, T), labels (B,)) device batches."""
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator))
        for idx in epoch_indices(len(self), batch_size, seed, shuffle, drop_remainder):
            idx = torch.from_numpy(np.ascontiguousarray(idx)).to(self.device)
            x = self.strain[idx]
            if self.augment:
                x = _augment_batch(generator, x)
            yield x, self.labels[idx]


def _augment_batch(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Per row: a circular shift within +-n/10 samples (+-0.1 s of a 1 s
    window), a sign flip with probability 1/2 and an amplitude from
    U(0.7, 1.4); all three are symmetries of the whitened-strain task."""
    b, n = x.shape
    max_shift = n // 10
    shifts = torch.randint(-max_shift, max_shift + 1, (b,), generator=generator)
    sign = torch.where(torch.rand(b, generator=generator) < 0.5, 1.0, -1.0)
    amp = 0.7 + 0.7 * torch.rand(b, generator=generator)
    idx = (torch.arange(n)[None, :] - shifts[:, None]) % n  # roll row i by shifts[i]
    rolled = torch.gather(x, 1, idx.to(x.device))
    return rolled * (sign * amp).to(x.device, x.dtype)[:, None]
