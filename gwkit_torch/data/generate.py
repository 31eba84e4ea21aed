"""Dataset generation on the card: the MLGWSC-1 challenge files and the
training corpus (counterpart of ``gwkit/data/generate.py``).

* :class:`ChallengeSynthesis` makes challenge datasets 1-4 in memory, one
  segment at a time on the device: segmented colored noise per detector
  (ds1 the design PSD, ds2 one PSD variant per detector for the run, ds3 a
  fresh variant per segment; :class:`ChallengePSDSelector`), or for ds4
  real noise from a file in the challenge layout with inter-detector time
  slides, then the injection table's waveforms projected and added.
  :func:`generate_challenge_data` writes what it makes to the
  foreground/background/injection HDF5 files of the challenge layout, and
  resumes an interrupted run.
* :func:`synthesize_training_set` makes the training corpus's arrays (1 s
  two-detector windows of whitened noise and of unit-network-SNR whitened
  waveforms), the whole waveform pipeline on the device so that only the
  windows cross to the host; :func:`generate_training_set` writes them as
  'training'/'validation' groups with 'waveforms'/'noises' datasets.

The host parts (injection tables, PSD selection and arrays, antenna
patterns, time slides) are numpy copies of gwkit's and agree bit for bit.
Generation runs in "normalized strain units" (the PSD scaled to O(1) by its
in-band mean c, so float32 holds it); physical strain is the result times
sqrt(c). SNR is invariant under the joint rescaling.

Random draws: every noise realization comes from its own stream through
:func:`gwkit_torch.data.noise.seeded_draws`, (seed, domain, segment,
detector, chunk) for the challenge, (seed, domain, split, batch) for the
corpus. gwkit splits one ``jax.random`` key in that order instead; JAX's
streams are not reproduced, and a torch seed gives the same stream only on
the same device type, so seeded outputs agree run to run per device type,
not across packages or between the card and the CPU. Since no stream
depends on another, a resumed run needs no replay and is bit-identical to
an uninterrupted one. ``h5py`` is imported only where files are read or
written.
"""
from __future__ import annotations

import logging
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gwkit_torch.data.detector import antenna_pattern, time_delay_from_earth_center
from gwkit_torch.data.noise import STREAM_CHALLENGE, STREAM_REAL_NOISE, STREAM_TRAINING, seeded_colored_noise
from gwkit_torch.data.segments import DetectorData, OverlapSegment, default_o3a_segments, restrict_segments
from gwkit_torch.data.waveforms import SourceDistribution, fd_polarizations_switch, td_polarizations
from gwkit_torch.device import DeviceLike, resolve_device
from gwkit_torch.ops.psd import get_psd, psd_variant
from gwkit_torch.ops.snr import network_snr, optimal_snr
from gwkit_torch.ops.whiten import whiten_psd

DETECTORS = ("H1", "L1")
# hour-scale segments are synthesized in 2^19-sample chunks (256 s at 2048 Hz;
# the reference chunks at 1 h, generate_data.py:404-434; chunk boundaries are
# not phase-continuous there either), this many a device call (16 MB slabs);
# the last chunk is generated whole and trimmed
N_CHUNK = 1 << 19
_NOISE_CHUNK_BATCH = 8


def _normalize_psd_array(psd: np.ndarray, device) -> Tuple[torch.Tensor, float]:
    pos = psd > 0
    c = float(psd[pos].mean()) if pos.any() else 1.0
    return torch.from_numpy((psd / c).astype(np.float32)).to(device), c


def _normalized_psd(psd_name: str, n: int, sample_rate: float, f_low: float, device):
    return _normalize_psd_array(get_psd(psd_name, n // 2 + 1, sample_rate / n, f_low), device)


def challenge_distribution(dataset: int) -> SourceDistribution:
    """The four challenge injection populations (ds{1-4}.ini semantics:
    masses U(10,50), chirp-distance-uniform; ds1 non-spinning, ds2 aligned
    spins U(-0.99, 0.99), ds3/4 isotropic spin vectors with magnitude
    U(0, 0.99) through the precession twist and the higher harmonics,
    'imrphenomxphm'; MLGWSC-1/gen.py:131-147, generate_data.py:768-771)."""
    if dataset == 1:
        return SourceDistribution()
    if dataset == 2:
        return SourceDistribution(spin_max=0.99)
    if dataset in (3, 4):
        return SourceDistribution(spin_max=0.99, isotropic_spins=True, approximant="imrphenomxphm")
    raise ValueError(f"unknown challenge dataset {dataset}")


class ChallengePSDSelector:
    """Per-dataset PSD choice (generate_data.py:355-372 semantics).

    ds1: the design PSD for every detector and segment. ds2: one variant
    per detector, fixed for the whole run. ds3: a fresh variant per
    detector per segment, drawn in call order. Variants come from
    :func:`gwkit_torch.ops.psd.psd_variant`; real PSD files can be passed
    to :func:`generate_challenge_data` through ``psd_names`` instead.
    """

    N_VARIANTS = 20

    def __init__(self, dataset: int, seed: int, detectors: Sequence[str]):
        if dataset not in (1, 2, 3):
            raise ValueError("PSD selection is defined for datasets 1-3")
        self.dataset = dataset
        self._rs = np.random.default_rng(seed)
        self._fixed = {det: int(self._rs.integers(self.N_VARIANTS)) for det in detectors}

    def key_for(self, det: str, segment_index: int) -> Tuple[str, int]:
        if self.dataset == 1:
            return ("aLIGOZeroDetHighPower", 0)
        if self.dataset == 2:
            return (det, self._fixed[det])
        return (det, int(self._rs.integers(self.N_VARIANTS)))

    def psd_array(self, key: Tuple[str, int], flen: int, delta_f: float, f_low: float) -> np.ndarray:
        name, idx = key
        if name == "aLIGOZeroDetHighPower":
            return get_psd(name, flen, delta_f, f_low)
        return psd_variant(flen, delta_f, f_low, detector=name, index=idx)


def make_injection_table(
    seed: int,
    segments: Sequence[Tuple[float, float]],
    time_step: float = 24.0,
    jitter: float = 6.0,
    distribution: SourceDistribution = SourceDistribution(),
    padding: float = 30.0,
) -> Dict[str, np.ndarray]:
    """Injection times on a time_step grid (uniform jitter in a `jitter`
    window) inside the segments, + source parameters
    (generate_data.py:574-638 / ds ini semantics)."""
    rng = np.random.default_rng(seed)
    tcs = []
    for start, end in segments:
        t = start + padding
        while t + time_step < end - padding:
            tcs.append(t + rng.uniform(0, jitter))
            t += time_step
    tcs = np.asarray(tcs)
    params = distribution.sample(rng, len(tcs))
    params["tc"] = tcs.astype(np.float64)
    return params


def _project_injection_batch(
    params: Dict[str, np.ndarray],
    sl,
    wave_duration: float,
    sample_rate: float,
    f_lower: float,
    scale: float,
    detectors: Sequence[str],
    tc_frac: float = 0.75,
    approximant: str = "imrphenomd",
    device: DeviceLike = None,
) -> torch.Tensor:
    """(B, D, N) detector strains of injections ``sl`` on the device,
    coalescence at the window's ``tc_frac`` point (normalized units via
    ``scale``). Each detector's geocenter delay is gwkit's whole-sample
    circular shift, round(delay * sample_rate), taken on the device by a
    gather, so no waveform batch crosses to the host."""
    dev = resolve_device(device)
    sub = {k: v[sl] for k, v in params.items()}
    b = len(sub["mass1"])
    hp, hc = td_polarizations({**sub, "tc": np.full(b, tc_frac * wave_duration)}, wave_duration, sample_rate,
                              f_lower, approximant=approximant, device=dev)
    hp, hc = hp * scale, hc * scale
    n = hp.shape[-1]
    t = torch.arange(n, device=dev)
    col = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev)[:, None]
    outs = []
    for det in detectors:
        fp, fc = antenna_pattern(det, sub["ra"], sub["dec"], sub["polarization"], sub["tc"])
        delay = time_delay_from_earth_center(det, sub["ra"], sub["dec"], sub["tc"])
        h = col(fp) * hp + col(fc) * hc
        shift = torch.from_numpy(np.round(delay * sample_rate).astype(np.int64)).to(dev)
        outs.append(torch.gather(h, 1, (t[None, :] - shift[:, None]) % n))  # np.roll of each row
    return torch.stack(outs, dim=1)


def _training_windows_batch(
    params: Dict[str, np.ndarray],
    sl,
    wave_duration: float,
    sample_rate: float,
    f_lower: float,
    scale: float,
    detectors: Sequence[str],
    psd_wave_n: torch.Tensor,
    mfl_dur: float,
    s0: int,
    n_window: int,
    tc_frac: float,
    approximant: str,
) -> np.ndarray:
    """(B, D, n_window) whitened unit-network-SNR training windows, the
    whole pipeline in one batched pass on ``psd_wave_n``'s device: the FD
    polarizations, the detector projection with the geocenter delay as the
    phase exp(-2 pi i f d), the irfft, the SNR normalization against the
    normalized PSD, the known-PSD whitening and the window crop; only the
    windows cross to the host."""
    dev = psd_wave_n.device
    sub = {k: v[sl] for k, v in params.items()}
    b = len(sub["mass1"])
    fps, fcs, dls = [], [], []
    for det in detectors:
        fp, fc = antenna_pattern(det, sub["ra"], sub["dec"], sub["polarization"], sub["tc"])
        fps.append(fp)
        fcs.append(fc)
        dls.append(time_delay_from_earth_center(det, sub["ra"], sub["dec"], sub["tc"]))
    fp, fc, delay = (torch.as_tensor(np.stack(x, 1), dtype=torch.float32, device=dev)[..., None]
                     for x in (fps, fcs, dls))  # (B, D, 1)
    as32 = lambda k: torch.as_tensor(np.asarray(sub.get(k, np.zeros(b))), dtype=torch.float32, device=dev)
    n = int(wave_duration * sample_rate)
    delta_t = 1.0 / sample_rate
    freqs = torch.arange(n // 2 + 1, dtype=torch.float32, device=dev) * (1.0 / (n * delta_t))
    hp, hc = fd_polarizations_switch(
        freqs, approximant, f_lower, as32("mass1"), as32("mass2"), as32("distance"), as32("inclination"),
        torch.full((b,), float(tc_frac * wave_duration), device=dev), as32("coa_phase"),
        as32("spin1z"), as32("spin2z"), as32("chi_p"), as32("alpha0"),
        as32("spin1x"), as32("spin1y"), as32("spin2x"), as32("spin2y"))
    phase = torch.exp(-2j * math.pi * freqs * delay)  # (B, D, F): the sub-sample delay
    hdet = (fp * hp[:, None, :] + fc * hc[:, None, :]) * phase
    h = torch.fft.irfft(hdet, n, dim=-1) / delta_t
    h = h * float(np.float32(scale))
    net = network_snr(optimal_snr(h, psd_wave_n, delta_t, f_lower), axis=-1)  # (B,)
    h = h / torch.clamp(net, min=1e-12)[:, None, None]
    white = whiten_psd(h.reshape(-1, n), psd_wave_n, delta_t, low_freq_cutoff=f_lower,
                       max_filter_duration=mfl_dur)
    return white.reshape(b, len(detectors), -1)[:, :, s0:s0 + n_window].cpu().numpy()


def _add_injections(
    fg_noise: Dict[str, torch.Tensor],
    params: Dict[str, np.ndarray],
    start: float,
    sample_rate: float,
    wave_duration: float,
    f_lower: float,
    detectors: Sequence[str],
    approximant: str,
    inject_batch: int,
) -> None:
    """Add every injection whose tc falls inside this segment, in place, on
    the segment's device, in gwkit's order. The last block is padded to
    ``inject_batch`` by repeating its last index, as gwkit pads it (there to
    spare a retrace), so every block is computed as gwkit computes it."""
    dev = fg_noise[detectors[0]].device
    n = len(fg_noise[detectors[0]])
    n_wave = int(wave_duration * sample_rate)
    end = start + n / sample_rate
    mask = (params["tc"] >= start) & (params["tc"] < end)
    idxs = np.flatnonzero(mask)
    for bstart in range(0, len(idxs), inject_batch):
        blk = idxs[bstart:bstart + inject_batch]
        padded = np.concatenate([blk, np.full(inject_batch - len(blk), blk[-1])]) \
            if len(blk) < inject_batch else blk
        strains = _project_injection_batch(params, padded, wave_duration, sample_rate, f_lower, 1.0, detectors,
                                           approximant=approximant, device=dev)
        for bi, gi in enumerate(blk):
            # coalescence sits 3/4 into the waveform window
            t0 = params["tc"][gi] - 0.75 * wave_duration
            s = int(round((t0 - start) * sample_rate))
            e = s + n_wave
            ws, we = max(0, -s), n_wave - max(0, e - n)
            s, e = max(s, 0), min(e, n)
            if s >= e:
                continue
            for di, det in enumerate(detectors):
                fg_noise[det][s:e] += strains[bi, di, ws:we]


def _chunked_noise(streams: Sequence[Tuple[int, ...]], n: int, sample_rate: float, psd_n: torch.Tensor,
                   c: float) -> torch.Tensor:
    """(n,) physical-scale noise on ``psd_n``'s device: one 2^19-sample chunk
    a stream, _NOISE_CHUNK_BATCH chunks a call, the last chunk trimmed."""
    out = torch.empty(n, dtype=torch.float32, device=psd_n.device)
    for off in range(0, len(streams), _NOISE_CHUNK_BATCH):
        slab = seeded_colored_noise(streams[off:off + _NOISE_CHUNK_BATCH], N_CHUNK, 1.0 / sample_rate, psd_n)
        lo = off * N_CHUNK
        m = min(n - lo, slab.numel())
        out[lo:lo + m] = slab.reshape(-1)[:m]
    return out * float(np.sqrt(c))


def write_real_noise_file(
    path: str,
    duration: float = 7200.0,
    sample_rate: float = 2048.0,
    seed: int = 0,
    detectors: Sequence[str] = DETECTORS,
    segments: Optional[List[Tuple[float, float]]] = None,
    psd_name: str = "aLIGOZeroDetHighPower",
    device: DeviceLike = None,
) -> List[Tuple[float, float]]:
    """Write a noise file in the challenge's real-noise layout.

    Layout (generate_data.py:197-216 `store_ts` / :303-316): one dataset
    per `{detector}/{int(start_time)}` with `start_time` and `delta_t`
    attrs. Dataset 4 generation consumes this layout; real O3a data
    exported from GWOSC drops into the same function. Here the content is
    colored noise synthesized on ``device`` (``None``: the card)."""
    import h5py

    dev = resolve_device(device)
    spans = segments or restrict_segments(default_o3a_segments(), duration)
    psd_n, c = _normalized_psd(psd_name, N_CHUNK, sample_rate, 18.0, dev)
    with h5py.File(path, "w") as f:
        for si, (start, end) in enumerate(spans):
            n = int(round((end - start) * sample_rate))
            for di, det in enumerate(detectors):
                streams = [(seed, STREAM_REAL_NOISE, si, di, k) for k in range(-(-n // N_CHUNK))]
                x = _chunked_noise(streams, n, sample_rate, psd_n, c)
                ds = f.create_dataset(f"{det}/{int(start)}", data=x.cpu().numpy())
                ds.attrs["start_time"] = float(start)
                ds.attrs["delta_t"] = 1.0 / sample_rate
    return spans


def load_real_noise_segments(
    path: str,
    duration: float,
    detectors: Sequence[str] = DETECTORS,
    slide_buffer: float = 240.0,
) -> List[OverlapSegment]:
    """Read a real-noise file (see :func:`write_real_noise_file` for the
    layout) into OverlapSegments, reserving ``slide_buffer`` seconds per
    segment for inter-detector time slides (generate_data.py:286-292)."""
    import h5py

    segs: List[OverlapSegment] = []
    covered = 0.0
    with h5py.File(path, "r") as f:
        starts = sorted(int(k) for k in f[detectors[0]].keys())
        for st in starts:
            if covered >= duration:
                break
            seg = OverlapSegment()
            for det in detectors:
                ds = f[f"{det}/{st}"]
                dt = float(ds.attrs["delta_t"])
                seg.add_timeseries(DetectorData(detector=det, strain=ds[()],
                                                start_time=float(ds.attrs["start_time"]), sample_rate=1.0 / dt))
            o_start, o_end = seg.overlap
            usable = (o_end - o_start) - slide_buffer
            if usable <= 0:
                continue
            seg.duration = min(usable, duration - covered)
            covered += seg.duration
            segs.append(seg)
    if covered < duration:
        raise ValueError(f"real-noise file covers {covered:.0f}s < requested {duration:.0f}s")
    return segs


class ChallengeSynthesis:
    """Challenge dataset ``dataset`` (1-4) in memory: the segment spans and
    the injection table on construction, then each segment's background and
    foreground on ``device`` (``None``: the card; raises without one) from
    :meth:`segment`. Dataset 4 takes ``real_noise_segments``
    (:func:`load_real_noise_segments`) and slides its detectors from the
    numpy ``rng`` of ``seed``. Every segment's PSD choice is drawn on
    construction in gwkit's order (segment by segment, detector by
    detector), so segments may be made in any order or skipped."""

    def __init__(
        self,
        duration: float = 86400.0,
        sample_rate: float = 2048.0,
        seed: int = 42,
        psd_names: Optional[Dict[str, str]] = None,
        detectors: Sequence[str] = DETECTORS,
        f_lower: float = 20.0,
        segments: Optional[List[Tuple[float, float]]] = None,
        distribution: Optional[SourceDistribution] = None,
        wave_duration: float = 64.0,
        inject_batch: int = 64,
        dataset: int = 1,
        real_noise_segments: Optional[List[OverlapSegment]] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.sample_rate, self.seed, self.detectors, self.f_lower = sample_rate, seed, tuple(detectors), f_lower
        self.wave_duration, self.inject_batch, self.dataset = wave_duration, inject_batch, dataset
        self.distribution = distribution or challenge_distribution(dataset)
        self.psd_names = psd_names
        rng = np.random.default_rng(seed)
        if dataset == 4:
            if real_noise_segments is None:
                raise ValueError("dataset 4 requires real noise")
            self._shifted = [seg.get(shift=True, rng=rng) for seg in real_noise_segments]
            self.spans = [(st, st + arr.shape[-1] / sample_rate) for st, arr in self._shifted]
            self._psd_keys = None
        else:
            self.spans = segments or restrict_segments(default_o3a_segments(), duration)
            if psd_names:
                self._psd_keys = [[(psd_names[det], 0) for det in self.detectors] for _ in self.spans]
            else:
                selector = ChallengePSDSelector(dataset, seed, self.detectors)
                self._psd_keys = [[selector.key_for(det, si) for det in self.detectors]
                                  for si in range(len(self.spans))]
                self._selector = selector
        self.params = make_injection_table(seed, self.spans, distribution=self.distribution)
        self._psd_cache: Dict[Tuple[str, int], Tuple[torch.Tensor, float]] = {}
        logging.info("dataset %d: %d segments, %d injections", dataset, len(self.spans), len(self.params["tc"]))

    def n_samples(self, si: int) -> int:
        start, end = self.spans[si]
        return int(round((end - start) * self.sample_rate))

    def psd_key(self, si: int, det: str) -> Tuple[str, int]:
        """The PSD segment ``si`` of detector ``det`` is drawn from: a name
        or file (index 0), or (detector, variant index)."""
        return self._psd_keys[si][self.detectors.index(det)]

    def _psd(self, key: Tuple[str, int]) -> Tuple[torch.Tensor, float]:
        if key not in self._psd_cache:
            flen, delta_f, f_low = N_CHUNK // 2 + 1, self.sample_rate / N_CHUNK, self.f_lower - 2.0
            psd = get_psd(key[0], flen, delta_f, f_low) if self.psd_names else \
                self._selector.psd_array(key, flen, delta_f, f_low)
            self._psd_cache[key] = _normalize_psd_array(psd, self.device)
        return self._psd_cache[key]

    def segment(self, si: int) -> Tuple[float, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(start, background, foreground) of segment ``si``: (N,) float32
        tensors of physical strain on the device, by detector."""
        start = self.spans[si][0]
        n = self.n_samples(si)
        background = {}
        for di, det in enumerate(self.detectors):
            if self.dataset == 4:
                row = self._shifted[si][1][di][:n].astype(np.float32)
                background[det] = torch.from_numpy(row).to(self.device)
            else:
                psd_n, c = self._psd(self.psd_key(si, det))
                streams = [(self.seed, STREAM_CHALLENGE, si, di, k) for k in range(-(-n // N_CHUNK))]
                background[det] = _chunked_noise(streams, n, self.sample_rate, psd_n, c)
        foreground = {det: x.clone() for det, x in background.items()}
        _add_injections(foreground, self.params, start, self.sample_rate, self.wave_duration, self.f_lower,
                        self.detectors, self.distribution.approximant, self.inject_batch)
        return start, background, foreground


def generate_challenge_data(
    foreground_path: str,
    background_path: str,
    injection_path: str,
    duration: float = 86400.0,
    sample_rate: float = 2048.0,
    seed: int = 42,
    psd_names: Optional[Dict[str, str]] = None,
    detectors: Sequence[str] = DETECTORS,
    f_lower: float = 20.0,
    segments: Optional[List[Tuple[float, float]]] = None,
    distribution: Optional[SourceDistribution] = None,
    wave_duration: float = 64.0,
    inject_batch: int = 64,
    dataset: int = 1,
    real_noise_path: Optional[str] = None,
    slide_buffer: float = 240.0,
    resume: bool = False,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Write background (noise), foreground (noise+injections), and
    injection-table HDF5 files in the MLGWSC-1 layout for challenge
    ``dataset`` 1-4 (dataset 4 needs ``real_noise_path``; see
    :func:`write_real_noise_file` for its layout), generated on ``device``
    (``None``: the card) by :class:`ChallengeSynthesis`.

    ``resume=True`` opens the fg/bg files in append mode, skips segments
    whose four datasets (bg/fg x detectors) are complete and drops a
    partial one; since every segment's draws are its own, the result is
    bit-identical to an uninterrupted run on the same device type. The
    injection file is written last and is the completion marker."""
    import h5py

    dev = resolve_device(device)
    if dataset == 4:
        if real_noise_path is None:
            raise ValueError("dataset 4 requires real_noise_path")
        real = load_real_noise_segments(real_noise_path, duration, detectors, slide_buffer)
    else:
        real = None
    synth = ChallengeSynthesis(duration=duration, sample_rate=sample_rate, seed=seed, psd_names=psd_names,
                               detectors=detectors, f_lower=f_lower, segments=segments, distribution=distribution,
                               wave_duration=wave_duration, inject_batch=inject_batch, dataset=dataset,
                               real_noise_segments=real, device=dev)
    mode = "a" if resume else "w"
    with h5py.File(background_path, mode) as bg, h5py.File(foreground_path, mode) as fg:
        for det in detectors:
            bg.require_group(det)
            fg.require_group(det)
        for si in range(len(synth.spans)):
            name = str(si)
            if resume:
                have = [f[det].get(name) for f in (bg, fg) for det in detectors]
                if all(d is not None and d.shape[0] == synth.n_samples(si) for d in have):
                    continue
                for f in (bg, fg):  # drop any partial write of this segment
                    for det in detectors:
                        if name in f[det]:
                            del f[det][name]
            start, background, foreground = synth.segment(si)
            for det in detectors:
                for arr, f in ((background, bg), (foreground, fg)):
                    ds = f[det].create_dataset(name, data=arr[det].cpu().numpy())
                    ds.attrs["start_time"] = start
                    ds.attrs["delta_t"] = 1.0 / sample_rate
    with h5py.File(injection_path, "w") as inj:
        for k, v in synth.params.items():
            inj.create_dataset(k, data=v)
        inj.attrs["dataset"] = dataset
    return synth.params


def synthesize_training_set(
    n_train: int = 1000,
    n_valid: int = 200,
    waveform_fraction: float = 0.5,
    sample_rate: float = 2048.0,
    window_duration: float = 1.0,
    seed: int = 0,
    psd_name: str = "aLIGOZeroDetHighPower",
    detectors: Sequence[str] = DETECTORS,
    f_lower: float = 20.0,
    wave_duration: float = 16.0,
    distribution: SourceDistribution = SourceDistribution(),
    device: DeviceLike = None,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """MLGWSC-1/gen.py parity in memory: for 'training' and 'validation',
    (waveforms [N, D, T], noises [M, D, T]) float32 host arrays of whitened
    unit-network-SNR waveform windows and whitened noise windows (M >= N),
    made on ``device`` (``None``: the card) in normalized strain units (the
    training pipeline is scale-free after whitening). Waveforms go 512 a
    batch and noise 1024 a batch through the device; only the windows are
    copied to the host."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_window = int(window_duration * sample_rate)
    n_wave = int(wave_duration * sample_rate)
    psd_wave_n, c_wave = _normalized_psd(psd_name, n_wave, sample_rate, f_lower - 2.0, dev)
    # noise windows generated long enough to survive the whitening crop
    max_filter_duration = 0.5
    pad = int(max_filter_duration * sample_rate)
    n_noise_gen = n_window + 2 * pad
    psd_noise_n, _ = _normalized_psd(psd_name, n_noise_gen, sample_rate, f_lower - 2.0, dev)
    out = {}
    for gi, (group, count) in enumerate((("training", n_train), ("validation", n_valid))):
        n_waves = int(count * waveform_fraction)
        params = distribution.sample(rng, n_waves)
        params["tc"] = np.full(n_waves, 0.75 * wave_duration)
        waves = []
        # whitening crops max_filter_len from both ends; keep the filter
        # short enough that the tc-centered window survives the crop
        mfl_dur = min(4.0, wave_duration / 4.0)
        mfl = int(mfl_dur * sample_rate)
        tc_frac = 0.5
        wave_batch = 512
        t_start = time.time()
        # place tc at the window's 0.7 point (Efficiency_test tc_mean)
        center = int(tc_frac * wave_duration * sample_rate) - mfl
        tc_pos = int(0.7 * n_window)
        n_white = n_wave - 2 * mfl
        s0 = max(0, min(center - tc_pos, n_white - n_window))
        for s in range(0, n_waves, wave_batch):
            sl = slice(s, min(s + wave_batch, n_waves))
            if s and (s // wave_batch) % 20 == 0:
                rate = s / max(time.time() - t_start, 1e-9)
                logging.info("%s waveforms: %d/%d (%.0f/s)", group, s, n_waves, rate)
            # normalized strain units h/sqrt(c): SNR is invariant under the
            # joint (h/sqrt(c), S/c) rescaling, so optimal_snr against the
            # normalized PSD is the physical SNR
            waves.append(_training_windows_batch(params, sl, wave_duration, sample_rate, f_lower,
                                                 1.0 / np.sqrt(c_wave), detectors, psd_wave_n, mfl_dur, s0,
                                                 n_window, tc_frac, distribution.approximant))
        waveforms = np.concatenate(waves) if waves else np.zeros((0, len(detectors), n_window), np.float32)

        noise_rows = []
        noise_batch = 1024
        for s in range(0, count, noise_batch):
            b = min(noise_batch, count - s)
            batch_psd = psd_noise_n.expand(b, len(detectors), psd_noise_n.shape[-1])
            noise = seeded_colored_noise([(seed, STREAM_TRAINING, gi, s // noise_batch)], n_noise_gen,
                                         1.0 / sample_rate, batch_psd)[0]
            white = whiten_psd(noise.reshape(-1, n_noise_gen), psd_noise_n, 1.0 / sample_rate,
                               low_freq_cutoff=f_lower, max_filter_duration=max_filter_duration)
            noise_rows.append(white.reshape(b, len(detectors), -1)[:, :, :n_window].cpu().numpy())
        noises = np.concatenate(noise_rows) if noise_rows else np.zeros((0, len(detectors), n_window), np.float32)
        out[group] = (waveforms.astype(np.float32), noises.astype(np.float32))
        logging.info("%s: %d waveforms, %d noises", group, len(waveforms), len(noises))
    return out


def generate_training_set(
    output_path: str,
    n_train: int = 1000,
    n_valid: int = 200,
    waveform_fraction: float = 0.5,
    sample_rate: float = 2048.0,
    window_duration: float = 1.0,
    seed: int = 0,
    psd_name: str = "aLIGOZeroDetHighPower",
    detectors: Sequence[str] = DETECTORS,
    f_lower: float = 20.0,
    wave_duration: float = 16.0,
    distribution: SourceDistribution = SourceDistribution(),
    device: DeviceLike = None,
) -> None:
    """:func:`synthesize_training_set`'s arrays written as 'training' and
    'validation' groups (InjectionDataset's layout) to ``output_path``,
    through a ``.tmp`` file renamed when complete, so that an interrupted
    generation does not look like a corpus."""
    import h5py

    corpus = synthesize_training_set(n_train=n_train, n_valid=n_valid, waveform_fraction=waveform_fraction,
                                     sample_rate=sample_rate, window_duration=window_duration, seed=seed,
                                     psd_name=psd_name, detectors=detectors, f_lower=f_lower,
                                     wave_duration=wave_duration, distribution=distribution, device=device)
    tmp_path = output_path + ".tmp"
    with h5py.File(tmp_path, "w") as f:
        for group, (waveforms, noises) in corpus.items():
            g = f.create_group(group)
            g.create_dataset("waveforms", data=waveforms)
            g.create_dataset("noises", data=noises)
    os.replace(tmp_path, output_path)
