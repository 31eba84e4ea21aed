"""Real-data ingestion: Gravity Spy glitch corpora and GWTC event strain
(counterpart of ``gwkit/data/fetch.py``).

The reference fetches open LIGO data with gwpy
(`Glitch_classification/utils/generate_glitch_dataset.py:19-116`: per-CSV-row
``TimeSeries.fetch_open_data(ifo, gps-8, gps+8)`` -> 2x decimate to 2048 Hz
-> pycbc whiten (4 s segments) -> 30 Hz highpass -> crop [gps-0.8, gps+0.2))
and feeds event strain HDF5s into `Real_events/preprocess_real_events.py`.

The network call sits behind an injectable ``fetch_fn`` (gwpy is imported
only when no ``fetch_fn`` is given), and the download URL is an argument,
so everything after the fetch (CSV parsing, decimation, whitening,
highpass, cropping, labeling, output layouts, resumed downloads) runs
without a network. The whitening runs on the device through
:func:`gwkit_torch.data.glitch.preprocess_glitch_strain`; ``h5py``, gwpy
and ``urllib`` are imported inside the functions that use them.
"""
from __future__ import annotations

import csv
import logging
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from gwkit_torch.data.glitch import CLASS_TO_INDEX, GLITCH_CLASSES
from gwkit_torch.device import DeviceLike

#: fetch_fn(ifo: str, gps_start: float, gps_end: float) -> (strain f64 array, sample_rate)
FetchFn = Callable[[str, float, float], Tuple[np.ndarray, float]]


def gwpy_fetch(ifo: str, gps_start: float, gps_end: float) -> Tuple[np.ndarray, float]:
    """Open-data fetch via gwpy (network + gwpy required; reference
    generate_glitch_dataset.py:19-29)."""
    try:
        from gwpy.timeseries import TimeSeries
    except ImportError as e:
        raise RuntimeError(
            "gwpy is required for open-data fetching; install gwpy or pass "
            "an explicit fetch_fn") from e
    data = TimeSeries.fetch_open_data(ifo, gps_start, gps_end, cache=True)
    return np.asarray(data.value, np.float64), float(data.sample_rate.value)


def read_gravityspy_csv(path: str, label: Optional[str] = None) -> List[dict]:
    """Parse a Gravity Spy trigger CSV into rows with GPStime/snr/ifo/label.

    The reference derives the class label from the CSV *filename*
    (`preprocess_data.py` label-from-filename); an explicit ``label``
    overrides, and a 'label' column (if present) wins over both.
    """
    if label is None:
        stem = os.path.splitext(os.path.basename(path))[0]
        cleaned = re.sub(r"[_-]+", " ", stem).strip()
        for cls in GLITCH_CLASSES:
            if cls.lower() in cleaned.lower():
                label = cls
                break
    rows = []
    with open(path, newline="") as f:
        for rec in csv.DictReader(f):
            rec = {k.strip(): v for k, v in rec.items()}
            rows.append({
                "GPStime": float(rec["GPStime"]),
                "snr": float(rec.get("snr", 0.0)),
                "ifo": rec.get("ifo", "H1").strip(),
                "label": rec.get("label", label),
            })
    return rows


def fetch_glitch_window(
    row: dict,
    fetch_fn: FetchFn,
    target_rate: float = 2048.0,
    half_span: float = 8.0,
    device: DeviceLike = None,
) -> Optional[np.ndarray]:
    """One CSV row -> whitened/highpassed 1 s window at 2048 Hz, cropped
    [gps-0.8, gps+0.2) around the trigger (reference process_row semantics:
    generate_glitch_dataset.py:31-72), whitened on ``device`` (``None``:
    the card). Returns None on fetch failure/NaNs."""
    from gwkit_torch.data.glitch import preprocess_glitch_strain

    gps = row["GPStime"]
    try:
        strain, rate = fetch_fn(row["ifo"], gps - half_span, gps + half_span)
    except Exception as e:
        logging.error("fetch failed for %s @ %s: %s", row["ifo"], gps, e)
        return None
    strain = np.asarray(strain, np.float64)
    step = int(round(rate / target_rate))
    if step > 1:
        strain = strain[::step]  # reference decimates 4096 -> 2048 by [::2]
    n = strain.shape[0]
    # whiten the full span (4 s PSD segments); crop asymmetrically so the
    # trigger sits at 0.8 s into the 1 s window
    white = preprocess_glitch_strain(
        strain[None], sample_rate=target_rate, segment_duration=4.0,
        crop_duration=None,  # crop by GPS below, not by center
        device=device,
    )[0]
    crop_lost = (n - white.shape[0]) // 2  # symmetric whitening-edge crop
    center = n // 2 - crop_lost  # trigger sample index in the whitened series
    lo = center - int(round(0.8 * target_rate))
    hi = lo + int(round(1.0 * target_rate))
    if lo < 0 or hi > white.shape[0]:
        return None
    window = white[lo:hi]
    if np.isnan(window).any():
        logging.warning("NaNs for GPS %s", gps)
        return None
    return window.astype(np.float32)


def build_gravityspy_corpus(
    csv_paths: Sequence[str],
    output_path: str,
    fetch_fn: Optional[FetchFn] = None,
    max_rows_per_file: Optional[int] = None,
    device: DeviceLike = None,
) -> int:
    """CSV trigger lists -> labeled glitch corpus HDF5 ('strain' [N, 2048],
    'labels' [N], 'SNR' [N]) in the layout `gwkit_torch.cli.train_glitch`
    consumes (reference output: 'Strain'/'SNR' per processed file), each
    window whitened on ``device`` (``None``: the card). Returns N."""
    import h5py

    fetch_fn = fetch_fn or gwpy_fetch
    strains, labels, snrs = [], [], []
    for path in csv_paths:
        rows = read_gravityspy_csv(path)
        if max_rows_per_file:
            rows = rows[:max_rows_per_file]
        for row in rows:
            if row["label"] not in CLASS_TO_INDEX:
                logging.warning("unknown class %r; skipping", row["label"])
                continue
            window = fetch_glitch_window(row, fetch_fn, device=device)
            if window is None:
                continue
            strains.append(window)
            labels.append(CLASS_TO_INDEX[row["label"]])
            snrs.append(row["snr"])
    if not strains:
        raise IOError("no valid rows fetched")
    with h5py.File(output_path, "w") as f:
        f.create_dataset("strain", data=np.stack(strains))
        f.create_dataset("labels", data=np.asarray(labels, np.int64))
        f.create_dataset("SNR", data=np.asarray(snrs, np.float64))
    return len(strains)


#: the MLGWSC-1 challenge's published real-noise file (dataset 4)
REAL_NOISE_URL = (
    "https://www.atlas.aei.uni-hannover.de/work/marlin.schaefer/MDC/real_noise_file.hdf"
)


def download_file(
    url: str,
    path: str,
    resume: bool = True,
    chunk_size: int = 1 << 16,
    max_stalls: int = 3,
    timeout: float = 60.0,
) -> int:
    """Resumable byte-range HTTP download of ``url`` to ``path``; returns the
    final size in bytes.

    Reference parity: MLGWSC-1/generate_data.py:49-91 (``download_data``)
    appends from the local size with a ``Range`` header. This version also
    *verifies* the server honored the range (HTTP 206) — a 200 reply to a
    ranged request restarts from scratch instead of silently corrupting the
    file by appending a second full copy — and survives mid-transfer
    connection drops by re-issuing ranged requests until the Content-Range
    total is reached (``max_stalls`` consecutive zero-progress attempts
    abort).
    """
    import http.client
    import urllib.error
    import urllib.request

    if not resume and os.path.isfile(path):
        os.remove(path)
    stalls = 0
    while True:
        resume_size = os.path.getsize(path) if os.path.isfile(path) else 0
        req = urllib.request.Request(url)
        if resume_size:
            req.add_header("Range", f"bytes={resume_size}-")
        try:
            resp = urllib.request.urlopen(req, timeout=timeout)
        except urllib.error.HTTPError as e:
            if e.code == 416 and resume_size:
                return resume_size  # range starts at EOF: already complete
            raise
        status = getattr(resp, "status", None) or resp.getcode()
        mode = "ab" if resume_size and status == 206 else "wb"
        if mode == "wb":
            resume_size = 0  # server ignored the range (or fresh download)
        total = None
        content_range = resp.headers.get("Content-Range", "")
        if "/" in content_range and content_range.rsplit("/", 1)[1].isdigit():
            total = int(content_range.rsplit("/", 1)[1])
        elif resp.headers.get("Content-Length") is not None:
            total = resume_size + int(resp.headers["Content-Length"])
        wrote = 0
        try:
            with open(path, mode) as fp:
                while True:
                    chunk = resp.read(chunk_size)
                    if not chunk:
                        break
                    fp.write(chunk)
                    wrote += len(chunk)
        except (http.client.HTTPException, OSError) as e:
            logging.warning("download interrupted after %d bytes: %s", wrote, e)
        finally:
            resp.close()
        size = os.path.getsize(path)
        if total is None or size >= total:
            return size
        stalls = 0 if wrote else stalls + 1
        if stalls >= max_stalls:
            raise IOError(
                f"download of {url} stalled at {size}/{total} bytes "
                f"after {max_stalls} zero-progress attempts")
        logging.info("resuming download of %s at byte %d/%d", url, size, total)


def download_real_noise(
    path: str = "real_noise_file.hdf",
    url: str = REAL_NOISE_URL,
    force: bool = False,
) -> str:
    """Fetch the dataset-4 real-noise file, resuming interrupted transfers
    and re-downloading from scratch if the result is not a readable HDF5
    (reference: MLGWSC-1/generate_data.py:276-281). Returns ``path``, ready
    for ``generate_challenge_data(dataset=4, real_noise_path=path)``."""
    import h5py

    def _readable() -> bool:
        try:
            with h5py.File(path, "r") as f:
                f.attrs.keys()
            return True
        except Exception:
            return False

    if os.path.isfile(path) and not force:
        if _readable():
            return path
        # probably an interrupted download: finish it, then re-check
        download_file(url, path, resume=True)
        if _readable():
            return path
        logging.warning("%s is not a readable HDF5; re-downloading", path)
        os.remove(path)
    download_file(url, path, resume=False)
    if not _readable():
        raise IOError(f"downloaded file at {path} is not a readable HDF5")
    return path


def fetch_event_file(
    events: Dict[str, float],
    output_path: str,
    fetch_fn: Optional[FetchFn] = None,
    detectors: Sequence[str] = ("H1", "L1"),
    half_span: float = 8.0,
    target_rate: float = 2048.0,
) -> None:
    """GWTC events ({name: gps}) -> the {event: {h1_strain, l1_strain}} HDF5
    the real-events preprocessor consumes (reference
    preprocess_real_events.py:31-39 input layout)."""
    import h5py

    fetch_fn = fetch_fn or gwpy_fetch
    with h5py.File(output_path, "w") as f:
        for name, gps in events.items():
            g = f.create_group(name)
            for det in detectors:
                strain, rate = fetch_fn(det, gps - half_span, gps + half_span)
                step = int(round(rate / target_rate))
                if step > 1:
                    strain = np.asarray(strain)[::step]
                g.create_dataset(f"{det.lower()[0]}1_strain", data=np.asarray(strain, np.float64))
                g.attrs["gps"] = gps
