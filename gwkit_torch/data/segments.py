"""Science-segment bookkeeping + inter-detector time slides (counterpart of
``gwkit/data/segments.py``, kept as its own numpy copy: host code).

Re-derivation of the MLGWSC-1 challenge's ``segments.py`` (OverlapSegment /
SegmentList), which the reference imports but does not ship
(MLGWSC-1/generate_data.py:26 — flagged missing in SURVEY.md §2.10):

* :class:`OverlapSegment` — one science segment holding per-detector strain;
  ``get(shift=True)`` applies relative time slides between detectors (dataset
  4 decorrelates real noise this way) while keeping a common overlap span.
* :class:`SegmentList` — ordered list with duration filtering and the
  restrict-to-duration logic of generate_data.py:115-195.

Also ships the O3a-style default segment table generator used when no
segments.csv is available.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class DetectorData:
    detector: str
    strain: np.ndarray
    start_time: float
    sample_rate: float

    @property
    def end_time(self) -> float:
        return self.start_time + len(self.strain) / self.sample_rate


class OverlapSegment:
    """Multi-detector strain over one science segment."""

    def __init__(self, *data: DetectorData, duration: Optional[float] = None):
        self.data: List[DetectorData] = list(data)
        self.duration = duration

    def add_timeseries(self, d: DetectorData) -> None:
        self.data.append(d)

    @property
    def detectors(self) -> List[str]:
        return [d.detector for d in self.data]

    @property
    def overlap(self) -> Tuple[float, float]:
        start = max(d.start_time for d in self.data)
        end = min(d.end_time for d in self.data)
        if end <= start:
            raise ValueError("detectors do not overlap")
        return start, end

    def get(
        self, shift: bool = False, rng: Optional[np.random.Generator] = None
    ) -> Tuple[float, np.ndarray]:
        """Returns (start_time, strain (D, N)) over the common span.

        ``shift=True`` applies independent relative time slides to
        detectors 1.. (detector 0 unshifted) — the challenge's dataset-4
        mechanism to decorrelate real noise between detectors while
        preserving each detector's own statistics. When ``duration`` trims
        the segment below the available overlap, the spare tail acts as the
        slide buffer and shifts are non-circular offsets into it
        (generate_data.py:286-292 reserves 240 s for exactly this);
        otherwise the slide wraps circularly.
        """
        start, end = self.overlap
        fs = self.data[0].sample_rate
        dur = self.duration if self.duration is not None else end - start
        dur = min(dur, end - start)
        n = int(round(dur * fs))
        buffer = int(round((end - start - dur) * fs))
        rng = rng or np.random.default_rng()
        rows = []
        for i, d in enumerate(self.data):
            assert d.sample_rate == fs, "mixed sample rates in a segment"
            s = int(round((start - d.start_time) * fs))
            if shift and i > 0:
                if buffer > 0:
                    off = int(rng.integers(0, buffer + 1))
                    row = d.strain[s + off : s + off + n]
                else:
                    row = np.roll(d.strain[s : s + n], int(rng.integers(0, n)))
            else:
                row = d.strain[s : s + n]
            rows.append(row)
        return start, np.stack(rows)


class SegmentList:
    def __init__(self, segments: Optional[Sequence[OverlapSegment]] = None):
        self.segments: List[OverlapSegment] = list(segments or [])

    def add_segment(self, seg: OverlapSegment) -> None:
        self.segments.append(seg)

    def apply_dynamic_shifts(self, rng=None) -> List[Tuple[float, np.ndarray]]:
        return [seg.get(shift=True, rng=rng) for seg in self.segments]

    def get_full_seglist(self) -> List[Tuple[float, float]]:
        return [seg.overlap for seg in self.segments]

    def get_full_duration(self) -> float:
        return sum(e - s for s, e in self.get_full_seglist())


def restrict_segments(
    spans: Sequence[Tuple[float, float]], duration: float, min_segment: float = 0.0
) -> List[Tuple[float, float]]:
    """Take segments in order until the requested total duration is covered,
    trimming the last one (generate_data.py:115-195 semantics)."""
    out: List[Tuple[float, float]] = []
    remaining = duration
    for start, end in spans:
        if remaining <= 0:
            break
        span = end - start
        if span < min_segment:
            continue
        take = min(span, remaining)
        out.append((start, start + take))
        remaining -= take
    if remaining > 0:
        raise ValueError(f"segment list too short: {remaining:.0f}s uncovered")
    return out


def default_o3a_segments(
    start_gps: float = 1238166018.0, total: float = 2_592_000.0
) -> List[Tuple[float, float]]:
    """Deterministic stand-in for the challenge's segments.csv: science
    segments of a few hours separated by short gaps, starting at the O3a
    epoch. Use load_segments_csv for the real table when available."""
    segs = []
    t = start_gps
    rng = np.random.default_rng(20190401)
    acc = 0.0
    while acc < total:
        dur = float(rng.uniform(3600.0, 6 * 3600.0))
        gap = float(rng.uniform(60.0, 1800.0))
        segs.append((t, t + dur))
        acc += dur
        t += dur + gap
    return segs


def load_segments_csv(path: str) -> List[Tuple[float, float]]:
    """segments.csv: lines of `index,start,end` (challenge format)."""
    data = np.loadtxt(path, delimiter=",")
    if data.ndim == 1:
        data = data[None]
    return [(float(r[-2]), float(r[-1])) for r in data]
