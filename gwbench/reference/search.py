"""The search's plain reference: a segment's windows scored from its raw
strain. The segment is whitened in the engine's blocks (segments longer
than ``max_block`` raw samples are whitened block by block, a block
starting at its first window and the last one sliding back to end with the
segment), windows are cut every ``step_size`` s, Q-scanned per detector,
passed through the Q-adapter, the encoder (detectors folded into the
batch) and the head on both detectors' last tokens; the score is the head's
first logit. Weights come from the checkout's files through
``reference.weights``."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from gwbench.files import checkout_path
from gwbench.reference import weights as wfiles
from gwbench.reference.model import Encoder, exact_f32, mlp_head, qadapter, tensors
from gwbench.reference.qscan import QScan
from gwbench.reference.whiten import whiten


class SearchReference:
    def __init__(self, cfg: dict, device, batch: int = 64, precision: str = "f32"):
        self.cfg, self.device, self.batch = cfg, device, batch
        s = cfg["slicer"]
        self.s = s
        w = cfg["weights"]
        enc = wfiles.encoder(str(checkout_path(w["encoder"])))
        ads = wfiles.peft_dora(str(checkout_path(w["lora"])), cfg["encoder_layers"])
        self.encoder = Encoder(enc, ads, cfg["encoder_attention_heads"], cfg["gelu"], device, precision)
        self.head = tensors(wfiles.mlp_head(str(checkout_path(w["head"]))), device)
        self.qadapter = tensors(wfiles.nest(wfiles.npz_leaves(str(checkout_path(w["qadapter"])),
                                                              wfiles.QADAPTER_KEYS)), device)
        q = cfg["qadapter"]
        self.qscan = QScan(q["kernel_length"], float(q["sample_rate"]), tuple(q["q_range"]),
                           tuple(q["spectrogram_shape"]), device=device)

    def geometry(self, n_raw: int, dt: float) -> dict:
        s = self.s
        half = int(s["max_filter_duration"] / dt) // 2
        step = int(s["step_size"] / dt)
        n_windows = 1 + (n_raw - 2 * half - s["slice_length"]) // step
        return {"half": half, "step": step, "n_windows": n_windows,
                "per_block": (s["max_block"] - 2 * half - s["slice_length"]) // step + 1}

    def trigger_windows(self, triggers: Sequence[Sequence[float]], dt: float = 1.0 / 2048) -> set:
        """Window indices of a segment's triggers (segment start 0)."""
        s = self.s
        half = int(s["max_filter_duration"] / dt) // 2
        step = int(s["step_size"] / dt)
        return {int(round((t - half * dt - s["peak_offset"]) / (step * dt))) for t, _ in triggers}

    def scores(self, raw: np.ndarray, windows: List[int], dt: float) -> np.ndarray:
        """Scores of ``windows`` (indices into the segment) of ``raw`` (D, N)."""
        s = self.s
        g = self.geometry(raw.shape[1], dt)
        blocked = raw.shape[1] > s["max_block"]
        by_block: Dict[int, List[int]] = {}
        for w in windows:
            by_block.setdefault(w // g["per_block"] if blocked else 0, []).append(w)
        out = {}
        for j, ws in by_block.items():
            r_b = min(j * g["per_block"] * g["step"], raw.shape[1] - s["max_block"]) if blocked else 0
            n = s["max_block"] if blocked else raw.shape[1]
            block = torch.from_numpy(raw[:, r_b: r_b + n]).to(self.device)
            white = whiten(block, dt, s["segment_duration"], s["max_filter_duration"], s["low_frequency_cutoff"])
            starts = [w * g["step"] - r_b for w in ws]
            cut = torch.stack([white[:, a: a + s["slice_length"]] for a in starts]).float()  # (B, D, L)
            for i in range(0, len(ws), self.batch):
                for w, sc in zip(ws[i: i + self.batch], self.score(cut[i: i + self.batch]).double().cpu().tolist()):
                    out[w] = sc
        return np.array([out[w] for w in windows], np.float64)

    @torch.no_grad()
    def score(self, windows: torch.Tensor) -> torch.Tensor:
        """(B, D, L) whitened windows -> (B,) the head's first logit."""
        B, D, L = windows.shape
        with exact_f32():
            spec = self.qscan(windows.reshape(B * D, L)).reshape(B, D, *self.qscan.shape)
            feats = qadapter(self.qadapter, spec, tuple(self.cfg["qadapter"]["target_shape"]))
            emb = self.encoder(feats.reshape(B * D, *feats.shape[2:]))[:, -1, :].reshape(B, -1)
            return mlp_head(self.head, emb)[:, 0]


def clusters(triggers: Sequence[Sequence[float]], gap: float = 0.35):
    """MLGWSC-1's clustering of one segment's time-ordered triggers: a gap
    above ``gap`` seconds starts a new cluster, each represented by its
    largest score (the first of equals), with timing variance 0.2 s."""
    times, stats, current = [], [], []

    def close():
        best = max(range(len(current)), key=lambda i: (current[i][1], -i))
        times.append(current[best][0])
        stats.append(current[best][1])

    for t, sc in triggers:
        if current and t - current[-1][0] > gap:
            close()
            current = []
        current.append((float(t), float(sc)))
    if current:
        close()
    return np.asarray(times, np.float64), np.asarray(stats, np.float64), np.full(len(times), 0.2)
