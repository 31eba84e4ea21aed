"""Driver of the MLGWSC-1 continuous search through the port's engine:
``gwkit_torch.search.engine.score_segments`` (whitening, the slicer,
``Task.score``: Q-scan, Q-adapter, encoder with DoRA, head) with one call a
segment, then ``gwkit_torch.search.cluster.get_clusters`` on its triggers.

Set-up builds the kernels the configuration names, makes the segments from
the seed, loads the task from the checkout's weights as the search CLI
loads it and runs one warm segment, whose scores' quantile sets the trigger
threshold. The window runs segments in turn and ends at the first segment
end after ``--seconds``. The check scores a seeded sample of the window's
windows with the plain reference (whitening of the same blocks, Q-scan,
Q-adapter, encoder, head) and re-derives their trigger decisions and every
segment's clusters.
"""
from __future__ import annotations

import sys
import time
from typing import List

import numpy as np
import torch

from gwbench import counts, generate
from gwbench.files import checkout_path
from gwbench.tracing import Slice


class Cell:
    def __init__(self, run):
        from gwkit_torch.cli.inference import load_task_from_components
        from gwkit_torch.ops import _cuda
        from gwkit_torch.search.slicer import Segment, SlicerConfig

        self.run, self.cfg, self.mix = run, run.config, run.mix
        self.params = run.cell["params"]
        self._cuda = _cuda
        dev = run.device
        with run.part("build_s"):
            if dev.type == "cuda":
                _cuda.build(self.cfg["kernels"])
        with run.part("inputs_s"):
            fs = self.mix["sample_rate"]
            self.raw = generate.segments(self.mix, run.seed)
            self.segments = [Segment(key=f"segment{i}", strain=s, start_time=0.0, delta_t=1.0 / fs)
                             for i, s in enumerate(self.raw)]
            self.slicer_cfg = SlicerConfig(**self.cfg["slicer"], batch_size=self.params["batch_size"])
        with run.part("weights_s"):
            w = self.cfg["weights"]
            q = self.cfg["qadapter"]
            self.task = load_task_from_components(
                str(checkout_path(w["lora"])), str(checkout_path(w["head"])), str(checkout_path(w["qadapter"])),
                encoder=self.cfg["preset"], pretrained_encoder=str(checkout_path(w["encoder"])),
                target_shape=tuple(q["target_shape"]), device=dev)
            self.step = self.task.score
            if self.cfg.get("control") == "fp8":  # the reference in float8 in the model step's place
                from gwbench.reference.search import SearchReference

                self.step = SearchReference(self.cfg, dev, precision="fp8").score
        with run.part("warm_s"):
            warm = self._segment(0, self.step, threshold=float("inf"))
            self.threshold = float(np.quantile(warm["scores"], self.params["threshold_quantile"]))
            if dev.type == "cuda":
                torch.cuda.synchronize()
        self.results: List[dict] = []
        self.slice = None

    def _segment(self, k: int, score, threshold: float) -> dict:
        from gwkit_torch.search.cluster import get_clusters
        from gwkit_torch.search.engine import score_segments

        spans = self.run.spans
        with spans.span("segment"):
            res = score_segments(score, [self.segments[k % len(self.segments)]], self.slicer_cfg,
                                 trigger_threshold=threshold, device=self.run.device)
            with spans.span("cluster"):
                clusters = get_clusters(res.triggers, self.cfg["cluster_threshold"])
        (triggers,) = res.triggers.values()
        return {"distinct": k % len(self.segments), "scores": res.all_vals, "triggers": triggers,
                "clusters": clusters, "strain_seconds": res.strain_seconds}

    def window(self, seconds: float) -> dict:
        spans = self.run.spans
        batches = [0]

        def score(windows):
            batches[0] += 1
            with spans.span("score"):
                return self.step(windows)

        trace = self.run.cell["trace"]
        self.slice = Slice(trace["start_unit"] if self.run.trace else None, trace["units"],
                           lambda: dict(self._cuda.LAUNCHES))
        fn = score if self.run.trace else self.step
        t0 = time.perf_counter()
        ends = []
        k = 0
        while True:
            self.slice.before(k)
            if k == self.slice.start:
                batches[0] = 0
            self.results.append(self._segment(k, fn, self.threshold))
            self.slice.after(k)
            if k == self.slice.start:
                self.slice_batches = batches[0]
            k += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds and self.slice.done:
                break
        wall = time.perf_counter() - t0
        seg_s = np.diff([0.0] + ends)
        strain = sum(r["strain_seconds"] for r in self.results)
        n_windows = sum(len(r["scores"]) for r in self.results)
        failed = sum(int((~np.isfinite(r["scores"])).sum()) for r in self.results)
        return {"metrics": {"search_strain_s_per_s": strain / wall}, "attempted": n_windows, "failed": failed,
                "notes": [f"window {wall:.3f} s, {k} segments, {n_windows} windows, threshold {self.threshold!r}",
                          "segment seconds " + " ".join(f"{x:.3f}" for x in seg_s)]}

    def trace_slice(self):
        ctx = self.slice.reduce()
        cfg = self.cfg
        seqs = self.params["batch_size"] * self.mix["detectors"]
        tokens = cfg["qadapter"]["target_shape"][1] // 2
        peak = counts.peaks(torch.cuda.get_device_name(self.run.device)) if self.run.device.type == "cuda" else None
        bounds = {}
        if peak is not None:
            per = counts.layer_launches(seqs, tokens, cfg["d_model"], cfg["encoder_ffn_dim"],
                                        cfg["encoder_attention_heads"], 2)
            bounds = {k: sum(counts.least_seconds(b, f, peak) for b, f in v) / len(v) for k, v in per.items()}
        windows = len(self.results[self.slice.start]["scores"])
        ctx.extra.update(batches=self.slice_batches, peak=peak, bounds=bounds,
                         model_flops=windows * counts.search_window_flops(cfg))
        return ctx

    def check(self) -> List[dict]:
        """Reference scores of a seeded sample of the window's windows, their
        trigger decisions, and the clusters of every segment."""
        from gwbench.reference import search as ref

        self.task = self.step = None  # the port's state goes before the reference runs
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()
        chk = self.run.cell["check"]
        dt = 1.0 / self.mix["sample_rate"]
        model = ref.SearchReference(self.cfg, self.run.device)
        n_win = model.geometry(self.raw[0].shape[1], dt)["n_windows"]  # every segment has as many
        rng = np.random.default_rng([self.run.seed, 17])
        n = min(chk["sample_windows"], len(self.results) * n_win)
        flat = rng.choice(len(self.results) * n_win, size=n, replace=False)
        picks = [(int(i) // n_win, int(i) % n_win) for i in flat]
        want = {}
        for d in sorted({self.results[r]["distinct"] for r, _ in picks}):
            ws = sorted({w for r, w in picks if self.results[r]["distinct"] == d})
            want[d] = dict(zip(ws, model.scores(self.raw[d], ws, dt)))
        scores = [self.results[r]["scores"] for r, _ in picks]
        got = np.array([s[w] if w < len(s) else np.nan for s, (_, w) in zip(scores, picks)], np.float64)
        ref_s = np.array([want[self.results[r]["distinct"]][w] for r, w in picks], np.float64)
        return search_checks(got, ref_s, picks, self.results, model, self.threshold, chk["limits"], n_win,
                             dt, self.cfg["cluster_threshold"])


def search_checks(got, ref_s, picks, results, model, threshold, limits, n_win, dt, gap) -> List[dict]:
    """The numbers compared, each with its limit."""
    from gwbench.reference.search import clusters as ref_clusters

    scale = float(np.std(ref_s))
    err = got - ref_s
    print(f"gwbench: compared {len(got)} windows: reference scores std {scale!r}, span "
          f"{float(np.ptp(ref_s))!r}; error rms {float(np.sqrt(np.mean(err ** 2)))!r}, "
          f"max {float(np.max(np.abs(err)))!r}", file=sys.stderr)
    rel_rms = float(np.sqrt(np.mean(err ** 2)) / scale) if scale > 0 else float("inf")
    rel_max = float(np.max(np.abs(err)) / scale) if scale > 0 else float("inf")
    if not np.all(np.isfinite(got)):
        rel_rms = rel_max = float("inf")
    # trigger decisions of the sampled windows, away from the threshold by more than the allowed error
    margin = limits["score_max_err"] * scale
    flips = 0
    for (r, w), s_ref in zip(picks, ref_s):
        fired = w in model.trigger_windows(results[r]["triggers"], dt)
        if abs(s_ref - threshold) > margin and fired != (s_ref > threshold):
            flips += 1
    # every segment's clusters against the reference clustering of its triggers
    bad_clusters = sum(int(not _same(res["clusters"], ref_clusters(res["triggers"], gap))) for res in results)
    missing = sum(abs(len(res["scores"]) - n_win) for res in results)
    return [
        {"name": "score_rms_err", "value": rel_rms, "limit": limits["score_rms_err"]},
        {"name": "score_max_err", "value": rel_max, "limit": limits["score_max_err"]},
        {"name": "trigger_flips", "value": flips, "limit": 0},
        {"name": "cluster_mismatch", "value": bad_clusters, "limit": 0},
        {"name": "windows_missing", "value": missing, "limit": 0},
    ]


def _same(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b)) and len(a) == len(b)

