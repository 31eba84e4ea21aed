"""Driver of Signal_vs_Noise classification through the port's task:
``gwkit_torch.train.tasks.build_signal_vs_noise`` with the CLIs' card
encoder config (``cli/common.py::build_encoder_config``), and a closed loop
of one client as ``cli/evaluate_classifier.py`` runs it: hand a batch of
strain windows from host memory to the card, ``Task.forward`` (resampling,
log-mel, encoder with DoRA, two-channel head), the sigmoid, the
probabilities copied to the host, then the next batch.

Set-up builds the kernels, makes the window pool from the seed, reads the
encoder from the checkout, makes the adapters and the head on the card from
the seed (the head's first layer routed through the spread of the plain
reference's embeddings of the pool's first samples), and warms the batch's
shape. The check
runs the plain reference on a seeded sample of the window's batches, from
the same host windows and a copy of the same weights, and compares logits.
"""
from __future__ import annotations

import sys
import time
from types import SimpleNamespace
from typing import List

import numpy as np
import torch

from gwbench import counts, generate
from gwbench.files import checkout_path
from gwbench.reference import weights as ref_weights
from gwbench.reference.classify import ClassifierReference
from gwbench.tracing import Slice
from gwbench.weights import adapters_and_head, copy_tree, head_through_spread


class Cell:
    def __init__(self, run):
        from gwkit_torch.cli.common import build_encoder_config, load_encoder_params
        from gwkit_torch.models.adapters import AdapterConfig
        from gwkit_torch.ops import _cuda
        from gwkit_torch.train.tasks import build_signal_vs_noise

        self.run, self.cfg, self.mix = run, run.config, run.mix
        self._cuda = _cuda
        dev = run.device
        cfg = self.cfg
        with run.part("build_s"):
            if dev.type == "cuda":
                _cuda.build(cfg["kernels"])
        with run.part("inputs_s"):
            self.pool = generate.windows(self.mix, run.seed)["strain"]
        with run.part("weights_s"):
            enc_cfg = build_encoder_config(SimpleNamespace(cpu=dev.type != "cuda", encoder=cfg["preset"]),
                                           cfg["n_frames"])
            path = str(checkout_path(cfg["weights"]["encoder"]))
            base = ref_weights.encoder(path)
            params = adapters_and_head(cfg, run.seed, dev, base)
            calib = self.pool[0, : cfg["weights"]["head_calibration_samples"]]
            emb = ClassifierReference(cfg, {**params, "encoder": base}, dev, chunk=4).embed(
                torch.from_numpy(calib).to(dev), self.mix["sample_rate"])
            head_through_spread(params["head"], emb)
            del emb
            self.weights = {**copy_tree(params), "encoder": base}  # the reference's copy
            # the port reads the encoder file as the mel CLIs' --pretrained-encoder does
            params["encoder"] = load_encoder_params(
                SimpleNamespace(hf_checkpoint=None, pretrained_encoder=path, encoder=cfg["preset"]), enc_cfg)
            ad = cfg["adapters"]
            acfg = AdapterConfig(r=ad["r"], alpha=ad["alpha"], use_dora=True, targets="".join(ad["targets"]))
            self.task = build_signal_vs_noise(enc_cfg, params, acfg, num_classes=cfg["head"]["num_classes"],
                                              input_sample_rate=self.mix["sample_rate"], n_frames=cfg["n_frames"],
                                              n_detectors=self.mix["detectors"], device=dev)
            del params
            self.forward = self.task.forward
            if cfg.get("control") == "fp8":  # the reference in float8 in the task's place
                ref = ClassifierReference(cfg, self.weights, dev, precision="fp8")
                self.forward = lambda x: ref.forward(x, self.mix["sample_rate"])
        with run.part("warm_s"):
            self._batch(0)
        self.logits: List[torch.Tensor] = []
        self.slice = None

    def _batch(self, k: int):
        spans = self.run.spans
        with spans.span("batch"):
            x = torch.from_numpy(self.pool[k % len(self.pool)]).to(self.run.device)
            logits = self.forward(x)
            probs = torch.sigmoid(logits.float().reshape(-1))
            with spans.span("to_host"):
                probs = probs.cpu().numpy()
        return logits, probs

    def window(self, seconds: float) -> dict:
        trace = self.run.cell["trace"]
        self.slice = Slice(trace["start_unit"] if self.run.trace else None, trace["units"],
                           lambda: dict(self._cuda.LAUNCHES))
        lat = []
        t0 = time.perf_counter()
        k = 0
        while True:
            self.slice.before(k)
            t_b = time.perf_counter()
            logits, _ = self._batch(k)
            t_e = time.perf_counter()
            self.slice.after(k)
            lat.append(t_e - t_b)
            self.logits.append(logits)
            k += 1
            if t_e - t0 >= seconds and self.slice.done:
                break
        wall = time.perf_counter() - t0
        B = self.pool.shape[1]
        p95 = float(np.percentile(np.asarray(lat) * 1e3, 95))
        failed = sum(int((~torch.isfinite(lg)).any(dim=-1).sum()) for lg in self.logits)
        return {"metrics": {"classify_samples_per_s": k * B / wall, "classify_batch_p95_ms": p95},
                "attempted": k * B, "failed": failed,
                "notes": [f"window {wall:.3f} s, {k} batches of {B}, batch p95 {p95:.4f} ms, "
                          f"median {float(np.median(lat)) * 1e3:.4f} ms"]}

    def trace_slice(self):
        ctx = self.slice.reduce()
        cfg = self.cfg
        B = self.pool.shape[1]
        peak = counts.peaks(torch.cuda.get_device_name(self.run.device)) if self.run.device.type == "cuda" else None
        bounds = {}
        if peak is not None:
            per = counts.layer_launches(B * self.mix["detectors"], cfg["n_frames"] // 2, cfg["d_model"],
                                        cfg["encoder_ffn_dim"], cfg["encoder_attention_heads"], 2)
            bounds = {k: sum(counts.least_seconds(b, f, peak) for b, f in v) / len(v) for k, v in per.items()}
        units = self.slice.count
        ctx.extra.update(batches=units, peak=peak, bounds=bounds,
                         model_flops=units * B * counts.classify_sample_flops(cfg))
        return ctx

    def check(self) -> List[dict]:
        """Reference logits of a seeded sample of the window's batches, in
        float32 and with the reference's own bfloat16 rounding."""
        got_all = [lg.float().cpu().numpy() for lg in self.logits]
        self.task = self.forward = self.logits = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()
        chk = self.run.cell["check"]
        rng = np.random.default_rng([self.run.seed, 17])
        picks = sorted(rng.choice(len(got_all), size=min(chk["sample_batches"], len(got_all)), replace=False))
        rate = self.mix["sample_rate"]
        got = np.concatenate([got_all[k].reshape(-1) for k in picks]).astype(np.float64)
        want = {}
        for precision in ("f32", "bf16"):
            model = ClassifierReference(self.cfg, self.weights, self.run.device, precision=precision)
            want[precision] = np.concatenate([model.logits(self.pool[k % len(self.pool)], rate) for k in picks])
            del model
        return logit_checks(got, want["f32"], want["bf16"], chk["limits"])


def logit_checks(got: np.ndarray, want: np.ndarray, want_bf16: np.ndarray, limits: dict) -> List[dict]:
    """The program's logit error against the float32 reference, rms over the
    sample, in units of the reference's own bfloat16 error. The largest
    error is printed beside it and not compared: as a ratio of two extremes
    it does not separate sound runs from the precision control."""
    err, base = got - want, want_bf16 - want
    print(f"gwbench: compared {len(got)} logits: reference std {float(np.std(want))!r}, "
          f"rms {float(np.sqrt(np.mean(want ** 2)))!r}; error rms {float(np.sqrt(np.mean(err ** 2)))!r}, "
          f"max {float(np.max(np.abs(err)))!r}; reference bf16 error rms {float(np.sqrt(np.mean(base ** 2)))!r}, "
          f"max {float(np.max(np.abs(base)))!r}", file=sys.stderr)
    ok = bool(np.all(np.isfinite(got)))
    rms = float(np.sqrt(np.mean(err ** 2)) / np.sqrt(np.mean(base ** 2))) if ok else float("inf")
    return [{"name": "logit_rms_vs_bf16", "value": rms, "limit": limits["logit_rms_vs_bf16"]}]
