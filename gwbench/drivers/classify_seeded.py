"""Driver of Signal_vs_Noise classification on an encoder drawn from the
seed, for a configuration whose weights the repository does not hold
(``weights.from`` "seed"; whisper-large-v3). The loop is the classify
driver's (``drivers/classify.py``): a closed loop of one client hands a
batch of strain windows from host memory to the card, ``Task.forward``
(resampling, log-mel at the encoder's bins, encoder with DoRA, two-channel
head) on ``build_signal_vs_noise`` with the CLIs' card encoder config, the
sigmoid, the probabilities copied to the host, then the next batch.

Set-up builds the kernels, makes the window pool from the seed and draws
an HF-layout encoder state dict on the card (``gwbench.hf_weights``). The
port reads it through ``gwkit_torch.models.hf_io.load_hf_encoder``, as the
CLIs' ``--hf-checkpoint``; the plain reference through its own reader
(``reference/hf_encoder.py``). The adapters and the head are drawn as the
classify driver draws them. The head's first layer is routed through the
spread of the reference's float32 embeddings of the pool's first samples
(``Cell.route_head``) after set-up and before the window's clock starts:
that pass is the reference's work, so ``setup_s`` leaves it out.
The check compares logits with the reference at the configuration's mel
bins (``reference/classify_bins.py``) as the classify driver does, and also
in units of the reference logits' spread over the sample (``logit_checks``):
on an encoder drawn from the seed the logits' dependence on the input
varies from seed to seed, and where it is weak a batch half answered by
its mean lies within a few bfloat16 errors of the reference. The rooflines'
least times count four launches of kernel B and one of A a layer
(``gwbench.counts_split``).
"""
from __future__ import annotations

import sys
import time
from types import SimpleNamespace
from typing import List

import numpy as np
import torch

from gwbench import counts, counts_split, files, generate, hf_weights
from gwbench.reference import hf_encoder
from gwbench.reference.classify_bins import ClassifierReference
from gwbench.weights import adapters_and_head, copy_tree, head_through_spread

_classify = files.driver("classify")


def logit_checks(got: np.ndarray, want: np.ndarray, want_bf16: np.ndarray, limits: dict) -> List[dict]:
    """The classify driver's ``logit_rms_vs_bf16`` (the error's rms in units
    of the float32 reference's own bfloat16 error), which the precision
    control fails, and ``logit_rms_vs_spread``: the error's rms in units of
    the reference logits' spread over the sample (their rms about their
    mean), which a fault that drops the input's part of an answer fails
    whatever the encoder's sensitivity to its input."""
    checks = _classify.logit_checks(got, want, want_bf16, limits)
    spread = float(np.sqrt(np.mean((want - want.mean()) ** 2)))
    ok = bool(np.all(np.isfinite(got))) and spread > 0
    value = float(np.sqrt(np.mean((got - want) ** 2)) / spread) if ok else float("inf")
    print(f"gwbench: reference logits' spread {spread!r}; error rms over it {value!r}", file=sys.stderr)
    return checks + [{"name": "logit_rms_vs_spread", "value": value, "limit": limits["logit_rms_vs_spread"]}]


def encoder_seed(seed: int) -> int:
    """The encoder's generator seed, apart from the adapters' and the head's
    (``seed``) and within the generator's 64 bits."""
    return (seed + (1 << 40)) % (1 << 63)


class Cell(_classify.Cell):
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
            state = hf_weights.encoder_state(cfg, encoder_seed(run.seed), dev)
            base = hf_encoder.encoder(state)  # the reference's layout, views of the state on the card
            norms_from = {"layers": [{name: {"w": layer[name]["w"].cpu().numpy()} for name in cfg["adapters"]["targets"]}
                                     for layer in base["layers"]]}
            params = adapters_and_head(cfg, run.seed, dev, norms_from)
            del norms_from
            self.weights = {**copy_tree(params), "encoder": base}  # the reference's copy
            # the port reads the state dict as the mel CLIs' --hf-checkpoint
            params["encoder"] = load_encoder_params(
                SimpleNamespace(hf_checkpoint=state, pretrained_encoder=None, encoder=cfg["preset"]), enc_cfg)
            del state
            ad = cfg["adapters"]
            acfg = AdapterConfig(r=ad["r"], alpha=ad["alpha"], use_dora=True, targets="".join(ad["targets"]))
            self.task = build_signal_vs_noise(enc_cfg, params, acfg, num_classes=cfg["head"]["num_classes"],
                                              input_sample_rate=self.mix["sample_rate"], n_frames=cfg["n_frames"],
                                              n_detectors=self.mix["detectors"], device=dev)
            del params
            self.forward = self.task.forward
        with run.part("warm_s"):
            self._batch(0)  # the head's values change below, none of its shapes
        self.logits: List[torch.Tensor] = []
        self.slice = None

    def route_head(self) -> float:
        """The head's first layer routed through the spread of the plain
        reference's float32 embeddings of the pool's first samples, in the
        reference's copy and in place in the task's; returns its seconds.
        This is the reference's work, not the program's, so it runs after
        set-up (``setup_s``) and before the window's clock starts."""
        t0 = time.perf_counter()
        cfg, dev = self.cfg, self.run.device
        calib = self.pool.reshape(-1, *self.pool.shape[2:])[:cfg["weights"]["head_calibration_samples"]]
        emb = ClassifierReference(cfg, self.weights, dev, chunk=4).embed(torch.from_numpy(calib).to(dev),
                                                                        self.mix["sample_rate"])
        head_through_spread(self.weights["head"], emb)
        del emb
        with torch.no_grad():
            for key in ("w", "b"):
                self.task.trainable["head"][0][key].copy_(self.weights["head"][0][key])
        if cfg.get("control") == "fp8":  # the reference in float8 in the task's place
            ref = ClassifierReference(cfg, self.weights, dev, precision="fp8")
            self.forward = lambda x: ref.forward(x, self.mix["sample_rate"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    def window(self, seconds: float) -> dict:
        calib_s = self.route_head()
        res = super().window(seconds)
        n = self.cfg["weights"]["head_calibration_samples"]
        res["notes"] = [f"head routed through the reference's float32 embeddings of {n} samples in "
                        f"{calib_s:.3f} s, after set-up and before the window", *res["notes"]]
        return res

    def trace_slice(self):
        ctx = self.slice.reduce()
        cfg = self.cfg
        B = self.pool.shape[1]
        peak = counts.peaks(torch.cuda.get_device_name(self.run.device)) if self.run.device.type == "cuda" else None
        bounds = {}
        if peak is not None:
            per = counts_split.layer_launches(B * self.mix["detectors"], cfg["n_frames"] // 2, cfg["d_model"],
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
