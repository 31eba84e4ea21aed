"""The workload builders (counterpart of ``gwkit/train/tasks.py``): one
:class:`Task` for each of gwkit's three front ends.

  * ``signal_vs_noise`` -- strain (B, D, T @ 2048 Hz) -> resample to 16 kHz
    -> Whisper log-mel per detector -> encoder (+DoRA), both detectors in
    one call -> two-channel (or one-channel) MLP head; BCE with logits.
  * ``glitch`` -- strain (B, T) -> the same front end -> encoder -> the
    11-class head with dropout 0.3 in training; cross entropy.
  * ``mlgwsc`` -- strain (B, D, T) -> Q-adapter -> detectors folded into the
    batch -> encoder -> last token -> (B, D * d_model) -> MLP head
    [-> softmax]; RegBCE.

A :class:`Task` holds gwkit's split: ``frozen`` (the encoder) and
``trainable`` (adapters, head and, for MLGWSC-1, the Q-adapter; with
``full_finetune`` the encoder instead of the adapters). ``apply``,
``loss_fn`` and ``embed`` take the two trees on every call and are
differentiable (the trainer's surface); ``forward`` and ``score`` are the
search's and the evaluation's, and ``forward_from_qspec`` and
``score_spec`` the streaming search's (from Q spectrograms), without
gradients, on one encoder prepared (folded for the kernel chain) from the
current encoder and adapters, and prepared anew once any of their tensors
is replaced or updated in place (as a trainer's step does).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Union

import torch

from gwkit_torch.device import DeviceLike, resolve_device
from gwkit_torch.io import tree_leaves, tree_to
from gwkit_torch.models.adapters import AdapterConfig, export_peft_dir, init_adapters
from gwkit_torch.models.classifier import (ClassifierConfig, encode_embedding, init_head,
                                           one_channel_apply, two_channel_apply)
from gwkit_torch.models.heads import mlp_head_apply
from gwkit_torch.models.qadapter import (QAdapterConfig, init_qadapter, qadapter_apply,
                                         qadapter_apply_spec)
from gwkit_torch.models.whisper import WhisperConfig, WhisperEncoder, config_for, init_encoder_params
from gwkit_torch.ops.mel import whisper_log_mel
from gwkit_torch.ops.resample import resample_timeseries
from gwkit_torch.train.checkpoints import save_pytree
from gwkit_torch.train.losses import bce_with_logits, cross_entropy, reg_bce
from gwkit_torch.utils.tracing import COUNTERS, annotate

DEFAULT_ACFG = AdapterConfig(r=8, alpha=32, use_dora=True, targets="qkvo")


@dataclasses.dataclass
class Task:
    name: str  # "mlgwsc" | "signal_vs_noise" | "glitch": the front end and the loss
    cfg: ClassifierConfig
    acfg: AdapterConfig
    frozen: Dict[str, Any]
    trainable: Dict[str, Any]
    device: torch.device
    full_finetune: bool = False
    qcfg: Optional[QAdapterConfig] = None  # the Q-adapter front end (mlgwsc)
    input_sample_rate: int = 2048  # the log-mel front end (signal_vs_noise, glitch)
    n_frames: int = 3000
    _encoder: Optional[WhisperEncoder] = dataclasses.field(default=None, repr=False)
    _encoder_key: tuple = dataclasses.field(default=(), repr=False)

    @property
    def params(self) -> Dict[str, Any]:
        """encoder, adapters, head and Q-adapter, wherever they sit."""
        return {**self.frozen, **self.trainable}

    def log_mels(self, strain: torch.Tensor) -> List[torch.Tensor]:
        """strain (B, D, T) or (B, T) -> one log-mel (B, n_mels, n_frames) per
        detector, at the encoder's number of mel bins."""
        with annotate("gw.log_mel"):
            audio = resample_timeseries(strain, self.input_sample_rate, 16000)
            if audio.dim() == 2:
                audio = audio[:, None]
            mel = lambda a: whisper_log_mel(a, pad_to=self.n_frames * 160, num_frames=self.n_frames,
                                            n_mels=self.cfg.encoder.n_mels)
            return [mel(audio[:, i]) for i in range(self.cfg.n_detectors)]

    def _embed_feats(self, encoder, adapters, feats: torch.Tensor) -> torch.Tensor:
        """Q-adapter features (B, D, 80, T*) -> (B, D * d_model), detectors
        folded into the encoder's batch."""
        B, D = feats.shape[:2]
        emb = encode_embedding(self.cfg, encoder, feats.reshape(B * D, *feats.shape[2:]), adapters)
        return emb.reshape(B, D * emb.shape[-1])

    def _apply(self, encoder, head, adapters, qadapter, strain: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.qcfg is not None:
            emb = self._embed_feats(encoder, adapters, qadapter_apply(self.qcfg, qadapter, strain))
            return mlp_head_apply(head, emb, softmax=self.cfg.softmax)
        params = {"encoder": encoder, "head": head}
        mels = self.log_mels(strain)
        if len(mels) == 2:
            return two_channel_apply(self.cfg, params, *mels, adapters, generator)
        return one_channel_apply(self.cfg, params, mels[0], adapters, generator)

    def _train_encoder(self, trainable: dict, frozen: dict):
        return trainable["encoder"] if self.full_finetune else frozen["encoder"]

    def embed(self, trainable: dict, frozen: dict, strain: torch.Tensor) -> torch.Tensor:
        """Pre-head embedding (B, D * d_model): the front end, the encoder per
        detector, concatenated. Differentiable."""
        encoder, adapters = self._train_encoder(trainable, frozen), trainable.get("adapters")
        if self.qcfg is not None:
            return self._embed_feats(encoder, adapters, qadapter_apply(self.qcfg, trainable["qadapter"], strain))
        return torch.cat([encode_embedding(self.cfg, encoder, m, adapters) for m in self.log_mels(strain)], dim=-1)

    def apply(self, trainable: dict, frozen: dict, strain: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """strain -> the head's output (B, num_classes): logits, or the
        MLGWSC-1 head's probabilities. ``generator`` draws the glitch head's
        dropout (``None``: none). Differentiable."""
        return self._apply(self._train_encoder(trainable, frozen), trainable["head"], trainable.get("adapters"),
                           trainable.get("qadapter"), strain, generator)

    def loss_fn(self, trainable: dict, frozen: dict, batch, generator=None):
        """(loss, aux): RegBCE on the MLGWSC-1 head's probabilities, BCE
        with logits on the signal-vs-noise logits (aux: sigmoid scores),
        cross entropy on the glitch logits (aux: the logits)."""
        x, y = batch[0], batch[1]
        out = self.apply(trainable, frozen, x, generator)
        if self.name == "mlgwsc":
            return reg_bce(out, y), {"scores": out[:, 0].detach(), "labels": y[:, 0]}
        if self.name == "glitch":
            return cross_entropy(out, y), {"logits": out.detach(), "labels": y}
        labels = y[:, 0]  # one-hot [1, 0] = wave -> binary target 1
        return bce_with_logits(out, labels), {"scores": torch.sigmoid(out.detach().reshape(-1)), "labels": labels}

    def export_components(self, outdir: str, trainable: dict) -> None:
        """The reference's component files: the peft LoRA directory, the
        head and the Q-adapter, as gwkit writes them."""
        if "adapters" in trainable:
            export_peft_dir(os.path.join(outdir, "best_lora_weights"), trainable["adapters"], self.acfg,
                            self.cfg.encoder.n_layers)
        if "head" in trainable:
            save_pytree(os.path.join(outdir, "best_dense_layers.npz"), trainable["head"])
        if "qadapter" in trainable:
            save_pytree(os.path.join(outdir, "best_adapter.npz"), trainable["qadapter"])

    def _prepared_encoder(self) -> WhisperEncoder:
        """The search's encoder, prepared from the current encoder and
        adapters; prepared anew once any of their tensors was replaced or
        updated in place."""
        p = self.params
        # each leaf's identity and in-place version counter
        key = tuple((id(t), getattr(t, "_version", None)) for t in tree_leaves([p["encoder"], p.get("adapters")]))
        if self._encoder is None or key != self._encoder_key:
            COUNTERS["builds"] += 1
            self._encoder = WhisperEncoder(self.cfg.encoder, p["encoder"], p.get("adapters"))
            self._encoder_key = key
        return self._encoder

    @torch.no_grad()
    def forward(self, strain: torch.Tensor) -> torch.Tensor:
        """strain -> the head's output (B, num_classes) on the prepared
        encoder: USR logits or probabilities (mlgwsc), logits (the mel tasks)."""
        p = self.params
        if self.qcfg is not None:
            return self._forward_feats(qadapter_apply(self.qcfg, p["qadapter"], strain))
        return self._apply(self._prepared_encoder(), p["head"], None, None, strain)

    @torch.no_grad()
    def forward_from_qspec(self, qspec: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` from Q spectrograms (B, D, F, T), as the
        streaming search computes them: Q-adapter CNN, pool and FiLM, then
        the same prepared encoder and head."""
        return self._forward_feats(qadapter_apply_spec(self.qcfg, self.params["qadapter"], qspec))

    def _forward_feats(self, feats: torch.Tensor) -> torch.Tensor:
        """Q-adapter features -> the head's output on the prepared encoder.
        The features are queued first, so the card runs the front end while
        the host checks the encoder's preparation."""
        return mlp_head_apply(self.params["head"], self._embed_feats(self._prepared_encoder(), None, feats),
                              softmax=self.cfg.softmax)

    def score(self, windows: torch.Tensor) -> torch.Tensor:
        """The search statistic: output column 0 for each window (B,)."""
        return self.forward(windows)[:, 0]

    def score_spec(self, qspec: torch.Tensor) -> torch.Tensor:
        """The search statistic from Q spectrograms (B, D, F, T): (B,)."""
        return self.forward_from_qspec(qspec)[:, 0]


def _assemble(cfg: ClassifierConfig, params: Optional[Dict[str, Any]], acfg: AdapterConfig, seed: int,
              full_finetune: bool, device: torch.device, qcfg: Optional[QAdapterConfig] = None):
    """(frozen, trainable) on ``device``: what ``params`` lacks is drawn from
    a generator seeded with ``seed`` (gwkit's init families, not its values)."""
    params = dict(params or {})
    gen = torch.Generator().manual_seed(seed)
    if "encoder" not in params:
        params["encoder"] = init_encoder_params(cfg.encoder, gen)
    if "adapters" not in params and not full_finetune:
        params["adapters"] = init_adapters(cfg.encoder, acfg, params["encoder"], gen)
    if "head" not in params:
        params["head"] = init_head(cfg, gen)
    if qcfg is not None and "qadapter" not in params:
        params["qadapter"] = init_qadapter(qcfg, gen)
    params = tree_to(params, device)
    rest = ("head", "qadapter") if qcfg is not None else ("head",)
    if full_finetune:
        return {}, {k: params[k] for k in ("encoder", *rest)}
    return {"encoder": params["encoder"]}, {k: params[k] for k in ("adapters", *rest)}


def _mel_encoder(encoder: Union[str, WhisperConfig], n_frames: int) -> WhisperConfig:
    """gwkit's short-context rule: below 3000 frames the positional table
    is cut to ``n_frames // 2`` tokens."""
    enc_cfg = encoder if isinstance(encoder, WhisperConfig) else config_for(encoder)
    if n_frames != 3000 and enc_cfg.max_positions > n_frames // 2:
        enc_cfg = dataclasses.replace(enc_cfg, max_positions=n_frames // 2)
    return enc_cfg


def build_signal_vs_noise(encoder: Union[str, WhisperConfig] = "tiny", params: Optional[Dict[str, Any]] = None,
                          acfg: AdapterConfig = DEFAULT_ACFG, num_classes: int = 1,
                          input_sample_rate: int = 2048, n_frames: int = 3000, n_detectors: int = 2,
                          device: DeviceLike = None, seed: int = 42) -> Task:
    """Binary classification on the speech log-mel front end, on ``device``
    (``None``: the CUDA card; raises without one). ``n_detectors=2`` is the
    two-channel H1/L1 model, 1 the single-detector variant with the
    one-channel head. ``n_frames`` < 3000 cuts Whisper's 30 s context (1 s
    of strain fills about 103 mel frames). ``params`` as
    :func:`build_mlgwsc`'s."""
    device = resolve_device(device)
    enc_cfg = _mel_encoder(encoder, n_frames)
    cfg = ClassifierConfig(encoder=enc_cfg, head="two_channel" if n_detectors == 2 else "one_channel",
                           num_classes=num_classes, n_detectors=n_detectors)
    frozen, trainable = _assemble(cfg, params, acfg, seed, False, device)
    return Task("signal_vs_noise", cfg, acfg, frozen, trainable, device, input_sample_rate=input_sample_rate,
                n_frames=n_frames)


def build_glitch(encoder: Union[str, WhisperConfig] = "tiny", params: Optional[Dict[str, Any]] = None,
                 acfg: AdapterConfig = DEFAULT_ACFG, num_classes: int = 11, input_sample_rate: int = 2048,
                 full_finetune: bool = False, n_frames: int = 3000, device: DeviceLike = None,
                 seed: int = 42) -> Task:
    """One-detector multi-class Gravity Spy glitch classification on
    ``device`` (``None``: the CUDA card). The head's dropout (0.3) draws
    from the generator the trainer passes. ``full_finetune`` trains the
    encoder and no adapters."""
    device = resolve_device(device)
    cfg = ClassifierConfig(encoder=_mel_encoder(encoder, n_frames), head="glitch", num_classes=num_classes,
                           n_detectors=1)
    frozen, trainable = _assemble(cfg, params, acfg, seed, full_finetune, device)
    return Task("glitch", cfg, acfg, frozen, trainable, device, full_finetune, input_sample_rate=input_sample_rate,
                n_frames=n_frames)


def build_mlgwsc(encoder: WhisperConfig, qcfg: QAdapterConfig, params: Optional[Dict[str, Any]] = None,
                 usr: bool = True, num_classes: int = 2, device: DeviceLike = None,
                 acfg: AdapterConfig = DEFAULT_ACFG, seed: int = 42, full_finetune: bool = False) -> Task:
    """GWWhisperClassifier on ``device`` (``None``: the CUDA card; raises
    without one). ``params`` may hold any of encoder, adapters, head and
    qadapter (``gwkit_torch.io.from_gwkit_numpy`` layout); what is missing
    is initialized from a generator seeded with ``seed`` (gwkit's init
    families, not its values). ``usr=True`` drops the softmax (the search
    setting); training uses ``usr=False``. ``full_finetune`` trains the
    encoder instead of adapters."""
    device = resolve_device(device)
    cfg = ClassifierConfig(encoder=encoder, head="gwwhisper", num_classes=num_classes,
                           n_detectors=qcfg.n_detectors, softmax=not usr)
    frozen, trainable = _assemble(cfg, params, acfg, seed, full_finetune, device, qcfg)
    return Task("mlgwsc", cfg, acfg, frozen, trainable, device, full_finetune, qcfg=qcfg)
