"""The MLGWSC-1 task (counterpart of ``gwkit/train/tasks.py::build_mlgwsc``).

  strain (B, D, T @ 2048 Hz) -> Q-adapter -> detectors folded into the batch
  -> Whisper encoder (+DoRA) -> last token -> (B, D * d_model) -> MLP head
  [-> softmax]

A :class:`Task` holds gwkit's split: ``frozen`` (the encoder) and
``trainable`` (adapters, head, Q-adapter; with ``full_finetune`` the
encoder, head and Q-adapter and no adapters). ``apply``, ``loss_fn`` and
``embed`` take the two trees on every call and are differentiable (the
trainer's surface); ``forward`` and ``score`` are the search's, and
``forward_from_qspec`` and ``score_spec`` the streaming search's (from Q
spectrograms), without gradients, on one encoder prepared (folded for the
kernel chain) from the current encoder and adapters, and prepared anew
once any of their tensors is replaced or updated in place (as a trainer's
step does).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import torch

from gwkit_torch.device import DeviceLike, resolve_device
from gwkit_torch.io import tree_leaves, tree_to
from gwkit_torch.models.adapters import AdapterConfig, export_peft_dir, init_adapters
from gwkit_torch.models.classifier import ClassifierConfig, encode_embedding, init_head
from gwkit_torch.models.heads import mlp_head_apply
from gwkit_torch.models.qadapter import (QAdapterConfig, init_qadapter, qadapter_apply,
                                         qadapter_apply_spec)
from gwkit_torch.models.whisper import WhisperConfig, WhisperEncoder, init_encoder_params
from gwkit_torch.train.checkpoints import save_pytree
from gwkit_torch.train.losses import reg_bce


@dataclasses.dataclass
class Task:
    name: str
    cfg: ClassifierConfig
    qcfg: QAdapterConfig
    acfg: AdapterConfig
    frozen: Dict[str, Any]
    trainable: Dict[str, Any]
    device: torch.device
    full_finetune: bool = False
    _encoder: Optional[WhisperEncoder] = dataclasses.field(default=None, repr=False)
    _encoder_key: tuple = dataclasses.field(default=(), repr=False)

    @property
    def params(self) -> Dict[str, Any]:
        """encoder, adapters, head and Q-adapter, wherever they sit."""
        return {**self.frozen, **self.trainable}

    def _embed(self, qadapter: dict, encoder, adapters, strain: torch.Tensor) -> torch.Tensor:
        return self._embed_feats(encoder, adapters, qadapter_apply(self.qcfg, qadapter, strain))

    def _embed_feats(self, encoder, adapters, feats: torch.Tensor) -> torch.Tensor:
        """Q-adapter features (B, D, 80, T*) -> (B, D * d_model), detectors
        folded into the encoder's batch."""
        B, D = feats.shape[:2]
        emb = encode_embedding(self.cfg, encoder, feats.reshape(B * D, *feats.shape[2:]), adapters)
        return emb.reshape(B, D * emb.shape[-1])

    def embed(self, trainable: dict, frozen: dict, strain: torch.Tensor) -> torch.Tensor:
        """Pre-head embedding (B, D * d_model): Q-adapter -> encoder per
        detector (folded into the batch) -> concat. Differentiable."""
        encoder = trainable["encoder"] if self.full_finetune else frozen["encoder"]
        return self._embed(trainable["qadapter"], encoder, trainable.get("adapters"), strain)

    def apply(self, trainable: dict, frozen: dict, strain: torch.Tensor) -> torch.Tensor:
        """strain (B, D, T) -> probabilities or USR logits (B, num_classes). Differentiable."""
        return mlp_head_apply(trainable["head"], self.embed(trainable, frozen, strain),
                              softmax=self.cfg.softmax)

    def loss_fn(self, trainable: dict, frozen: dict, batch, generator=None):
        """RegBCE on the head's probabilities: (loss, aux)."""
        x, y = batch[0], batch[1]
        probs = self.apply(trainable, frozen, x)
        return reg_bce(probs, y), {"scores": probs[:, 0].detach(), "labels": y[:, 0]}

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
            self._encoder = WhisperEncoder(self.cfg.encoder, p["encoder"], p.get("adapters"))
            self._encoder_key = key
        return self._encoder

    @torch.no_grad()
    def forward(self, strain: torch.Tensor) -> torch.Tensor:
        """The search forward: strain (B, D, T) -> logits (USR) or
        probabilities (B, num_classes), on the prepared encoder."""
        p = self.params
        return mlp_head_apply(p["head"], self._embed(p["qadapter"], self._prepared_encoder(), None, strain),
                              softmax=self.cfg.softmax)

    @torch.no_grad()
    def forward_from_qspec(self, qspec: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` from Q spectrograms (B, D, F, T), as the
        streaming search computes them: Q-adapter CNN, pool and FiLM, then
        the same prepared encoder and head."""
        p = self.params
        feats = qadapter_apply_spec(self.qcfg, p["qadapter"], qspec)
        return mlp_head_apply(p["head"], self._embed_feats(self._prepared_encoder(), None, feats),
                              softmax=self.cfg.softmax)

    def score(self, windows: torch.Tensor) -> torch.Tensor:
        """The search statistic: output column 0 for each window (B,)."""
        return self.forward(windows)[:, 0]

    def score_spec(self, qspec: torch.Tensor) -> torch.Tensor:
        """The search statistic from Q spectrograms (B, D, F, T): (B,)."""
        return self.forward_from_qspec(qspec)[:, 0]


def build_mlgwsc(encoder: WhisperConfig, qcfg: QAdapterConfig, params: Optional[Dict[str, Any]] = None,
                 usr: bool = True, num_classes: int = 2, device: DeviceLike = None,
                 acfg: AdapterConfig = AdapterConfig(r=8, alpha=32, use_dora=True, targets="qkvo"),
                 seed: int = 42, full_finetune: bool = False) -> Task:
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
    params = dict(params or {})
    gen = torch.Generator().manual_seed(seed)
    if "encoder" not in params:
        params["encoder"] = init_encoder_params(encoder, gen)
    if "adapters" not in params and not full_finetune:
        params["adapters"] = init_adapters(encoder, acfg, params["encoder"], gen)
    if "head" not in params:
        params["head"] = init_head(cfg, gen)
    if "qadapter" not in params:
        params["qadapter"] = init_qadapter(qcfg, gen)
    params = tree_to(params, device)
    if full_finetune:
        frozen = {}
        trainable = {k: params[k] for k in ("encoder", "head", "qadapter")}
    else:
        frozen = {"encoder": params["encoder"]}
        trainable = {k: params[k] for k in ("adapters", "head", "qadapter")}
    return Task("mlgwsc", cfg, qcfg, acfg, frozen, trainable, device, full_finetune)
