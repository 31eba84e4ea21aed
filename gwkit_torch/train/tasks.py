"""The MLGWSC-1 search task, forward only (counterpart of
``gwkit/train/tasks.py::build_mlgwsc`` with ``usr=True``).

  strain (B, D, T @ 2048 Hz) -> Q-adapter -> detectors folded into the batch
  -> Whisper encoder (+DoRA) -> last token -> (B, D * d_model) -> MLP head

Training waits for a later slice of the port: this builds the forward from
given parameters (``gwkit_torch.io.from_gwkit_numpy`` layout).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from gwkit_torch.device import DeviceLike, resolve_device
from gwkit_torch.io import tree_to
from gwkit_torch.models.classifier import ClassifierConfig, encode_embedding
from gwkit_torch.models.heads import mlp_head_apply
from gwkit_torch.models.qadapter import QAdapterConfig, qadapter_apply
from gwkit_torch.models.whisper import WhisperConfig, WhisperEncoder


@dataclasses.dataclass
class Task:
    name: str
    cfg: ClassifierConfig
    qcfg: QAdapterConfig
    params: Dict[str, Any]  # encoder, adapters, head, qadapter on ``device``
    encoder: WhisperEncoder
    device: torch.device

    @torch.no_grad()
    def forward(self, strain: torch.Tensor) -> torch.Tensor:
        """strain (B, D, T) -> logits (USR) or probabilities (B, num_classes)."""
        B = strain.shape[0]
        D = self.qcfg.n_detectors
        feats = qadapter_apply(self.qcfg, self.params["qadapter"], strain)  # (B, D, 80, T*)
        emb = encode_embedding(self.cfg, self.encoder, feats.reshape(B * D, *feats.shape[2:]))
        return mlp_head_apply(self.params["head"], emb.reshape(B, D * emb.shape[-1]),
                              softmax=self.cfg.softmax)

    def score(self, windows: torch.Tensor) -> torch.Tensor:
        """The search statistic: output column 0 for each window (B,)."""
        return self.forward(windows)[:, 0]


def build_mlgwsc(encoder: WhisperConfig, qcfg: QAdapterConfig, params: Dict[str, Any],
                 usr: bool = True, num_classes: int = 2,
                 device: DeviceLike = None) -> Task:
    """GWWhisperClassifier forward on ``device``; ``usr=True`` drops the
    softmax (unbounded-score mode, the search setting). The encoder's
    weights are cast and, for the kernel path, folded here, once.
    ``device=None`` is the CUDA card (raises without one)."""
    device = resolve_device(device)
    cfg = ClassifierConfig(encoder=encoder, head="gwwhisper", num_classes=num_classes,
                           n_detectors=qcfg.n_detectors, softmax=not usr)
    params = tree_to(params, device)
    enc = WhisperEncoder(encoder, params["encoder"], params.get("adapters"))
    return Task("mlgwsc", cfg, qcfg, params, enc, device)
