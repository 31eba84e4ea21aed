"""Classifier assembly (counterpart of ``gwkit/models/classifier.py``):
the encoder's pooled embedding that feeds the head."""
from __future__ import annotations

import dataclasses

import torch

from gwkit_torch.models.whisper import WhisperConfig


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    encoder: WhisperConfig
    head: str = "gwwhisper"
    num_classes: int = 2
    n_detectors: int = 2
    pool: str = "last"  # "last" (reference default) | "mean"
    softmax: bool = False  # False: USR logits (the search setting)


def _pool(seq: torch.Tensor, how: str) -> torch.Tensor:
    return seq[:, -1, :] if how == "last" else seq.mean(dim=1)


def encode_embedding(cfg: ClassifierConfig, encoder, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, 80, T) -> pooled embedding (B, d_model) in float32.
    ``encoder`` is a prepared :class:`gwkit_torch.models.whisper.WhisperEncoder`."""
    return _pool(encoder(mel), cfg.pool).float()
