"""Classifier assembly (counterpart of ``gwkit/models/classifier.py``):
the head's init and the encoder's pooled embedding that feeds it."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import torch

from gwkit_torch.models.heads import HEAD_WIDTHS, init_mlp_head
from gwkit_torch.models.whisper import WhisperConfig, WhisperEncoder, encoder_apply


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    encoder: WhisperConfig
    head: str = "gwwhisper"
    num_classes: int = 2
    n_detectors: int = 2
    pool: str = "last"  # "last" (reference default) | "mean"
    softmax: bool = False  # False: USR logits (the search setting)


def init_head(cfg: ClassifierConfig, generator: torch.Generator) -> List[dict]:
    """The MLP head for ``cfg`` (the CNN head is not ported)."""
    d_in = cfg.encoder.d_model * (cfg.n_detectors if cfg.head in ("two_channel", "gwwhisper") else 1)
    return init_mlp_head(d_in, HEAD_WIDTHS[cfg.head], cfg.num_classes, generator)


def _pool(seq: torch.Tensor, how: str) -> torch.Tensor:
    return seq[:, -1, :] if how == "last" else seq.mean(dim=1)


def encode_embedding(cfg: ClassifierConfig, encoder: Union[WhisperEncoder, dict], mel: torch.Tensor,
                     adapters: Optional[List[dict]] = None) -> torch.Tensor:
    """mel (B, 80, T) -> pooled embedding (B, d_model) in float32.

    ``encoder`` is a prepared :class:`WhisperEncoder` (search, no
    gradients; it holds its adapters) or the encoder's parameters, run by
    the differentiable :func:`encoder_apply` with ``adapters``."""
    seq = encoder(mel) if isinstance(encoder, WhisperEncoder) else \
        encoder_apply(cfg.encoder, encoder, mel, adapters)
    return _pool(seq, cfg.pool).float()
