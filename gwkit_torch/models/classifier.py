"""Classifier assembly (counterpart of ``gwkit/models/classifier.py``):
front end -> Whisper encoder (+DoRA) -> head.

  * two-channel signal-vs-noise: both detectors in one encoder call
    stacked on the batch axis, the embeddings concatenated (MLP head) or
    stacked (CNN head);
  * one-channel binary and the glitch classifier (dropout 0.3 in training);
  * the ``*_from_audio`` forms with the log-mel front end on the device;
  * the baseline flattened-mel MLP.

``params["encoder"]`` is the encoder's parameters (differentiable, run by
:func:`encoder_apply` with ``adapters``) or a prepared
:class:`WhisperEncoder` (no gradients; it holds its adapters). Dropout
draws come from ``generator`` (``None``: inference, no dropout).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import torch

from gwkit_torch.models.heads import (HEAD_DROPOUT, HEAD_WIDTHS, cnn_head_apply, init_cnn_head,
                                      init_mlp_head, mlp_head_apply)
from gwkit_torch.models.whisper import WhisperConfig, WhisperEncoder, encoder_apply
from gwkit_torch.ops.mel import whisper_log_mel
from gwkit_torch.utils.tracing import annotate


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    encoder: WhisperConfig
    head: str = "gwwhisper"  # a key of HEAD_WIDTHS, or "cnn"
    num_classes: int = 2
    n_detectors: int = 2
    pool: str = "last"  # "last" (reference default) | "mean"
    softmax: bool = False  # False: USR logits (the search setting)


def init_head(cfg: ClassifierConfig, generator: torch.Generator):
    """The head for ``cfg``: the CNN head, or the MLP head of its widths."""
    if cfg.head == "cnn":
        return init_cnn_head(cfg.num_classes, generator)
    d_in = cfg.encoder.d_model * (cfg.n_detectors if cfg.head in ("two_channel", "gwwhisper") else 1)
    return init_mlp_head(d_in, HEAD_WIDTHS[cfg.head], cfg.num_classes, generator)


def _pool(seq: torch.Tensor, how: str) -> torch.Tensor:
    return seq[:, -1, :] if how == "last" else seq.mean(dim=1)


def encode_embedding(cfg: ClassifierConfig, encoder: Union[WhisperEncoder, dict], mel: torch.Tensor,
                     adapters: Optional[List[dict]] = None) -> torch.Tensor:
    """mel (B, 80, T) -> pooled embedding (B, d_model) in float32."""
    with annotate("gw.encoder"):
        seq = encoder(mel) if isinstance(encoder, WhisperEncoder) else \
            encoder_apply(cfg.encoder, encoder, mel, adapters)
        return _pool(seq, cfg.pool).float()


def _mlp(cfg: ClassifierConfig, head, emb: torch.Tensor, generator) -> torch.Tensor:
    return mlp_head_apply(head, emb, dropout_rate=HEAD_DROPOUT.get(cfg.head, 0.0), generator=generator,
                          softmax=cfg.softmax)


def two_channel_apply(cfg: ClassifierConfig, params: dict, mel0: torch.Tensor, mel1: torch.Tensor,
                      adapters: Optional[List[dict]] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Two-detector classifier on mel features -> logits (B, num_classes);
    both detectors run through one encoder call, stacked on the batch axis."""
    B = mel0.shape[0]
    both = encode_embedding(cfg, params["encoder"], torch.cat([mel0, mel1], dim=0), adapters)
    e0, e1 = both[:B], both[B:]
    if cfg.head == "cnn":
        return cnn_head_apply(params["head"], torch.stack([e0, e1], dim=1))
    return _mlp(cfg, params["head"], torch.cat([e0, e1], dim=-1), generator)


def one_channel_apply(cfg: ClassifierConfig, params: dict, mel: torch.Tensor,
                      adapters: Optional[List[dict]] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return _mlp(cfg, params["head"], encode_embedding(cfg, params["encoder"], mel, adapters), generator)


def two_channel_from_audio(cfg: ClassifierConfig, params: dict, audio0: torch.Tensor, audio1: torch.Tensor,
                           adapters: Optional[List[dict]] = None,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """16 kHz audio (B, N) per detector -> logits, the log-mel front end on
    the audio's device."""
    return two_channel_apply(cfg, params, whisper_log_mel(audio0), whisper_log_mel(audio1), adapters, generator)


def one_channel_from_audio(cfg: ClassifierConfig, params: dict, audio: torch.Tensor,
                           adapters: Optional[List[dict]] = None,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return one_channel_apply(cfg, params, whisper_log_mel(audio), adapters, generator)


def baseline_apply(params: List[dict], mel0: torch.Tensor, mel1: torch.Tensor) -> torch.Tensor:
    """BaselineModel: both mels flattened and concatenated, then an MLP."""
    flat = torch.cat([mel0.reshape(mel0.shape[0], -1), mel1.reshape(mel1.shape[0], -1)], dim=-1)
    return mlp_head_apply(params, flat)
