"""The classifier's plain reference at the encoder's own number of mel
bins (``num_mel_bins`` of the configuration: 128 for whisper-large-v3):
strain -> log-mel per detector (``reference.mel_bins``) -> the encoder with
DoRA (``reference.model.Encoder``, both detectors) -> last tokens
concatenated -> the MLP head's logits (``reference.model.mlp_head``); as
``reference.classify`` at 80 bins."""
from __future__ import annotations

import numpy as np
import torch

from gwbench.reference.mel_bins import features
from gwbench.reference.model import Encoder, exact_f32, mlp_head, tensors


class ClassifierReference:
    def __init__(self, cfg: dict, weights: dict, device, chunk: int = 8, precision: str = "f32"):
        self.device, self.chunk, self.frames, self.n_mels = device, chunk, cfg["n_frames"], cfg["num_mel_bins"]
        enc = {k: v for k, v in weights["encoder"].items() if k != "pos"}
        self.encoder = Encoder(enc, weights["adapters"], cfg["encoder_attention_heads"], cfg["gelu"], device, precision)
        self.head = tensors(weights["head"], device)

    def logits(self, strain: np.ndarray, rate: int) -> np.ndarray:
        """(B, D, n) host strain -> (B * num_classes,) float64 logits."""
        return self.forward(torch.from_numpy(strain).to(self.device), rate).double().cpu().numpy().reshape(-1)

    @torch.no_grad()
    def embed(self, x: torch.Tensor, rate: int = 2048) -> torch.Tensor:
        """(B, D, n) strain on the device -> (B, D * d_model): each detector's
        last token, concatenated (what the head reads)."""
        B, D, n = x.shape
        with exact_f32():
            embs = []
            for d in range(D):
                rows = []
                for i in range(0, B, self.chunk):
                    mel = features(x[i: i + self.chunk, d], rate, self.n_mels, self.frames)
                    rows.append(self.encoder(mel)[:, -1, :])
                embs.append(torch.cat(rows))
            return torch.cat(embs, dim=-1)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, rate: int = 2048) -> torch.Tensor:
        """(B, D, n) strain on the device -> (B, num_classes) logits."""
        return mlp_head(self.head, self.embed(x, rate))
