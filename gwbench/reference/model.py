"""Whisper encoder with DoRA, the Q-adapter and the MLP head in plain
float32 torch, with TF32 off for products and convolutions.

Weights keep gwkit's right-multiplied layout: a linear ``w`` is (d_in,
d_out), a conv1d ``w`` (3, C_in, C_out), a conv2d ``w`` HWIO. DoRA's
effective weight is formed explicitly:
W = m * (W0 + s A B) / ||W0 + s A B||_col, the norm over d_in.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_f32():
    """float32 products and convolutions without TF32 for the duration."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[0], prev[1]
        torch.set_float32_matmul_precision(prev[2])


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's positional table: sin then cos over log-spaced timescales."""
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32))


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude at e4m3's largest, 448), back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def dora_weight(w0: torch.Tensor, ad: dict) -> torch.Tensor:
    w = w0 + float(ad["scaling"]) * (ad["a"] @ ad["b"])
    return w * (ad["m"] / torch.linalg.vector_norm(w, dim=0))


def tensors(tree, device):
    """numpy or torch leaves -> float32 tensors on ``device`` (scalars kept)."""
    if isinstance(tree, dict):
        return {k: tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tensors(v, device) for v in tree]
    if isinstance(tree, float):
        return tree
    return torch.as_tensor(np.asarray(tree) if not isinstance(tree, torch.Tensor) else tree).to(
        device=device, dtype=torch.float32)


class Encoder:
    """The encoder in float32 with each layer's DoRA projections folded into
    effective weights here. ``enc``: conv1/conv2 {"w", "b"}, ln_post {"g",
    "b"}, ``layers``: [{"attn_ln": {"g", "b"}, "q"/"k"/"v"/"o": {"w"[, "b"]},
    "mlp_ln", "fc1", "fc2"}]; ``adapters``: per layer {proj: {"a", "b", "m",
    "scaling"}} or None.

    ``precision`` "f32" is the reference. "bf16" rounds both operands of
    every product (projections, attention's q k^T and p v, the MLP) and the
    residual stream after each addition to bfloat16 (products still
    accumulate in float32): the reference's own bfloat16 error, which the
    classifier's comparison is measured in. "fp8" rounds both to float8
    e4m3 instead: the precision control, the step below the configuration's
    bfloat16."""

    def __init__(self, enc: dict, adapters: Optional[List[dict]], heads: int, gelu: str, device,
                 precision: str = "f32"):
        self.device, self.heads = device, heads
        same = lambda t: t  # noqa: E731
        self.round, self.store = {"f32": (same, same), "bf16": (bf16, bf16), "fp8": (fp8, fp8)}[precision]
        self.approx = "tanh" if gelu == "tanh" else "none"
        enc = tensors(enc, device)
        self.stem = (enc["conv1"], enc["conv2"])
        self.ln_post = enc["ln_post"]
        self.layers = []
        with exact_f32():
            for i, p in enumerate(enc["layers"]):
                ad = tensors(adapters[i], device) if adapters else {}
                w = {proj: dora_weight(p[proj]["w"], ad[proj]) if proj in ad else p[proj]["w"]
                     for proj in ("q", "k", "v", "o")}
                w.update(fc1=p["fc1"]["w"], fc2=p["fc2"]["w"])
                self.layers.append((p, {k: self.round(v) for k, v in w.items()}))

    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, n_mels, frames) -> (B, frames / 2, d_model)."""
        with exact_f32():
            c1, c2 = self.stem
            x = F.gelu(F.conv1d(mel.float(), c1["w"].permute(2, 1, 0), c1["b"], padding=1), approximate=self.approx)
            x = F.gelu(F.conv1d(x, c2["w"].permute(2, 1, 0), c2["b"], stride=2, padding=1), approximate=self.approx)
            x = x.transpose(1, 2)
            B, T, d = x.shape
            r, st = self.round, self.store
            x = st(x + sinusoids(T, d).to(x.device))
            hd = d // self.heads
            for p, w in self.layers:
                h = r(F.layer_norm(x, (d,), p["attn_ln"]["g"], p["attn_ln"]["b"], 1e-5))
                q = r((h @ w["q"] + p["q"]["b"]) * hd ** -0.5).reshape(B, T, self.heads, hd).transpose(1, 2)
                k = r(h @ w["k"]).reshape(B, T, self.heads, hd).transpose(1, 2)
                v = r(h @ w["v"] + p["v"]["b"]).reshape(B, T, self.heads, hd).transpose(1, 2)
                att = r(torch.softmax(q @ k.transpose(-1, -2), dim=-1)) @ v
                x = st(x + r(att.transpose(1, 2).reshape(B, T, d)) @ w["o"] + p["o"]["b"])
                h = r(F.layer_norm(x, (d,), p["mlp_ln"]["g"], p["mlp_ln"]["b"], 1e-5))
                h = F.gelu(h @ w["fc1"] + p["fc1"]["b"], approximate=self.approx)
                x = st(x + r(h) @ w["fc2"] + p["fc2"]["b"])
            return F.layer_norm(x, (d,), self.ln_post["g"], self.ln_post["b"], 1e-5)


def mlp_head(head: List[Dict[str, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
    """ReLU between the layers, none after the last (logits)."""
    with exact_f32():
        for i, p in enumerate(head):
            x = x @ p["w"] + p["b"]
            if i < len(head) - 1:
                x = torch.relu(x)
        return x


def qadapter(p: dict, qspec: torch.Tensor, target: tuple) -> torch.Tensor:
    """(B, D, F, T) Q spectrograms -> (B, D, *target) features: three 3x3
    convolutions with ReLU (max-pool 2 after the first two), a 1x1 to one
    channel, adaptive average pooling to ``target``, the affine
    scale/bias and the per-detector FiLM."""
    B, D = qspec.shape[:2]
    conv = lambda x, c, pad: F.conv2d(x, c["w"].permute(3, 2, 0, 1), c["b"], padding=pad)
    with exact_f32():
        x = qspec.reshape(B * D, 1, *qspec.shape[2:]).float()
        x = F.max_pool2d(torch.relu(conv(x, p["conv1"], 1)), 2)
        x = F.max_pool2d(torch.relu(conv(x, p["conv2"], 1)), 2)
        x = torch.relu(conv(x, p["conv3"], 1))
        x = conv(x, p["conv4"], 0)
        x = F.adaptive_avg_pool2d(x, tuple(target))[:, 0]
        x = (p["scale"] * x + p["bias"]).reshape(B, D, *target)
        return x * p["film_gamma"][None, :, None, None] + p["film_beta"][None, :, None, None]
