"""Whisper encoder backbone in PyTorch (counterpart of ``gwkit/models/whisper.py``).

  mel (B, 80, T)
  -> Conv1d(80, d, k=3, s=1, p=1) + GELU
  -> Conv1d(d, d, k=3, s=2, p=1) + GELU      -> (B, T/2, d)
  -> + sinusoidal positions
  -> n_layers pre-LN transformer blocks (q scaled, k bias-free, GELU MLP)
  -> final LayerNorm

Parameters keep gwkit's layout (linear ``w`` (d_in, d_out), conv ``w``
(3, C_in, C_out)); the layers are a Python list of per-layer dicts and run in
a Python loop. With ``cfg.fused_block`` each layer runs the CUDA kernel chain
of :mod:`gwkit_torch.ops.fused_block` (its plain versions on the CPU), with
``cfg.quant_int8`` on int8 projections; otherwise the unfused ``_block``
math, gwkit's default path (where ``quant_int8`` does nothing, as in gwkit),
whose attention runs on kernel A at T >= 1024 with ``cfg.use_flash_attention``
and whose MLP runs on kernel C with ``cfg.fused_mlp``, as gwkit's switches.

Two entry points: :class:`WhisperEncoder` prepares the weights once and
runs without gradients (the search); :func:`encoder_apply` takes the
parameters and adapters on every call and is differentiable (training),
with each fused layer a :class:`~gwkit_torch.ops.fused_block.FusedBlock`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gwkit_torch.device import no_tf32_convs
from gwkit_torch.io import Leaf, tree_to
from gwkit_torch.ops.attention import flash_attention
from gwkit_torch.ops.dora import dora_linear
from gwkit_torch.ops.fused_block import (FusedLayer, fold_layer, fused_encoder_block,
                                         fused_layer_apply)
from gwkit_torch.ops.fused_mlp import _gelu, fused_mlp_block


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    d_model: int = 384
    n_heads: int = 6
    n_layers: int = 4
    d_ff: int = 1536
    max_positions: int = 1500
    compute_dtype: torch.dtype = torch.float32
    use_flash_attention: bool = False  # the unfused layer's attention on kernel A (K1) at T >= 1024
    gelu_approx: bool = False  # tanh GELU (gwkit's TPU setting) instead of erf
    fused_mlp: bool = False  # the unfused layer's MLP on kernel C (ops.fused_mlp)
    fused_block: bool = False  # each layer on the kernel chain (ops.fused_block)
    quant_int8: bool = False  # int8 projections inside the fused layer (inference; needs fused_block)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


PRESETS = {
    "tiny": dict(d_model=384, n_heads=6, n_layers=4, d_ff=1536),
    "base": dict(d_model=512, n_heads=8, n_layers=6, d_ff=2048),
    "small": dict(d_model=768, n_heads=12, n_layers=12, d_ff=3072),
    "medium": dict(d_model=1024, n_heads=16, n_layers=24, d_ff=4096),
    "large": dict(d_model=1280, n_heads=20, n_layers=32, d_ff=5120),
}


def config_for(size: str = "tiny", **overrides) -> WhisperConfig:
    return WhisperConfig(**{**PRESETS[size], **overrides})


def sinusoid_positions(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal position table."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(np.float32)


def param_shapes(cfg: WhisperConfig) -> dict:
    """gwkit's encoder pytree structure (stacked layers) as :class:`Leaf` shapes:
    the template for ``gwkit_torch.io.load_pytree_npz``."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    lin = lambda i, o, bias=True: {"w": Leaf((L, i, o)), **({"b": Leaf((L, o))} if bias else {})}
    ln = lambda: {"g": Leaf((L, d)), "b": Leaf((L, d))}
    return {
        "conv1": {"w": Leaf((3, cfg.n_mels, d)), "b": Leaf((d,))},
        "conv2": {"w": Leaf((3, d, d)), "b": Leaf((d,))},
        "pos": Leaf((cfg.max_positions, d)),
        "layers": {"attn_ln": ln(), "q": lin(d, d), "k": lin(d, d, bias=False), "v": lin(d, d),
                   "o": lin(d, d), "mlp_ln": ln(), "fc1": lin(d, f), "fc2": lin(f, d)},
        "ln_post": {"g": Leaf((d,)), "b": Leaf((d,))},
    }


def init_encoder_params(cfg: WhisperConfig, generator: torch.Generator) -> dict:
    """Random parameters with gwkit's init family (uniform +-1/sqrt(fan_in)),
    drawn from ``generator``: the same distribution, not gwkit's values."""
    d, f = cfg.d_model, cfg.d_ff

    def unif(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    def lin(i, o, bias=True):
        return {"w": unif((i, o), i), **({"b": unif((o,), i)} if bias else {})}

    def ln():
        return {"g": torch.ones(d), "b": torch.zeros(d)}

    layers = [{"attn_ln": ln(), "q": lin(d, d), "k": lin(d, d, bias=False), "v": lin(d, d),
               "o": lin(d, d), "mlp_ln": ln(), "fc1": lin(d, f), "fc2": lin(f, d)}
              for _ in range(cfg.n_layers)]
    return {
        "conv1": {"w": unif((3, cfg.n_mels, d), 3 * cfg.n_mels), "b": unif((d,), 3 * cfg.n_mels)},
        "conv2": {"w": unif((3, d, d), 3 * d), "b": unif((d,), 3 * d)},
        "pos": torch.from_numpy(sinusoid_positions(cfg.max_positions, d)),
        "layers": layers,
        "ln_post": ln(),
    }


def _layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """gwkit's encoder LayerNorm: stats in f32, the normalization itself in
    x's dtype (it subtracts in the compute dtype, unlike the in-kernel LN)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    y = (x - mean.to(x.dtype)) * scale
    return y * p["g"].to(x.dtype) + p["b"].to(x.dtype)


def _proj(x: torch.Tensor, p: dict, adapter: Optional[dict] = None) -> torch.Tensor:
    if adapter is not None:
        return dora_linear(x, p["w"], p.get("b"), adapter)
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def _attention(x: torch.Tensor, p: dict, cfg: WhisperConfig, adapters: Optional[dict]) -> torch.Tensor:
    B, T, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    ad = adapters or {}
    q = (_proj(x, p["q"], ad.get("q")) * hd ** -0.5).reshape(B, T, H, hd)
    k = _proj(x, p["k"], ad.get("k")).reshape(B, T, H, hd)
    v = _proj(x, p["v"], ad.get("v")).reshape(B, T, H, hd)
    if cfg.use_flash_attention and T >= 1024:  # gwkit's switch point: no T x T scores in memory
        o = flash_attention(q, k, v).reshape(B, T, D)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, D)
    return _proj(o, p["o"], ad.get("o"))


def _block(x: torch.Tensor, p: dict, cfg: WhisperConfig, adapters: Optional[dict] = None) -> torch.Tensor:
    """gwkit's unfused layer (whisper.py:181-202); ``p`` and ``adapters``
    already in the compute dtype."""
    h = _layer_norm(x, p["attn_ln"])
    x = x + _attention(h, p, cfg, adapters)
    if cfg.fused_mlp:
        return fused_mlp_block(x, p["mlp_ln"]["g"], p["mlp_ln"]["b"], p["fc1"]["w"], p["fc1"]["b"],
                               p["fc2"]["w"], p["fc2"]["b"], approx=cfg.gelu_approx)
    h = _layer_norm(x, p["mlp_ln"])
    h = _gelu(_proj(h, p["fc1"]), cfg.gelu_approx)
    return x + _proj(h, p["fc2"])


def _conv1d(x: torch.Tensor, p: dict, stride: int) -> torch.Tensor:
    """k=3 'same' conv on (B, C, T) with gwkit's (3, C_in, C_out) weight."""
    with no_tf32_convs():
        return F.conv1d(x, p["w"].permute(2, 1, 0), p["b"], stride=stride, padding=1)


def _encode(cfg: WhisperConfig, params: dict, mel: torch.Tensor, layers: List, run_layer) -> torch.Tensor:
    """Stem, positions, ``run_layer(x, layer)`` for each of ``layers``, final
    LayerNorm; ``params``' stem, pos and ln_post are cast to the compute
    dtype here (a no-op when they already are)."""
    dt = cfg.compute_dtype
    x = mel.to(dt)
    x = _gelu(_conv1d(x, tree_to(params["conv1"], dt), 1), cfg.gelu_approx)
    x = _gelu(_conv1d(x, tree_to(params["conv2"], dt), 2), cfg.gelu_approx)
    x = x.transpose(1, 2)  # (B, T', d)
    x = (x + params["pos"][: x.shape[1]].to(dt)).contiguous()
    for layer in layers:
        x = run_layer(x, layer)
    return _layer_norm(x, tree_to(params["ln_post"], dt))


class WhisperEncoder:
    """The encoder with its weights prepared once for ``cfg``: cast to the
    compute dtype and, with ``cfg.fused_block``, folded for the kernel chain
    (on the weights' device). ``__call__(mel)`` -> (B, T/2, d_model)."""

    def __init__(self, cfg: WhisperConfig, params: dict, adapters: Optional[List[dict]] = None):
        dt = cfg.compute_dtype
        self.cfg = cfg
        self.params = {name: tree_to(params[name], dt) for name in ("conv1", "conv2", "pos", "ln_post")}
        ads = adapters if adapters is not None else [None] * len(params["layers"])
        if cfg.fused_block:
            self.layers: List = [fold_layer(p, a, cfg.n_heads, dt, quant=cfg.quant_int8)
                                 for p, a in zip(params["layers"], ads)]
        else:
            self.layers = [(tree_to(p, dt), tree_to(a, dt) if a else None)
                           for p, a in zip(params["layers"], ads)]

    def _layer(self, x: torch.Tensor, layer) -> torch.Tensor:
        if isinstance(layer, FusedLayer):
            return fused_layer_apply(x, layer, approx=self.cfg.gelu_approx)
        return _block(x, layer[0], self.cfg, layer[1])

    @torch.no_grad()
    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        return _encode(self.cfg, self.params, mel, self.layers, self._layer)


def encoder_apply(cfg: WhisperConfig, params: dict, mel: torch.Tensor,
                  adapters: Optional[List[dict]] = None) -> torch.Tensor:
    """Whisper encoder forward, differentiable in the parameters and the
    per-layer ``adapters``: mel (B, n_mels, T) -> (B, T/2, d_model).

    Everything is cast to the compute dtype on every call, as gwkit's
    ``encoder_apply`` casts it (so gradients reach the f32 leaves); with
    ``cfg.fused_block`` each layer folds the current adapters and runs on
    the kernel chain. Search callers keep a :class:`WhisperEncoder`."""
    dt = cfg.compute_dtype

    def run_layer(x, layer):
        p, a = tree_to(layer[0], dt), (tree_to(layer[1], dt) if layer[1] else None)
        if cfg.fused_block:
            return fused_encoder_block(x, p, cfg.n_heads, a, approx=cfg.gelu_approx, quant=cfg.quant_int8)
        return _block(x, p, cfg, a)

    ads = adapters if adapters is not None else [None] * len(params["layers"])
    return _encode(cfg, params, mel, list(zip(params["layers"], ads)), run_layer)
