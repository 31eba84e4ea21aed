"""Whisper encoder backbone in PyTorch (counterpart of ``gwkit/models/whisper.py``).

  mel (B, n_mels, T)            (80 bins; 128 for large-v3)
  -> Conv1d(n_mels, d, k=3, s=1, p=1) + GELU
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

Under a model mesh (``gwkit_torch.parallel.mesh``; layers holding this
rank's slices, run inside ``with active(mesh)``) the unfused layer is
Megatron tensor parallelism with explicit collectives, and the kernel chain
takes the layer's weights gathered at its boundary.

Two entry points: :class:`WhisperEncoder` prepares the weights once and
runs without gradients (the search); :func:`encoder_apply` takes the
parameters and adapters on every call and is differentiable (training),
with each fused layer a :class:`~gwkit_torch.ops.fused_block.FusedBlock`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gwkit_torch.device import no_tf32_convs
from gwkit_torch.io import Leaf, tree_to
from gwkit_torch.ops.attention import flash_attention
from gwkit_torch.ops.dora import dora_linear, dora_norms_sq
from gwkit_torch.ops.fused_block import (FusedLayer, fold_layer, fused_encoder_block,
                                         fused_layer_apply)
from gwkit_torch.ops.fused_mlp import _gelu, fused_mlp_block
from gwkit_torch.parallel.mesh import (Mesh, copy_to_model, current_mesh, gather_layer, gather_model,
                                       model_sum_, reduce_from_model)

Params = Dict[str, Any]  # an encoder's parameter tree (:func:`init_encoder_params`'s layout)


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
    "large": dict(d_model=1280, n_heads=20, n_layers=32, d_ff=5120),  # large-v1 and v2
    "large-v3": dict(d_model=1280, n_heads=20, n_layers=32, d_ff=5120, n_mels=128),
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
    hd = cfg.head_dim
    ad = adapters or {}
    q = (_proj(x, p["q"], ad.get("q")) * hd ** -0.5).reshape(B, T, -1, hd)
    k = _proj(x, p["k"], ad.get("k")).reshape(B, T, -1, hd)
    v = _proj(x, p["v"], ad.get("v")).reshape(B, T, -1, hd)
    return _proj(_attention_core(q, k, v, cfg, x.dtype), p["o"], ad.get("o"))


def _attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: WhisperConfig,
                    dtype: torch.dtype) -> torch.Tensor:
    """softmax(q k^T) v over (B, T, heads, hd) -> (B, T, heads * hd)."""
    B, T = q.shape[:2]
    if cfg.use_flash_attention and T >= 1024:  # gwkit's switch point: no T x T scores in memory
        return flash_attention(q, k, v).reshape(B, T, -1)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, -1)


def _model_shards(p: dict, cfg: WhisperConfig) -> int:
    """Into how many slices the layer's heads are split (1: a whole layer)."""
    return cfg.d_model // p["q"]["w"].shape[-1]


def _layer_mesh(p: dict, cfg: WhisperConfig) -> Optional[Mesh]:
    """The active mesh when ``p`` is a model-sharded layer, else None."""
    n = _model_shards(p, cfg)
    if n == 1:
        return None
    mesh = current_mesh()
    if mesh is None or mesh.n_model != n:
        raise RuntimeError(f"a layer split {n} ways runs inside `with active(mesh)` of a mesh "
                           f"with {n} model ranks")
    return mesh


def _tp_column(h: torch.Tensor, p: dict, adapter: Optional[dict], mesh: Mesh) -> torch.Tensor:
    """A projection whose d_out is split over "model" (q, k, v): each rank
    its columns. ``h`` has passed :func:`copy_to_model`; so do the adapter's
    replicated ``a`` and ``scaling``, whose gradients sum over the ranks'
    columns. DoRA's column norms need no collective (d_in is whole)."""
    if adapter is None:
        return _proj(h, p)
    adapter = {**adapter, "a": copy_to_model(adapter["a"], mesh)}
    if isinstance(adapter.get("scaling"), torch.Tensor):
        adapter["scaling"] = copy_to_model(adapter["scaling"], mesh)
    return dora_linear(h, p["w"], p.get("b"), adapter)


def _tp_row(h: torch.Tensor, p: dict, adapter: Optional[dict], mesh: Mesh) -> torch.Tensor:
    """A projection whose d_in is split over "model" (o, fc2): the ranks'
    partial sums are reduced with one ``all_reduce``, then DoRA's scale (its
    squared column norms are partial sums too, reduced before the square
    root; y is linear, so the scale goes after the sum) and the bias, each
    once."""
    y = h @ p["w"]
    if adapter is not None:
        s = adapter.get("scaling", 1.0)
        if isinstance(s, torch.Tensor):
            s = copy_to_model(s, mesh)
        y = y + s * ((h @ adapter["a"]) @ copy_to_model(adapter["b"], mesh))
    y = reduce_from_model(y, mesh)
    if adapter is not None and "m" in adapter:
        with torch.no_grad():
            norm_sq = model_sum_(dora_norms_sq(p["w"], adapter["a"], adapter["b"],
                                               adapter.get("scaling", 1.0)), mesh)
            norms = torch.sqrt(torch.clamp(norm_sq, min=1e-12))
        y = y * (adapter["m"].float() / norms).to(y.dtype)
    return y + p["b"] if "b" in p else y


def _tp_block(x: torch.Tensor, p: dict, cfg: WhisperConfig, adapters: Optional[dict],
              mesh: Mesh) -> torch.Tensor:
    """gwkit's unfused layer under a model mesh, the layout GSPMD gives it
    (Megatron): this rank's n_heads / n_model heads and fc1 columns; one
    all_reduce after o and one after fc2. With ``cfg.fused_mlp`` kernel C
    takes the gathered fc1/fc2 weights."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    ad = adapters or {}
    h = copy_to_model(_layer_norm(x, p["attn_ln"]), mesh)
    q = (_tp_column(h, p["q"], ad.get("q"), mesh) * hd ** -0.5).reshape(B, T, -1, hd)
    k = _tp_column(h, p["k"], ad.get("k"), mesh).reshape(B, T, -1, hd)
    v = _tp_column(h, p["v"], ad.get("v"), mesh).reshape(B, T, -1, hd)
    x = x + _tp_row(_attention_core(q, k, v, cfg, x.dtype), p["o"], ad.get("o"), mesh)
    if cfg.fused_mlp:
        g = lambda t, axis: gather_model(t, axis, mesh)
        return fused_mlp_block(x, p["mlp_ln"]["g"], p["mlp_ln"]["b"], g(p["fc1"]["w"], 1), g(p["fc1"]["b"], 0),
                               g(p["fc2"]["w"], 0), p["fc2"]["b"], approx=cfg.gelu_approx)
    h = copy_to_model(_layer_norm(x, p["mlp_ln"]), mesh)
    h = _gelu(_proj(h, p["fc1"]), cfg.gelu_approx)
    return x + _tp_row(h, p["fc2"], None, mesh)


def _block(x: torch.Tensor, p: dict, cfg: WhisperConfig, adapters: Optional[dict] = None) -> torch.Tensor:
    """gwkit's unfused layer (whisper.py:181-202); ``p`` and ``adapters``
    already in the compute dtype. A model-sharded layer runs
    :func:`_tp_block` on the active mesh."""
    mesh = _layer_mesh(p, cfg)
    if mesh is not None:
        return _tp_block(x, p, cfg, adapters, mesh)
    h = _layer_norm(x, p["attn_ln"])
    x = x + _attention(h, p, cfg, adapters)
    if cfg.fused_mlp:
        return fused_mlp_block(x, p["mlp_ln"]["g"], p["mlp_ln"]["b"], p["fc1"]["w"], p["fc1"]["b"],
                               p["fc2"]["w"], p["fc2"]["b"], approx=cfg.gelu_approx)
    h = _layer_norm(x, p["mlp_ln"])
    h = _gelu(_proj(h, p["fc1"]), cfg.gelu_approx)
    return x + _proj(h, p["fc2"])


def _whole_layer(p: dict, adapters: Optional[dict], cfg: WhisperConfig):
    """A layer's full weights and adapters for the kernel chain, gathered
    over "model" when the layer is sharded (gwkit's fused kernel under a mesh
    likewise gathers at its boundary; the batch stays split over "data")."""
    mesh = _layer_mesh(p, cfg)
    return (p, adapters) if mesh is None else gather_layer(mesh, p, adapters)


def _conv1d(x: torch.Tensor, p: dict, stride: int) -> torch.Tensor:
    """k=3 'same' conv on (B, C, T) with gwkit's (3, C_in, C_out) weight."""
    with no_tf32_convs():
        return F.conv1d(x, p["w"].permute(2, 1, 0), p["b"], stride=stride, padding=1)


def _encode(cfg: WhisperConfig, params: Params, mel: torch.Tensor, layers: List, run_layer) -> torch.Tensor:
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

    def __init__(self, cfg: WhisperConfig, params: Params, adapters: Optional[List[dict]] = None):
        dt = cfg.compute_dtype
        self.cfg = cfg
        self.params = {name: tree_to(params[name], dt) for name in ("conv1", "conv2", "pos", "ln_post")}
        ads = adapters if adapters is not None else [None] * len(params["layers"])
        if cfg.fused_block:
            self.layers: List = [fold_layer(*_whole_layer(p, a, cfg), cfg.n_heads, dt, quant=cfg.quant_int8)
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


def encoder_apply(cfg: WhisperConfig, params: Params, mel: torch.Tensor,
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
            p, a = _whole_layer(p, a, cfg)
            return fused_encoder_block(x, p, cfg.n_heads, a, approx=cfg.gelu_approx, quant=cfg.quant_int8)
        return _block(x, p, cfg, a)

    ads = adapters if adapters is not None else [None] * len(params["layers"])
    return _encode(cfg, params, mel, list(zip(params["layers"], ads)), run_layer)
