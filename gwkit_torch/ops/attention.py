"""Self-attention for the Whisper encoder (counterpart of ``gwkit/ops/attention.py``).

``flash_attention`` runs kernel A (``csrc/attention.cu``) on CUDA tensors:
scores in f32, keys at or beyond T masked, the exact row max (two passes over
the key tiles), p = exp(s - m) in the compute type, and the output divided by
the f32 denominator. On CPU tensors it runs ``reference_attention``, the
plain PyTorch version. The TPU kernel it replaces is
``gwkit/ops/attention.py::_attn_kernel``; kernel A is also the attention
stage of the fused encoder block (``gwkit_torch.ops.fused_block``).
"""
from __future__ import annotations

import torch

from gwkit_torch.ops import _cuda

HEAD_DIM = 64  # the kernel's head width (every Whisper size)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain path, gwkit's math: (B, T, H, hd) pre-scaled q, k, v -> (B, T, H, hd).
    Scores and softmax in f32, probabilities cast to v's dtype."""
    _cuda.count_plain("attention")
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _launch(lib, stream: int, q, k, v, out, B: int, T: int, H: int, ld_in: int, ld_out: int) -> None:
    """Launch kernel A on row-strided q/k/v views (rows of ``ld_in`` elements)."""
    dtype = _cuda.DTYPE_CODES[q.dtype]
    err = lib.gw_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           B, T, H, ld_in, ld_out, dtype, stream)
    _cuda.check(err, "attention")
    _cuda.LAUNCHES["attention"] += 1


def _check(name: str, t: torch.Tensor) -> None:
    if t.dtype not in _cuda.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} (kernel takes float32 or bfloat16)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, T, H, 64) pre-scaled q, k, v -> (B, T, H, 64) attention output."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v)
    _cuda.require_cuda("flash_attention", q, k, v)
    for t in (q, k, v):
        _check("flash_attention", t)
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError("flash_attention: q, k, v must share shape and dtype")
    B, T, H, hd = q.shape
    if hd != HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} (kernel takes {HEAD_DIM})")
    _cuda.require_aligned("flash_attention", q, k, v)
    out = torch.empty_like(q)
    _launch(_cuda.library("attention"), _cuda.stream_of(q), q, k, v, out, B, T, H, H * hd, H * hd)
    return out


def attention_from_qkv(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Kernel A on the fused projection: (B, T, 3D) [q | k | v] -> (B, T, D).

    q, k and v are read in place through row strides (no split, no
    transpose); the output comes back in the (B, T, D) layout the
    o-projection reads."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    if qkv.device.type == "cpu":
        q, k, v = (t.reshape(B, T, n_heads, D // n_heads) for t in qkv.split(D, dim=-1))
        return reference_attention(q, k, v).reshape(B, T, D)
    _cuda.require_cuda("attention_from_qkv", qkv)
    _check("attention_from_qkv", qkv)
    if D != n_heads * HEAD_DIM:
        raise ValueError(f"attention_from_qkv: head dim {D // n_heads} (kernel takes {HEAD_DIM})")
    _cuda.require_aligned("attention_from_qkv", qkv)
    out = torch.empty((B, T, D), dtype=qkv.dtype, device=qkv.device)
    flat = qkv.view(-1)
    _launch(_cuda.library("attention"), _cuda.stream_of(qkv), flat, flat[D:], flat[2 * D:], out,
            B, T, n_heads, 3 * D, D)
    return out
