"""Fused LayerNorm -> MLP -> residual (counterpart of ``gwkit/ops/fused_mlp.py``).

  out = x + gelu(LN(x) @ W1 + b1) @ W2 + b2

On CUDA tensors ``fused_mlp_block`` runs kernel C (``csrc/fused_mlp.cu``)
in bfloat16 on wgmma and TMA (``hopper_fused_mlp_kernel``, F a multiple of
128): LN statistics in f32, products accumulated in f32, GELU in bf16, and
the (rows, F) activation kept in shared memory. On CPU tensors it runs
``_unfused``, the plain PyTorch version. Where a gradient is wanted on the
card, the backward recomputes the plain math and differentiates it (gwkit's
``_fused_bwd``). The TPU kernel it replaces is
``gwkit/ops/fused_mlp.py::_mlp_kernel``; kernel C is also the MLP stage of
the fused encoder block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from gwkit_torch.ops import _cuda

KERNEL_WIDTHS = (384, 512)  # d_model of whisper-tiny and whisper-base


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """gwkit's in-kernel LayerNorm: f32 mean and biased variance, normalize,
    cast to x's dtype, then scale and shift in that dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * g.to(x.dtype) + b.to(x.dtype)


def _gelu(x: torch.Tensor, approx: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approx else "none")


def _mlp_math(x, g, b, w1, b1, w2, b2, approx: bool) -> torch.Tensor:
    h = _ln(x, g, b)
    h = _gelu(h @ w1 + b1.to(x.dtype), approx)
    return x + (h @ w2 + b2.to(x.dtype))


def _unfused(x, g, b, w1, b1, w2, b2, approx: bool = False) -> torch.Tensor:
    """Plain path, gwkit's math: products in x's dtype."""
    _cuda.count_plain("fused_mlp")
    return _mlp_math(x, g, b, w1, b1, w2, b2, approx)


class _FusedMLP(torch.autograd.Function):
    """Kernel C forward; the backward differentiates the plain math."""

    @staticmethod
    def forward(ctx, x, g, b, w1, b1, w2, b2, approx):
        ctx.save_for_backward(x, g, b, w1, b1, w2, b2)
        ctx.approx = approx
        return fused_mlp_block(x, g, b, w1, b1, w2, b2, approx)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, ctx.needs_input_grad)]
            out = _mlp_math(*ins, ctx.approx)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, dy) if wrt else ())
        return (*(next(grads) if t.requires_grad else None for t in ins), None)


def _launch(lib, stream: int, x2, g, b, w1, b1, w2, b2, out, approx: bool) -> None:
    M, D = x2.shape
    err = lib.gw_fused_mlp(x2.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                           w2.data_ptr(), b2.data_ptr(), out.data_ptr(), M, D, w1.shape[1],
                           int(approx), _cuda.BF16_CODE, stream)
    _cuda.check(err, "fused_mlp")
    _cuda.LAUNCHES["fused_mlp"] += 1


def fused_mlp_block(x, g, b, w1, b1, w2, b2, approx: bool = False) -> torch.Tensor:
    """x (B, T, D) -> x + MLP(LN(x)); weights right-multiplied ((D, F), (F, D)).
    On CUDA: x in bfloat16; g, b, w1, w2 are used in bfloat16 and b1, b2 in float32."""
    if x.device.type == "cpu":
        return _unfused(x, g, b, w1, b1, w2, b2, approx)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, g, b, w1, b1, w2, b2)):
        return _FusedMLP.apply(x, g, b, w1, b1, w2, b2, approx)
    _cuda.require_cuda("fused_mlp_block", x, g, b, w1, b1, w2, b2)
    _cuda.require_bf16("fused_mlp_block", x)
    dt = x.dtype
    D = x.shape[-1]
    Fd = w1.shape[1]
    if D not in KERNEL_WIDTHS or Fd % 128 or tuple(w1.shape) != (D, Fd) or tuple(w2.shape) != (Fd, D):
        raise ValueError(f"fused_mlp_block: D={D} (kernel takes {KERNEL_WIDTHS}), "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}, F a multiple of 128")
    x2 = x.reshape(-1, D).contiguous()
    ops = [t.to(dt).contiguous() for t in (g, b, w1)] + [b1.float().contiguous()] \
        + [w2.to(dt).contiguous(), b2.float().contiguous()]
    _cuda.require_aligned("fused_mlp_block", x2, ops[2], ops[4])
    out = torch.empty_like(x2)
    _launch(_cuda.library("fused_mlp"), _cuda.stream_of(x), x2, *ops, out, approx)
    return out.reshape(x.shape)
