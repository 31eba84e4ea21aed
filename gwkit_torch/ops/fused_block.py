"""One pre-LN Whisper encoder layer as a chain of hand-written CUDA kernels
(counterpart of ``gwkit/ops/fused_block.py``).

On the TPU the whole layer is one Pallas kernel, ``_attn_block_kernel``
(K3), split into ``_attn_only_kernel`` (K4) + ``fused_mlp._mlp_kernel`` (K2)
where it outgrows VMEM. On Hopper the layer is four launches:

  B  LN1 + QKV   qkv = LN(x) @ Wqkv + bqkv     (csrc/ln_gemm.cu)
  A  attention   att = softmax(q k^T) v        (csrc/attention.cu)
  B  o-proj      x1  = x + att @ Wo + bo       (csrc/ln_gemm.cu)
  C  MLP         out = x1 + MLP(LN(x1))        (csrc/fused_mlp.cu)

and with ``skip_mlp`` the first three (the counterpart of K4). DoRA is
folded into dense effective weights and 1/sqrt(hd) into the q columns once,
by :func:`fold_layer`, in plain f32 PyTorch (gwkit ``_effective_proj`` and
the q-scale fold at fused_block.py:399-408); the search path folds when the
model is loaded and keeps the result on the device.

On CPU tensors each stage takes its kernel's plain version, so the chain's
wiring is tested on the CPU against gwkit. ``_reference_block`` is gwkit's
unfused math for the same layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from gwkit_torch.io import tree_to
from gwkit_torch.ops import _cuda
from gwkit_torch.ops.attention import attention_from_qkv
from gwkit_torch.ops.dora import dora_linear, dora_row_norms
from gwkit_torch.ops.fused_mlp import _gelu, fused_mlp_block
from gwkit_torch.ops.fused_mlp import _ln as _ln_f32


@dataclasses.dataclass
class FusedLayer:
    """One layer's folded weights: matrices in the compute dtype, biases f32."""
    n_heads: int
    ln1_g: torch.Tensor
    ln1_b: torch.Tensor
    wqkv: torch.Tensor  # (D, 3D), DoRA folded, q columns scaled by 1/sqrt(hd)
    bqkv: torch.Tensor  # (3D,) f32
    wo: torch.Tensor    # (D, D), DoRA folded
    bo: torch.Tensor    # (D,) f32
    ln2_g: torch.Tensor
    ln2_b: torch.Tensor
    w1: torch.Tensor    # (D, F)
    b1: torch.Tensor    # (F,) f32
    w2: torch.Tensor    # (F, D)
    b2: torch.Tensor    # (D,) f32


def _effective_proj(p_entry: dict, adapter: Optional[dict]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W_eff, bias) in f32: W_eff = colscale * (W0 + s*a@b) with colscale =
    m/||W0 + s*a@b|| (detached); a missing bias is zeros."""
    w = p_entry["w"].float()
    bias = p_entry.get("b")
    bias = torch.zeros(w.shape[1], device=w.device) if bias is None else bias.float()
    if adapter is None:
        return w, bias
    s = adapter.get("scaling", 1.0)
    w_eff = w + s * (adapter["a"].float() @ adapter["b"].float())
    if "m" in adapter:
        norms = dora_row_norms(p_entry["w"], adapter["a"], adapter["b"], s).detach()
        w_eff = w_eff * (adapter["m"].float() / norms)
    return w_eff, bias


@torch.no_grad()
def fold_layer(p: dict, adapters: Optional[dict], n_heads: int, dtype: torch.dtype) -> FusedLayer:
    """Fold one layer's parameters (gwkit layout) for the kernel chain.

    Parameters are first cast to ``dtype`` as gwkit's encoder casts them
    before its layer kernel; the folding itself runs in f32."""
    p = tree_to(p, dtype)
    ad = tree_to(adapters or {}, dtype)
    D = p["q"]["w"].shape[0]
    q_scale = (D // n_heads) ** -0.5
    eff = {name: _effective_proj(p[name], ad.get(name)) for name in ("q", "k", "v", "o")}

    def rounded(t):  # the effective weight as the compute dtype holds it
        return t.to(dtype).float()

    wqkv = torch.cat([rounded(eff["q"][0]) * q_scale, rounded(eff["k"][0]),
                      rounded(eff["v"][0])], dim=1).to(dtype)
    bqkv = torch.cat([(eff["q"][1].to(dtype) * q_scale).float(), eff["k"][1], eff["v"][1]])
    return FusedLayer(
        n_heads=n_heads,
        ln1_g=p["attn_ln"]["g"], ln1_b=p["attn_ln"]["b"],
        wqkv=wqkv.contiguous(), bqkv=bqkv.contiguous(),
        wo=eff["o"][0].to(dtype).contiguous(), bo=eff["o"][1].contiguous(),
        ln2_g=p["mlp_ln"]["g"], ln2_b=p["mlp_ln"]["b"],
        w1=p["fc1"]["w"].contiguous(), b1=p["fc1"]["b"].float(),
        w2=p["fc2"]["w"].contiguous(), b2=p["fc2"]["b"].float(),
    )


def _ln_gemm_reference(x2, w, bias, ln=None, residual=None) -> torch.Tensor:
    """Plain version of kernel B: y = [LN(x)] @ W + bias [+ residual], the
    product accumulated in f32 and rounded once to x's dtype."""
    _cuda.count_plain("ln_gemm")
    h = _ln_f32(x2, *ln) if ln is not None else x2
    y = (h.float() @ w.float() + bias.float()).to(x2.dtype)
    return y if residual is None else residual + y


def _launch_ln_gemm(lib, stream: int, x2, w, bias, ln, residual, y) -> None:
    M, K = x2.shape
    N = w.shape[1]
    g, b = ln if ln is not None else (None, None)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.gw_ln_gemm(x2.data_ptr(), ptr(g), ptr(b), w.data_ptr(), bias.data_ptr(),
                         ptr(residual), y.data_ptr(), M, N, K, _cuda.DTYPE_CODES[x2.dtype], stream)
    _cuda.check(err, "ln_gemm")
    _cuda.LAUNCHES["ln_gemm"] += 1


def ln_gemm(x2: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
            ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel B on (M, K) rows: [LN(x)] @ W (K, N) + bias (N,) [+ residual (M, N)].
    On CUDA, W, the LN scale/shift and the residual are in x's dtype, bias f32."""
    if x2.device.type == "cpu":
        return _ln_gemm_reference(x2, w, bias, ln, residual)
    ops = [x2, w, bias, residual] + list(ln or ())
    _cuda.require_cuda("ln_gemm", *ops)
    dt = x2.dtype
    if dt not in _cuda.DTYPE_CODES:
        raise TypeError(f"ln_gemm: dtype {dt} (kernel takes float32 or bfloat16)")
    M, K = x2.shape
    N = w.shape[1]
    if w.shape[0] != K or K % 64 or N % 8 or tuple(bias.shape) != (N,) \
            or bias.dtype != torch.float32 \
            or (residual is not None and tuple(residual.shape) != (M, N)):
        raise ValueError(f"ln_gemm: x {tuple(x2.shape)}, w {tuple(w.shape)}, bias "
                         f"{tuple(bias.shape)} {bias.dtype}; K must be a multiple of 64, N of 8")
    for t in ops:
        if t is not bias and t is not None and (t.dtype != dt or not t.is_contiguous()):
            raise ValueError("ln_gemm: operands must be contiguous and share x's dtype")
    _cuda.require_aligned("ln_gemm", x2, w)
    y = torch.empty((M, N), dtype=dt, device=x2.device)
    _launch_ln_gemm(_cuda.library("ln_gemm"), _cuda.stream_of(x2), x2, w, bias, ln, residual, y)
    return y


def fused_layer_apply(x: torch.Tensor, layer: FusedLayer, approx: bool = False,
                      skip_mlp: bool = False) -> torch.Tensor:
    """Run one folded layer on x (B, T, D): B -> A -> B [-> C]."""
    B, T, D = x.shape
    x2 = x.reshape(B * T, D).contiguous()
    qkv = ln_gemm(x2, layer.wqkv, layer.bqkv, ln=(layer.ln1_g, layer.ln1_b))
    att = attention_from_qkv(qkv.view(B, T, 3 * D), layer.n_heads)
    x1 = ln_gemm(att.view(B * T, D), layer.wo, layer.bo, residual=x2).view(B, T, D)
    if skip_mlp:
        return x1
    return fused_mlp_block(x1, layer.ln2_g, layer.ln2_b, layer.w1, layer.b1, layer.w2,
                           layer.b2, approx=approx)


def fused_encoder_block(x: torch.Tensor, p: dict, n_heads: int, adapters: Optional[dict] = None,
                        approx: bool = False, skip_mlp: bool = False) -> torch.Tensor:
    """One whole pre-LN transformer block: x (B, T, D) -> (B, T, D).

    ``p``: per-layer params (attn_ln, q, k, v, o, mlp_ln, fc1, fc2), gwkit
    layout; ``adapters``: optional DoRA/LoRA dict keyed by projection. Folds
    the weights on every call; the search path folds once with
    :func:`fold_layer` and calls :func:`fused_layer_apply`."""
    return fused_layer_apply(x, fold_layer(p, adapters, n_heads, x.dtype), approx, skip_mlp)


def _reference_block(x: torch.Tensor, p: dict, adapters: Optional[dict], n_heads: int,
                     approx: bool) -> torch.Tensor:
    """gwkit's unfused math for the same layer (``_reference_block``,
    fused_block.py:320-367): DoRA applied in factored form, attention with
    the full (B, H, T, T) probability tensor."""
    _cuda.count_plain("block")
    dt = x.dtype
    ad = tree_to(adapters or {}, dt)
    B, T, D = x.shape
    hd = D // n_heads

    def prj(name, h):
        entry = {k: v.to(dt) for k, v in p[name].items()}
        if name in ad:
            return dora_linear(h, entry["w"], entry.get("b"), ad[name])
        y = h @ entry["w"]
        return y + entry["b"] if "b" in entry else y

    h = _ln_f32(x, p["attn_ln"]["g"], p["attn_ln"]["b"])
    q = (prj("q", h) * hd ** -0.5).reshape(B, T, n_heads, hd)
    k = prj("k", h).reshape(B, T, n_heads, hd)
    v = prj("v", h).reshape(B, T, n_heads, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(scores, dim=-1).to(dt)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, D)
    x1 = x + prj("o", o)
    h2 = _ln_f32(x1, p["mlp_ln"]["g"], p["mlp_ln"]["b"])
    h2 = _gelu(prj("fc1", h2), approx)
    return x1 + prj("fc2", h2.to(dt))
