"""One pre-LN Whisper encoder layer as a chain of hand-written CUDA kernels
(counterpart of ``gwkit/ops/fused_block.py``).

On the TPU the whole layer is one Pallas kernel, ``_attn_block_kernel``
(K3), split into ``_attn_only_kernel`` (K4) + ``fused_mlp._mlp_kernel`` (K2)
where it outgrows VMEM. On Hopper the layer is four launches:

  B  LN1 + QKV   qkv = LN(x) @ Wqkv + bqkv     (csrc/ln_gemm.cu)
  A  attention   att = softmax(q k^T) v        (csrc/attention.cu)
  B  o-proj      x1  = x + att @ Wo + bo       (csrc/ln_gemm.cu)
  C  MLP         out = x1 + MLP(LN(x1))        (csrc/fused_mlp.cu)

and with ``skip_mlp`` the first three (the counterpart of K4). C holds the
(rows, F) activation on chip and has instantiations at D = 384 and 512
only; a wider layer (whisper-large-v3's 1280) runs its MLP as two more
launches of B, in a ``gw.mlp`` span:

  B  LN2 + fc1 + GELU   h  = gelu(LN(x1) @ W1 + b1)   (M, F) in bf16
  B  fc2 + residual     out = x1 + h @ W2 + b2

with h rounded where C rounds its on-chip activation, so the chain computes
the same function at every width (``COUNTERS``: ``mlp_fused_layers``,
``mlp_split_layers``). Past K = 512 kernel B streams x beside W and takes
LayerNorm folded into its epilogue (:func:`ln_fold`, made once by
:func:`fold_layer`); ``skip_mlp`` and the int8 layer stay at D <= 512. DoRA is
folded into dense effective weights and 1/sqrt(hd) into the q columns once,
by :func:`fold_layer`, in plain f32 PyTorch (gwkit ``_effective_proj`` and
the q-scale fold at fused_block.py:399-408); the search path folds when the
model is loaded and keeps the result on the device.

With int8 projections (``quant``, gwkit's K6) every projection is a launch
of kernel E (:mod:`gwkit_torch.ops.int8_gemm`). gwkit then computes one of
three different functions, picked by its VMEM estimate (``_fused_impl``,
fused_block.py:379-391, :431-470), and the port copies that decision
(:func:`_quant_regime`):

  fused      E(LN1+QKV) -> A (K3's contract) -> E(o+res) -> E(LN2+fc1+GELU)
             -> E(fc2+res); weights quantized from the folded compute-dtype
             weights (q scale folded in)
  split      E -> A -> E -> C: the MLP stays unquantized
  reference  gwkit's ``_reference_block(quant=True)``: weights quantized from
             the f32 effective weights, q scaled after its projection in the
             compute dtype, attention under K1's contract

On CUDA tensors every kernel takes bfloat16 only: a float32 chain is
refused before its first launch (``_cuda.require_bf16``), and float32 on
the card runs the unfused layer (``WhisperConfig(fused_block=False)``). On
CPU tensors each stage takes its kernel's plain version, so the chain's
wiring is tested on the CPU against gwkit. ``_reference_block`` is gwkit's
unfused math for the same layer.

:class:`FusedBlock` makes the layer differentiable, as gwkit's
``_fused_vjp`` (fused_block.py:474-502): the forward is the chain above,
folded from the current parameters and adapters on every call; the backward
recomputes ``_reference_block(..., flash=True)``, whose attention core is
kernel A (K1's contract) forward and kernel D backward, and differentiates
it. DoRA stays factored there, and LayerNorm, projection and MLP gradients
are plain PyTorch (cuBLAS), as gwkit leaves them to XLA. Only x and the
parameters are saved, so no activation of the layer outlives its forward
(gwkit's ``remat=True``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from gwkit_torch.io import tree_to
from gwkit_torch.ops import _cuda
from gwkit_torch.ops.attention import attention_from_qkv, flash_attention
from gwkit_torch.ops.dora import dora_linear, dora_row_norms
from gwkit_torch.ops.fused_mlp import KERNEL_WIDTHS, _gelu, fused_mlp_block
from gwkit_torch.ops.fused_mlp import _ln as _ln_f32
from gwkit_torch.ops.int8_gemm import QuantProj, _qdot, _quantize_cols, int8_gemm
from gwkit_torch.utils.tracing import COUNTERS, annotate

# gwkit's scoped VMEM limit, which picks the int8 regime (_fused_impl)
VMEM_LIMIT = 16 * (1 << 20)
# kernel B's depth limits: its panel kernel holds a 128-row panel of x in
# shared memory; the streamed bf16 kernel streams x beside W
PANEL_MAX_K = 512
STREAM_MAX_K = 5120
ACTS = {None: 0, "tanh": 1, "erf": 2}  # kernel B's epilogue GELU


@dataclasses.dataclass
class LnFold:
    """LayerNorm folded into a product for kernel B's streamed path:
    LN(x) @ W + bias = rstd * (x @ w - mean * colsum) + bias', the row's
    mean and rstd taken by the kernel from x."""
    w: torch.Tensor       # (K, N) g (.) W in the compute dtype
    colsum: torch.Tensor  # (N,) f32: the column sums of ``w`` as held
    bias: torch.Tensor    # (N,) f32: bias + b @ W


@torch.no_grad()
def ln_fold(w: torch.Tensor, bias: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> LnFold:
    """The fold of LayerNorm (g, b) into W (K, N) and bias (N,)."""
    wg = (g.float()[:, None] * w.float()).to(w.dtype).contiguous()
    return LnFold(wg, wg.float().sum(dim=0).contiguous(), (bias.float() + b.float() @ w.float()).contiguous())


@dataclasses.dataclass
class QuantLayer:
    """One layer's int8 projections (weights quantized once, at fold time)."""
    qkv: QuantProj  # (D, 3D)
    o: QuantProj    # (D, D)
    fc1: QuantProj  # (D, F)
    fc2: QuantProj  # (F, D)


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
    # int8 (fold_layer(quant=True)): for the fused and split regimes, and
    # for the reference regime
    int8: Optional[QuantLayer] = None
    int8_ref: Optional[QuantLayer] = None
    # LN1 into QKV and LN2 into fc1, for kernel B's streamed path (bf16 on
    # the card past D = 512)
    ln1_fold: Optional[LnFold] = None
    ln2_fold: Optional[LnFold] = None


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
def fold_layer(p: dict, adapters: Optional[dict], n_heads: int, dtype: torch.dtype,
               quant: bool = False) -> FusedLayer:
    """Fold one layer's parameters (gwkit layout) for the kernel chain.

    Parameters are first cast to ``dtype`` as gwkit's encoder casts them
    before its layer kernel; the folding itself runs in f32. ``quant`` adds
    the int8 projections of both weight sets gwkit quantizes: the folded
    weights as they stand in the compute dtype (fused_block.py:423-426) and
    the f32 effective weights of its reference math (:342-344)."""
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
    layer = FusedLayer(
        n_heads=n_heads,
        ln1_g=p["attn_ln"]["g"], ln1_b=p["attn_ln"]["b"],
        wqkv=wqkv.contiguous(), bqkv=bqkv.contiguous(),
        wo=eff["o"][0].to(dtype).contiguous(), bo=eff["o"][1].contiguous(),
        ln2_g=p["mlp_ln"]["g"], ln2_b=p["mlp_ln"]["b"],
        w1=p["fc1"]["w"].contiguous(), b1=p["fc1"]["b"].float(),
        w2=p["fc2"]["w"].contiguous(), b2=p["fc2"]["b"].float(),
    )
    if D > PANEL_MAX_K and layer.wqkv.is_cuda:
        layer.ln1_fold = ln_fold(layer.wqkv, layer.bqkv, layer.ln1_g, layer.ln1_b)
        layer.ln2_fold = ln_fold(layer.w1, layer.b1, layer.ln2_g, layer.ln2_b)
    if quant:
        fc1, fc2 = QuantProj.of(layer.w1, layer.b1), QuantProj.of(layer.w2, layer.b2)
        layer.int8 = QuantLayer(QuantProj.of(layer.wqkv, layer.bqkv), QuantProj.of(layer.wo, layer.bo),
                                fc1, fc2)
        layer.int8_ref = QuantLayer(
            QuantProj.of(torch.cat([eff[n][0] for n in "qkv"], dim=1), torch.cat([eff[n][1] for n in "qkv"])),
            QuantProj.of(*eff["o"]), fc1, fc2)
    return layer


def _quant_regime(T: int, D: int, F: int, dtype: torch.dtype) -> str:
    """gwkit's choice among its three int8 layer functions (``_fused_impl``,
    fused_block.py:385-391, :435, :448): "reference" when the attention-only
    kernel's VMEM estimate exceeds 16 MiB, else "fused" when the whole-layer
    kernel's fits, else "split". Weights count 1 byte each."""
    tp = -(-T // 128) * 128
    act = 7 * tp * D * torch.empty((), dtype=dtype).element_size()
    if act + 4 * D * D > VMEM_LIMIT:
        return "reference"
    return "fused" if act + 4 * D * D + 2 * D * F + 4 * (1 << 20) <= VMEM_LIMIT else "split"


def _ln_gemm_reference(x2, w, bias, ln=None, residual=None, act=None) -> torch.Tensor:
    """Plain version of kernel B: y = [LN(x)] @ W + bias [GELU] [+ residual],
    the product accumulated in f32 and rounded once to x's dtype; the GELU
    (``act`` "tanh" or "erf") on that value, rounded again (kernel C's
    rounding of its activation)."""
    _cuda.count_plain("ln_gemm")
    h = _ln_f32(x2, *ln) if ln is not None else x2
    y = (h.float() @ w.float() + bias.float()).to(x2.dtype)
    if act is not None:
        y = _gelu(y.float(), act == "tanh").to(x2.dtype)
    return y if residual is None else residual + y


def _launch_ln_gemm(lib, stream: int, x2, w, bias, ln, residual, y) -> None:
    M, K = x2.shape
    N = w.shape[1]
    g, b = ln if ln is not None else (None, None)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.gw_ln_gemm(x2.data_ptr(), ptr(g), ptr(b), w.data_ptr(), bias.data_ptr(),
                         ptr(residual), y.data_ptr(), M, N, K, _cuda.BF16_CODE, stream)
    _cuda.check(err, "ln_gemm")
    _cuda.LAUNCHES["ln_gemm"] += 1


def _launch_ln_gemm_wide(lib, stream: int, x2, w, colsum, bias, residual, y, act) -> None:
    M, K = x2.shape
    N = w.shape[1]
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.gw_ln_gemm_wide(x2.data_ptr(), w.data_ptr(), ptr(colsum), bias.data_ptr(), ptr(residual),
                              y.data_ptr(), M, N, K, ACTS[act], stream)
    _cuda.check(err, "ln_gemm")
    _cuda.LAUNCHES["ln_gemm"] += 1
    COUNTERS["ln_gemm_streamed_launches"] += 1


def ln_gemm(x2: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
            ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            residual: Optional[torch.Tensor] = None, act: Optional[str] = None,
            fold: Optional[LnFold] = None) -> torch.Tensor:
    """Kernel B on (M, K) rows: [LN(x)] @ W (K, N) + bias (N,) [GELU]
    [+ residual (M, N)]; ``act`` "tanh" or "erf" is kernel C's GELU.
    On CUDA, x, W, the LN scale/shift and the residual are in bfloat16, bias
    f32: the wgmma/TMA panel kernel (``hopper_ln_gemm_kernel``) at K <= 512
    without ``act``, else the streamed kernel (``hopper_wide_ln_gemm_kernel``,
    K up to 5120), which takes LayerNorm as ``fold`` (:func:`ln_fold` of
    ``w``, ``bias`` and ``ln``; made here when not given)."""
    if act not in ACTS:
        raise ValueError(f"ln_gemm: act {act!r} (None, 'tanh' or 'erf')")
    if x2.device.type == "cpu":
        return _ln_gemm_reference(x2, w, bias, ln, residual, act)
    ops = [x2, w, bias, residual] + list(ln or ())
    _cuda.require_cuda("ln_gemm", *ops)
    _cuda.require_bf16("ln_gemm", x2)
    dt = x2.dtype
    M, K = x2.shape
    N = w.shape[1]
    streamed = K > PANEL_MAX_K or act is not None
    if w.shape[0] != K or K % 64 or not 0 < K <= STREAM_MAX_K or N % 8 or tuple(bias.shape) != (N,) \
            or bias.dtype != torch.float32 \
            or (residual is not None and tuple(residual.shape) != (M, N)):
        raise ValueError(f"ln_gemm: x {tuple(x2.shape)}, w {tuple(w.shape)}, bias {tuple(bias.shape)} "
                         f"{bias.dtype}; K must be a multiple of 64 up to {STREAM_MAX_K}, N of 8")
    for t in ops:
        if t is not bias and t is not None and (t.dtype != dt or not t.is_contiguous()):
            raise ValueError("ln_gemm: operands must be contiguous and share x's dtype")
    _cuda.require_aligned("ln_gemm", *(t for t in (x2, w, residual) if t is not None))
    y = torch.empty((M, N), dtype=dt, device=x2.device)
    lib, stream = _cuda.library("ln_gemm"), _cuda.stream_of(x2)
    if not streamed:
        _launch_ln_gemm(lib, stream, x2, w, bias, ln, residual, y)
    elif ln is None:
        _launch_ln_gemm_wide(lib, stream, x2, w, None, bias, residual, y, act)
    else:
        fold = fold if fold is not None else ln_fold(w, bias, *ln)
        _cuda.require_aligned("ln_gemm", fold.w)
        _launch_ln_gemm_wide(lib, stream, x2, fold.w, fold.colsum, fold.bias, residual, y, act)
    return y


def _quant_layer_apply(x: torch.Tensor, layer: FusedLayer, approx: bool, skip_mlp: bool) -> torch.Tensor:
    """The int8 layer in gwkit's regime for x's geometry (module docstring)."""
    B, T, D = x.shape
    if D > PANEL_MAX_K:
        raise ValueError(f"fused layer: int8 projections at d_model {D}: kernel E takes d_model up to "
                         f"{PANEL_MAX_K} (whisper-tiny and base)")
    F = layer.w1.shape[1]
    regime = _quant_regime(T, D, F, x.dtype)
    q = layer.int8_ref if regime == "reference" else layer.int8
    x2 = x.reshape(B * T, D).contiguous()
    qkv = int8_gemm(x2, q.qkv, ln=(layer.ln1_g, layer.ln1_b))
    if regime == "reference":
        H = layer.n_heads
        hd = D // H
        qh = (qkv[:, :D] * hd ** -0.5).view(B, T, H, hd)
        kh, vh = (qkv[:, i * D:(i + 1) * D].view(B, T, H, hd) for i in (1, 2))
        att = flash_attention(qh, kh, vh).reshape(B * T, D)
    else:
        att = attention_from_qkv(qkv.view(B, T, 3 * D), layer.n_heads).view(B * T, D)
    x1 = int8_gemm(att, q.o, residual=x2)
    if skip_mlp:
        return x1.view(B, T, D)
    if regime == "split":
        return fused_mlp_block(x1.view(B, T, D), layer.ln2_g, layer.ln2_b, layer.w1, layer.b1, layer.w2,
                               layer.b2, approx=approx)
    # fc1 hands each row's maximum over to fc2, which quantizes by it
    h, h_amax = int8_gemm(x1, q.fc1, ln=(layer.ln2_g, layer.ln2_b), act="tanh" if approx else "erf",
                          return_row_amax=True)
    return int8_gemm(h, q.fc2, residual=x1, row_amax=h_amax).view(B, T, D)


def fused_layer_apply(x: torch.Tensor, layer: FusedLayer, approx: bool = False,
                      skip_mlp: bool = False) -> torch.Tensor:
    """Run one folded layer on x (B, T, D): B -> A -> B [-> C], or with the
    layer's int8 projections the int8 chain of gwkit's regime."""
    if layer.int8 is not None:
        return _quant_layer_apply(x, layer, approx, skip_mlp)
    B, T, D = x.shape
    split = D > max(KERNEL_WIDTHS)  # no instantiation of C: the MLP as two launches of B
    if split and skip_mlp:
        raise ValueError(f"fused layer: skip_mlp at d_model {D}: the attention-only chain pairs with "
                         f"kernel C, which takes d_model {KERNEL_WIDTHS}")
    x2 = x.reshape(B * T, D).contiguous()
    qkv = ln_gemm(x2, layer.wqkv, layer.bqkv, ln=(layer.ln1_g, layer.ln1_b), fold=layer.ln1_fold)
    att = attention_from_qkv(qkv.view(B, T, 3 * D), layer.n_heads)
    x1 = ln_gemm(att.view(B * T, D), layer.wo, layer.bo, residual=x2)
    if skip_mlp:
        return x1.view(B, T, D)
    if not split:
        COUNTERS["mlp_fused_layers"] += 1
        return fused_mlp_block(x1.view(B, T, D), layer.ln2_g, layer.ln2_b, layer.w1, layer.b1, layer.w2,
                               layer.b2, approx=approx)
    COUNTERS["mlp_split_layers"] += 1
    with annotate("gw.mlp"):
        h = ln_gemm(x1, layer.w1, layer.b1, ln=(layer.ln2_g, layer.ln2_b), act="tanh" if approx else "erf",
                    fold=layer.ln2_fold)
        return ln_gemm(h, layer.w2, layer.b2, residual=x1).view(B, T, D)


class _Slot(int):
    """Where a tensor leaf sat in a flattened parameter tree."""


def _split(tree, leaves: List[torch.Tensor]):
    """Replace every tensor of a tree of dicts by a :class:`_Slot` into ``leaves``."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _Slot(len(leaves) - 1)
    if isinstance(tree, dict):
        return {k: _split(v, leaves) for k, v in tree.items()}
    return tree


def _fill(spec, leaves):
    if isinstance(spec, _Slot):
        return leaves[spec]
    if isinstance(spec, dict):
        return {k: _fill(v, leaves) for k, v in spec.items()}
    if isinstance(spec, tuple):
        return tuple(_fill(v, leaves) for v in spec)
    return spec


class FusedBlock(torch.autograd.Function):
    """The layer on the kernel chain, differentiable in x and in every
    tensor of the parameters and adapters (``scaling`` included). With
    ``quant`` the forward is the int8 layer and the backward stays the
    full-precision one (straight through, as gwkit's ``_fused_bwd``)."""

    @staticmethod
    def forward(ctx, x, n_heads, approx, quant, spec, *leaves):
        ctx.save_for_backward(x, *leaves)
        ctx.layer = (n_heads, approx, spec)
        p, ad = _fill(spec, leaves)
        return fused_layer_apply(x, fold_layer(p, ad, n_heads, x.dtype, quant=quant), approx)

    @staticmethod
    def backward(ctx, g):
        x, *leaves = ctx.saved_tensors
        n_heads, approx, spec = ctx.layer
        need = ctx.needs_input_grad
        with torch.enable_grad():
            xs = x.detach().requires_grad_(need[0])
            ls = [t.detach().requires_grad_(n) for t, n in zip(leaves, need[5:])]
            p, ad = _fill(spec, ls)
            out = _reference_block(xs, p, ad, n_heads, approx, flash=True)
            wrt = [t for t in [xs, *ls] if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True) if wrt else ())
        dx = next(grads) if xs.requires_grad else None
        return (dx, None, None, None, None, *(next(grads) if t.requires_grad else None for t in ls))


def fused_encoder_block(x: torch.Tensor, p: dict, n_heads: int, adapters: Optional[dict] = None,
                        approx: bool = False, skip_mlp: bool = False, quant: bool = False) -> torch.Tensor:
    """One whole pre-LN transformer block: x (B, T, D) -> (B, T, D).

    ``p``: per-layer params (attn_ln, q, k, v, o, mlp_ln, fc1, fc2), gwkit
    layout; ``adapters``: optional DoRA/LoRA dict keyed by projection. Folds
    the weights on every call and is differentiable (:class:`FusedBlock`);
    the search path folds once with :func:`fold_layer` and calls
    :func:`fused_layer_apply`. ``skip_mlp`` (the counterpart of K4) is
    forward only. ``quant``: int8 projections (gwkit's ``quant``)."""
    if skip_mlp:
        return fused_layer_apply(x, fold_layer(p, adapters, n_heads, x.dtype, quant=quant), approx,
                                 skip_mlp)
    leaves: List[torch.Tensor] = []
    spec = (_split(p, leaves), _split(adapters, leaves))
    return FusedBlock.apply(x, n_heads, approx, quant, spec, *leaves)


def _reference_block(x: torch.Tensor, p: dict, adapters: Optional[dict], n_heads: int,
                     approx: bool, flash: bool = False, quant: bool = False) -> torch.Tensor:
    """gwkit's unfused math for the same layer (``_reference_block``,
    fused_block.py:320-367): DoRA applied in factored form, attention with
    the full (B, H, T, T) probability tensor, or with ``flash=True`` through
    :func:`~gwkit_torch.ops.attention.flash_attention` (kernel A forward and
    kernel D backward on the card; no T x T tensor reaches device memory).
    ``quant``: each projection int8 from its own f32 effective weight
    (``_qdot``), the result rounded to x's dtype; plain PyTorch throughout."""
    if not flash:
        _cuda.count_plain("block")
    dt = x.dtype
    ad = tree_to(adapters or {}, dt)
    B, T, D = x.shape
    hd = D // n_heads

    def prj(name, h):
        entry = {k: v.to(dt) for k, v in p[name].items()}
        if quant:
            w_eff, _ = _effective_proj(entry, ad.get(name))
            wq, sw = _quantize_cols(w_eff)
            y = _qdot(h.reshape(-1, h.shape[-1]), wq, sw, entry.get("b"))
            return y.reshape(*h.shape[:-1], -1).to(dt)
        if name in ad:
            return dora_linear(h, entry["w"], entry.get("b"), ad[name])
        y = h @ entry["w"]
        return y + entry["b"] if "b" in entry else y

    h = _ln_f32(x, p["attn_ln"]["g"], p["attn_ln"]["b"])
    q = (prj("q", h) * hd ** -0.5).reshape(B, T, n_heads, hd)
    k = prj("k", h).reshape(B, T, n_heads, hd)
    v = prj("v", h).reshape(B, T, n_heads, hd)
    if flash:
        o = flash_attention(q, k, v).reshape(B, T, D)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        probs = torch.softmax(scores, dim=-1).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, D)
    x1 = x + prj("o", o)
    h2 = _ln_f32(x1, p["mlp_ln"]["g"], p["mlp_ln"]["b"])
    h2 = _gelu(prj("fc1", h2), approx)
    return x1 + prj("fc2", h2.to(dt))
