"""Self-attention for the Whisper encoder, forward and backward (counterpart
of ``gwkit/ops/attention.py``).

``flash_attention`` is differentiable (:class:`FlashAttention`, the
counterpart of gwkit's ``_flash_vjp``). On CUDA tensors its forward runs
kernel A (``csrc/attention.cu``) under the contract of gwkit's K1
(``_attn_kernel``): scores in f32, keys at or beyond T masked, the exact
row max, p = exp(s - m) / sum in f32, p rounded to v's dtype, then p . V
accumulated in f32. Its backward runs kernel D (``csrc/attention_bwd.cu``),
the port of gwkit's K5 (``_attn_bwd_kernel``). Both kernels take bfloat16.
The forward saves K1's row state (:class:`RowState`: each row's exact max
and f32 sum, and the f32 output before its rounding) from kernel A's
registers, and kernel D reads it instead of recomputing it. On CPU tensors
both take their plain PyTorch versions, ``reference_attention`` and
``reference_attention_bwd``, which save and read the same state.

``attention_from_qkv`` is kernel A as the attention stage of the fused
encoder block (``gwkit_torch.ops.fused_block``), under K3's contract: p =
exp(round(s - m)) in the compute type and the output divided by the f32
denominator.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gwkit_torch.ops import _cuda
from gwkit_torch.utils.tracing import COUNTERS

HEAD_DIM = 64  # the kernels' head width (every Whisper size)
ROW_TILE = 64  # the kernels' query tile
# kernel A's one-pass limit (csrc/attention.cu, HopperAttn::ONE_PASS_MAX_T):
# a longer T takes the two-pass path
ONE_PASS_MAX_T = 256


def state_rows(T: int) -> int:
    """The row stride of the per-row planes (m, l, D) that kernel A writes
    and kernel D reads: T rounded up to the query tile. Both C entries take
    it and require it."""
    return -(-T // ROW_TILE) * ROW_TILE


class RowState(NamedTuple):
    """K1's forward state, which the backward reads instead of recomputing:
    ``m`` and ``l``, each row's exact score max and f32 sum of exp(s - m),
    (B*H, Tp) float32 with row t of (sequence b, head h) at [b*H + h, t]
    (Tp = :func:`state_rows` from kernel A, T from the plain version),
    and ``o``, the f32 output p_lo . V before its rounding, (B, T, H, hd)."""
    m: torch.Tensor
    l: torch.Tensor
    o: torch.Tensor


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, with_state: bool = False):
    """Plain path, gwkit's math: (B, T, H, hd) pre-scaled q, k, v -> (B, T, H, hd).
    Scores and softmax in f32, probabilities cast to v's dtype. With
    ``with_state``, (output, :class:`RowState`) as K1 computes them."""
    _cuda.count_plain("attention")
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    if not with_state:
        return out
    B, H, T, _ = scores.shape
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", (e / l).to(v.dtype).float(), v.float())
    return out, RowState(m.reshape(B * H, T), l.reshape(B * H, T), o)


def reference_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                            state: Optional[RowState] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel D, gwkit's K5 step by step on (B, T, H, hd):
    p = softmax(q k^T) in f32 and p_lo = p in v's dtype; dV = p_lo^T dO;
    dP = dO V^T; o = p_lo V in f32; D = rowsum(dO * o); dS = p * (dP - D)
    in q's dtype; dQ = dS K; dK = dS^T Q. Every product accumulates in f32;
    dq, dk, dv come back in q's dtype. Given the forward's ``state``, p is
    exp(s - m) / l from its m and l and o is its o; without it both are
    recomputed."""
    _cuda.count_plain("attention_bwd")
    f = lambda t: t.float()
    B, T, H, _ = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", f(q), f(k))
    if state is None:
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
    else:
        m, l = (f(t[:, :T]).reshape(B, H, T, 1) for t in (state.m, state.l))
        p = torch.exp(s - m) / l
    p_lo = f(p.to(v.dtype))
    do32 = f(do.to(v.dtype))
    dv = torch.einsum("bhqk,bqhd->bkhd", p_lo, do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, f(v))
    o = torch.einsum("bhqk,bkhd->bqhd", p_lo, f(v)) if state is None else f(state.o)
    d = (f(do) * o).sum(dim=-1).permute(0, 2, 1).unsqueeze(-1)  # (B, H, T, 1)
    ds = f((p * (dp - d)).to(q.dtype))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, f(k))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, f(q))
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _row_stride(t: torch.Tensor) -> Optional[int]:
    """ld if the (B, T, H, 64) view ``t`` reads row t of sequence b, head h
    at (b*T + t)*ld + h*64 (a contiguous tensor, or a column block of the
    fused QKV projection); else None."""
    B, T, H, hd = t.shape
    s = t.stride()
    if s[3] == 1 and s[2] == hd and s[0] == T * s[1] and s[1] >= H * hd and s[1] % 8 == 0:
        return s[1]
    return None


def _operands(name: str, *ts: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """Check q, k, v (bf16, same shape, head dim 64) and return views
    that share one row stride (contiguous copies where they do not)."""
    q = ts[0]
    _cuda.require_cuda(name, *ts)
    _cuda.require_bf16(name, *ts)
    for t in ts:
        if t.shape != q.shape:
            raise ValueError(f"{name}: q, k, v must share shape")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[-1]} (kernel takes {HEAD_DIM})")
    lds = {_row_stride(t) for t in ts}
    if len(lds) != 1 or None in lds:
        ts = tuple(t.contiguous() for t in ts)
        lds = {_row_stride(ts[0])}
    _cuda.require_aligned(name, *ts)
    return ts, lds.pop()


def _launch(lib, stream: int, q, k, v, out, B: int, T: int, H: int, ld_in: int, ld_out: int,
            k1: bool, state: Optional[RowState] = None) -> None:
    """Launch kernel A on row-strided q/k/v views (rows of ``ld_in`` elements);
    ``k1`` picks K1's softmax contract, else K3's. A ``state`` (K1 only) is
    written beside the output. A launch past ``ONE_PASS_MAX_T`` counts in
    ``COUNTERS["attention_two_pass_launches"]`` too."""
    saved = (None, None, None) if state is None else (state.m.data_ptr(), state.l.data_ptr(), state.o.data_ptr())
    err = lib.gw_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *saved,
                           B, T, H, ld_in, ld_out, state_rows(T), _cuda.BF16_CODE, int(k1), stream)
    _cuda.check(err, "attention")
    _cuda.LAUNCHES["attention"] += 1
    if T > ONE_PASS_MAX_T:
        COUNTERS["attention_two_pass_launches"] += 1


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, save_state: bool = False):
    """Kernel A under K1's contract: (B, T, H, 64) pre-scaled q, k, v -> (B, T, H, 64).

    With ``save_state``, (output, :class:`RowState`): the state comes from
    kernel A on the card and from the plain version on the CPU."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, with_state=save_state)
    (q, k, v), ld = _operands("flash_attention", q, k, v)
    B, T, H, hd = q.shape
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    state = None
    if save_state:
        rows = torch.empty((2, B * H, state_rows(T)), dtype=torch.float32, device=q.device)
        state = RowState(rows[0], rows[1], torch.empty((B, T, H, hd), dtype=torch.float32, device=q.device))
    _launch(_cuda.library("attention"), _cuda.stream_of(q), q, k, v, out, B, T, H, ld, H * hd, k1=True,
            state=state)
    return (out, state) if save_state else out


def _check_state(state: RowState, B: int, T: int, H: int, hd: int) -> None:
    tp = state_rows(T)
    for name, t, shape in (("m", state.m, (B * H, tp)), ("l", state.l, (B * H, tp)), ("o", state.o, (B, T, H, hd))):
        if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"attention_bwd: state.{name} must be contiguous float32 {shape}")
    _cuda.require_cuda("attention_bwd", *state)
    _cuda.require_aligned("attention_bwd", *state)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                  state: Optional[RowState] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel D: (dq, dk, dv) of K1 at (q, k, v) for the output gradient
    ``do``, all (B, T, H, 64), returned in q's dtype.

    Kernel D reads the forward's ``state`` (:func:`attention_fwd` with
    ``save_state``); without one it first runs kernel A under K1 to make it
    (one more counted ``attention`` launch)."""
    if q.device.type == "cpu":
        return reference_attention_bwd(q, k, v, do, state)
    (q, k, v), ld = _operands("attention_bwd", q, k, v)
    _cuda.require_cuda("attention_bwd", do)
    if do.shape != q.shape:
        raise ValueError(f"attention_bwd: do {tuple(do.shape)} != q {tuple(q.shape)}")
    do = do.to(q.dtype).contiguous()
    _cuda.require_aligned("attention_bwd", do)
    B, T, H, hd = q.shape
    tp = state_rows(T)
    if state is None:
        _, state = attention_fwd(q, k, v, save_state=True)
    _check_state(state, B, T, H, hd)
    stats = torch.empty((3, B * H, tp), dtype=torch.float32, device=q.device)  # the planes launch 1 writes for 2
    dq, dk, dv = (torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device) for _ in range(3))
    lib = _cuda.library("attention_bwd")
    err = lib.gw_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                               *(t.data_ptr() for t in state), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                               stats.data_ptr(), B, T, H, ld, H * hd, H * hd, tp, _cuda.BF16_CODE,
                               _cuda.stream_of(q))
    _cuda.check(err, "attention_bwd")
    _cuda.LAUNCHES["attention_bwd"] += 1  # one per call; the call runs two grids (dq, then dk/dv)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """softmax(q k^T) v with kernel A (K1's contract) forward and kernel D
    backward. Where a gradient is wanted it saves q, k and v, as gwkit's
    ``_flash_fwd``, and K1's row state beside them (:class:`RowState`)."""

    @staticmethod
    def forward(ctx, q, k, v):
        if not any(ctx.needs_input_grad):
            return attention_fwd(q, k, v)
        out, state = attention_fwd(q, k, v, save_state=True)
        ctx.save_for_backward(q, k, v, *state)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, *state = ctx.saved_tensors
        return attention_bwd(q, k, v, do, RowState(*state))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, T, H, 64) pre-scaled q, k, v -> (B, T, H, 64) attention output;
    differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v)


def attention_from_qkv(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Kernel A on the fused projection, under K3's contract:
    (B, T, 3D) [q | k | v] -> (B, T, D).

    q, k and v are read in place through row strides (no split, no
    transpose); the output comes back in the (B, T, D) layout the
    o-projection reads."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    if qkv.device.type == "cpu":
        q, k, v = (t.reshape(B, T, n_heads, D // n_heads) for t in qkv.split(D, dim=-1))
        return reference_attention(q, k, v).reshape(B, T, D)
    _cuda.require_cuda("attention_from_qkv", qkv)
    _cuda.require_bf16("attention_from_qkv", qkv)
    if not qkv.is_contiguous():
        raise ValueError("attention_from_qkv: tensor must be contiguous")
    if D != n_heads * HEAD_DIM:
        raise ValueError(f"attention_from_qkv: head dim {D // n_heads} (kernel takes {HEAD_DIM})")
    _cuda.require_aligned("attention_from_qkv", qkv)
    out = torch.empty((B, T, D), dtype=qkv.dtype, device=qkv.device)
    flat = qkv.view(-1)
    _launch(_cuda.library("attention"), _cuda.stream_of(qkv), flat, flat[D:], flat[2 * D:], out,
            B, T, n_heads, 3 * D, D, k1=False)
    return out
