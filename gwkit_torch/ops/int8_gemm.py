"""int8 projections of the encoder layer (counterpart of the quant branch of
``gwkit/ops/fused_block.py``: ``_quantize_rows``, ``_quantize_cols``,
``_qdot``; K6 in the port's kernel table).

  y = epilogue(dequant(rowquant([LN](x)) . Wq))

Activations are quantized per row (symmetric, scale max|h| / 127 with a
1e-6 floor), weights per column (floor 1e-12), the product is summed in
int32 and dequantized as (f32(acc) * sx) * sw + bias in f32, then rounded
to the compute dtype. The epilogue adds nothing, GELU (tanh or erf, in the
compute dtype after that rounding) or a residual (in the compute dtype).

On CUDA tensors :func:`int8_gemm` runs kernel E (``csrc/int8_gemm.cu``)
in bfloat16, the s8 wgmma/TMA kernel (``hopper_int8_gemm_kernel``), which
reads the weight K-major (``QuantProj.wt``); on CPU tensors
``_int8_gemm_reference``, the plain version built
from the three helpers below. The plain product sums the int8 products in
float64, which is exact at these sizes (|acc| <= 127^2 * K < 2^53), as
gwkit's int32 sum is.

fc2 quantizes each row of fc1's output by its maximum over all of F: fc1's
launch can return each row's max |y| (``return_row_amax``), and fc2's takes
it (``row_amax``) and reads its input once. A maximum does not depend on
order, so the handover is exact.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from gwkit_torch.ops import _cuda
from gwkit_torch.ops.fused_mlp import _gelu
from gwkit_torch.ops.fused_mlp import _ln as _ln_f32

# epilogue codes shared with csrc/int8_gemm.cu
_ACT_CODES = {None: 0, "tanh": 1, "erf": 2}


@dataclasses.dataclass
class QuantProj:
    """One int8 projection: weight (K, N) int8, per-column scale and bias (N,)
    f32, and the weight's K-major copy ``wt`` (N, K), made once here, which
    the bf16 kernel reads (8-bit wgmma takes both operands K-major only)."""
    w: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor
    wt: torch.Tensor

    @classmethod
    def of(cls, w: torch.Tensor, bias: torch.Tensor) -> "QuantProj":
        wq, sw = _quantize_cols(w)
        return cls(wq.contiguous(), sw.contiguous(), bias.float().contiguous(), wq.t().contiguous())


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division on every device: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal, which can miss by one
    bit."""
    return t / torch.tensor(127.0, device=t.device)


def _quantize_rows(h: torch.Tensor, row_amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of an (R, K) f32 tile: (int8
    values, (R, 1) f32 scales). All-zero rows quantize to zeros with scale
    1e-6/127. ``torch.round`` rounds half to even, as ``jnp.round``.
    ``row_amax`` (R,): each row's max |h|, handed over instead of taken."""
    amax = h.abs().amax(dim=-1, keepdim=True) if row_amax is None else row_amax.float().reshape(-1, 1)
    sx = _div127(torch.clamp_min(amax, 1e-6))
    return torch.clamp(torch.round(h / sx), -127.0, 127.0).to(torch.int8), sx


def _quantize_cols(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column symmetric int8 quantization of a (K, N) weight, taken in
    f32: (int8 values, (N,) f32 scales)."""
    w = w.float()
    sw = _div127(torch.clamp_min(w.abs().amax(dim=0), 1e-12))
    return torch.clamp(torch.round(w / sw), -127.0, 127.0).to(torch.int8), sw


def _qdot(h: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
          bias: Optional[torch.Tensor] = None, row_amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized projection of (R, K) rows: row-quantize ``h`` in f32 (by the
    handed-over ``row_amax`` if given), the exact integer product, dequantize
    by row x column scales, + bias (f32)."""
    hq, sx = _quantize_rows(h.float(), row_amax)
    y = (hq.double() @ wq.double()).float() * sx * sw.float()
    return y if bias is None else y + bias.float()


def _int8_gemm_reference(x2, proj: QuantProj, ln=None, act: Optional[str] = None, residual=None,
                         row_amax=None, return_row_amax: bool = False):
    """Plain version of kernel E, gwkit's in-kernel composition:
    [_ln_f32] -> _qdot -> round to x's dtype -> [GELU | + residual]; with
    ``return_row_amax`` also each output row's max |y| in f32."""
    _cuda.count_plain("int8_gemm")
    h = _ln_f32(x2, *ln) if ln is not None else x2
    y = _qdot(h, proj.w, proj.scale, proj.bias, row_amax).to(x2.dtype)
    if act is not None:
        y = _gelu(y, act == "tanh")
    y = y if residual is None else residual + y
    return (y, y.abs().amax(dim=-1).float()) if return_row_amax else y


def _launch(lib, stream: int, x2, proj: QuantProj, ln, act: int, residual, row_amax, amax_out, y) -> None:
    M, K = x2.shape
    N = proj.w.shape[1]
    g, b = ln if ln is not None else (None, None)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.gw_int8_gemm(x2.data_ptr(), ptr(g), ptr(b), proj.w.data_ptr(), proj.wt.data_ptr(),
                           proj.scale.data_ptr(), proj.bias.data_ptr(), ptr(residual), ptr(row_amax),
                           ptr(amax_out), y.data_ptr(), M, N, K, act, _cuda.BF16_CODE, stream)
    _cuda.check(err, "int8_gemm")
    _cuda.LAUNCHES["int8_gemm"] += 1


def _check_shapes(x2, proj: QuantProj, ln, residual, row_amax) -> None:
    """What the kernel takes (csrc/int8_gemm.cu, gw_int8_gemm); raises on anything else."""
    M, K = x2.shape
    N = proj.w.shape[1]
    if proj.w.dtype != torch.int8 or proj.w.shape[0] != K or tuple(proj.wt.shape) != (N, K) \
            or proj.wt.dtype != torch.int8 \
            or any(t.dtype != torch.float32 or tuple(t.shape) != (N,) for t in (proj.scale, proj.bias)) \
            or (residual is not None and tuple(residual.shape) != (M, N)) \
            or (row_amax is not None and (tuple(row_amax.shape) != (M,) or row_amax.dtype != torch.float32)) \
            or any(tuple(t.shape) != (K,) for t in ln or ()):
        raise ValueError(f"int8_gemm: x {tuple(x2.shape)}, w {tuple(proj.w.shape)} {proj.w.dtype}, wt "
                         f"{tuple(proj.wt.shape)}, scale/bias {tuple(proj.scale.shape)}/{tuple(proj.bias.shape)} "
                         "(f32), row_amax (M,) f32")
    if K % 128 or N % 128 or K > (512 if row_amax is None else 2048):
        raise ValueError(f"int8_gemm: K {K}, N {N}; K and N must be multiples of 128, K at most 512, or 2048 "
                         "with each row's maximum handed over (row_amax: fc2 after fc1)")


def int8_gemm(x2: torch.Tensor, proj: QuantProj, ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              act: Optional[str] = None, residual: Optional[torch.Tensor] = None,
              row_amax: Optional[torch.Tensor] = None, return_row_amax: bool = False):
    """Kernel E on (M, K) rows: [LN(x)] quantized per row times ``proj``'s
    int8 (K, N) weight, dequantized, + bias, then GELU (``act`` "tanh" or
    "erf") or + ``residual`` (M, N). On CUDA x, the LN scale/shift and the
    residual are in bfloat16, scales and bias f32.

    ``row_amax`` (M,) f32: each row's max |x|, handed over by the launch that
    wrote x (no LN then); ``return_row_amax``: also return each output row's
    max |y| as (y, (M,) f32), for the next launch (not with ``row_amax``)."""
    if act not in _ACT_CODES:
        raise ValueError(f"int8_gemm: act {act!r} (takes None, 'tanh' or 'erf')")
    if act is not None and residual is not None:
        raise ValueError("int8_gemm: the epilogue is GELU or a residual, not both")
    if row_amax is not None and (ln is not None or return_row_amax):
        raise ValueError("int8_gemm: row_amax is the maximum of x's rows: no LayerNorm, and no row maximum out")
    ops = [x2, proj.w, proj.wt, proj.scale, proj.bias, residual, row_amax] + list(ln or ())
    if x2.device.type == "cpu":
        if any(t is not None and t.device.type != "cpu" for t in ops):
            raise ValueError("int8_gemm: operands on more than one device")
        return _int8_gemm_reference(x2, proj, ln, act, residual, row_amax, return_row_amax)
    _cuda.require_cuda("int8_gemm", *ops)
    _cuda.require_bf16("int8_gemm", x2)
    dt = x2.dtype
    _check_shapes(x2, proj, ln, residual, row_amax)
    for t in [x2, residual, *(ln or ())]:
        if t is not None and (t.dtype != dt or not t.is_contiguous()):
            raise ValueError("int8_gemm: x, LN and residual must be contiguous and share x's dtype")
    if not all(t.is_contiguous() for t in (proj.w, proj.wt, proj.scale, proj.bias)) \
            or (row_amax is not None and not row_amax.is_contiguous()):
        raise ValueError("int8_gemm: weights, scale, bias and row_amax must be contiguous")
    _cuda.require_aligned("int8_gemm", *(t for t in (x2, proj.w, proj.wt, residual) if t is not None))
    M, N = x2.shape[0], proj.w.shape[1]
    y = torch.empty((M, N), dtype=dt, device=x2.device)
    amax_out = torch.empty(M, dtype=torch.float32, device=x2.device) if return_row_amax else None
    _launch(_cuda.library("int8_gemm"), _cuda.stream_of(x2), x2, proj, ln, _ACT_CODES[act], residual, row_amax,
            amax_out, y)
    return (y, amax_out) if return_row_amax else y
