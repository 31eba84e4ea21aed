"""Operations and bytes of an encoder layer whose MLP runs as two launches
of kernel B (the port's chain past kernel C's widths: B -> A -> B -> B ->
B), counted from shapes under ``counts``' rules: each input byte read
once, each output byte written once, LayerNorm parameters and biases f32,
a projection one product with its effective (DoRA-folded) weight."""
from __future__ import annotations

from typing import Dict, List, Tuple


def layer_launches(sequences: int, T: int, d: int, F: int, heads: int,
                   itemsize: int) -> Dict[str, List[Tuple[int, int]]]:
    """(bytes, flops) of each kernel launch of one layer over ``sequences``
    x ``T`` tokens: ln_gemm's four (LayerNorm + QKV; o-projection +
    residual; LayerNorm + fc1 + GELU, whose (M, F) activation is written;
    fc2 + residual, which reads it) and attention's one."""
    M = sequences * T
    qkv = (itemsize * (M * d + d * 3 * d + 2 * d + M * 3 * d) + 4 * 3 * d, 2 * M * 3 * d * d)
    o = (itemsize * (M * d + d * d + 2 * M * d) + 4 * d, 2 * M * d * d)
    fc1 = (itemsize * (M * d + d * F + 2 * d + M * F) + 4 * F, 2 * M * d * F)
    fc2 = (itemsize * (M * F + F * d + 2 * M * d) + 4 * d, 2 * M * F * d)
    att = (itemsize * 4 * M * d, 4 * sequences * heads * T * T * (d // heads))
    return {"ln_gemm": [qkv, o, fc1, fc2], "attention": [att]}
