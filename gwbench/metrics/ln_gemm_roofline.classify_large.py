"""ln_gemm_roofline: the least time of kernel ln_gemm's launches in the traced
slice, four a layer (LayerNorm + QKV, o-projection + residual, LayerNorm +
fc1 + GELU, fc2 + residual; larger of ops at the bf16 peak and bytes at HBM
bandwidth, ``gwbench.counts_split.layer_launches``) over their device time (%)."""
from gwbench.readers import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "ln_gemm")
