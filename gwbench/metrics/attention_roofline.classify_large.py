"""attention_roofline: the least time of kernel attention's launches in the traced
slice (larger of ops at the bf16 peak and bytes at HBM bandwidth,
``gwbench.counts_split.layer_launches``) over their device time (%)."""
from gwbench.readers import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "attention")
