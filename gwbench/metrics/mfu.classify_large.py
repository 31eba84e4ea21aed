"""mfu: the whole step's model FLOPs (``gwbench.counts``: 4.55 TFLOP a
whisper-large-v3 sample at 1500 tokens) completed in the traced slice, over
its wall time and the card's dense bf16 peak (%)."""
from gwbench.readers import mfu_percent


def read(ctx):
    return mfu_percent(ctx)
