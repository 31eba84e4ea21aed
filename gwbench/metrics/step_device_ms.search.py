"""step_device_ms: device ms per batch of the operations launched inside the
benchmark's ``score`` span (the model step: Q-scan, Q-adapter, encoder, head)."""
from gwbench.readers import device_ms_per_batch


def read(ctx):
    return device_ms_per_batch(ctx, labels=("score",))
