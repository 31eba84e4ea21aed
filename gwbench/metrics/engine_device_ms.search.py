"""engine_device_ms: device ms per batch of the operations launched outside
the benchmark's ``score`` span (the engine, slicer and whitening)."""
from gwbench.readers import device_ms_per_batch


def read(ctx):
    return device_ms_per_batch(ctx, outside=("score",))
