"""What the per-layer readers under ``metrics/`` share. Each reader takes a
``tracing.TraceSlice`` whose ``extra`` the driver filled (``batches``,
``model_flops``, ``bounds``, ``peak``) and returns a number, or None where
the slice holds nothing to read: the harness then leaves the metric out."""
from __future__ import annotations

import sys
from typing import Optional, Tuple

from gwbench.tracing import HAND_WRITTEN, TraceSlice


def idle_percent(ctx: TraceSlice) -> Optional[float]:
    """100 * (1 - union of device-operation intervals / the slice's wall)."""
    if ctx.window_s <= 0 or not ctx.ops:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)


def mfu_percent(ctx: TraceSlice) -> Optional[float]:
    """The model FLOPs the slice completed over its wall time, as a share of
    the card's dense bf16 peak."""
    peak, flops = ctx.extra.get("peak"), ctx.extra.get("model_flops")
    if peak is None or not flops or ctx.window_s <= 0:
        return None
    return 100.0 * flops / (ctx.window_s * peak["bf16_flops_per_s"])


def roofline_percent(ctx: TraceSlice, kernel: str) -> Optional[float]:
    """The least time of the kernel's launches in the slice (``counts``) over
    their device time. The launches the port counted must equal the trace's
    events of that kernel, or nothing is read."""
    group = HAND_WRITTEN[kernel]
    n = ctx.launches.get(kernel, 0)
    least = ctx.extra.get("bounds", {}).get(kernel)
    if n == 0 or least is None or ctx.extra.get("peak") is None:
        return None
    if ctx.count(group) != n:
        print(f"gwbench: {kernel}: {n} launches counted, {ctx.count(group)} in the trace; no roofline read",
              file=sys.stderr)
        return None
    dev = ctx.seconds(group=group)
    return 100.0 * n * least / dev if dev > 0 else None


def device_ms_per_batch(ctx: TraceSlice, labels: Optional[Tuple[str, ...]] = None,
                        outside: Optional[Tuple[str, ...]] = None) -> Optional[float]:
    """Device milliseconds per batch of the slice, of the operations launched
    under ``labels`` (or under none of ``outside``)."""
    batches = ctx.extra.get("batches", 0)
    if not batches or not ctx.ops:
        return None
    return 1e3 * ctx.seconds(labels=labels, outside=outside) / batches
