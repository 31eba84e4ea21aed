"""Kernel A's time at T = 1500, measured four ways, on one NVIDIA GPU
(gwkit_torch only; no JAX).

    python3 scripts/torch_attention_timing.py

At the mel path's shapes (64 and 128 sequences x 6 heads x T = 1500, bf16;
K3's contract with q, k, v read in place from a fused projection, as
attention_from_qkv reads them in the encoder layer, and K1's through
flash_attention on contiguous tensors) it times kernel A and SDPA on the
same inputs: the median of CUDA events around one call
(chip_smoke.median_ms), the profiler's device time of one call
(chip_smoke.device_ms, calls apart by a synchronize and 2 ms of sleep),
CUDA events around 20 back-to-back calls over 20, and the profiler's
kernel time summed over 20 back-to-back calls over 20. Inputs are the
scale-1 inputs of chip_smoke.py's phase 3. Prints one JSON line a shape
and contract, the card's clocks after the runs, then the card's name and
power limit. Exits 2 without CUDA.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import _attention_inputs, bound_ms, device_ms, median_ms  # noqa: E402
from gwkit_torch.ops import attention as A  # noqa: E402

REPS = 20


def back_to_back_ms(fn, reps=REPS):
    """CUDA events around ``reps`` calls issued back to back, over ``reps``."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def profiled_back_to_back_ms(fn, reps=REPS):
    """The profiler's kernel time summed over ``reps`` back-to-back calls, over ``reps``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(float(getattr(e, "self_device_time_total", 0.0) or 0.0) for e in prof.key_averages()
             if "cuda" in str(getattr(e, "device_type", "")).lower())
    return us / 1e3 / reps


def main():
    if not torch.cuda.is_available():
        print("torch_attention_timing: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    H, T = 6, 1500
    for B in (64, 128):
        q, k, v = _attention_inputs(rng, B, T, H, 1.0, torch.bfloat16)
        fused = torch.cat([t.reshape(B, T, H * 64) for t in (q, k, v)], dim=-1)
        qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
        calls = {"K3 in place": lambda: A.attention_from_qkv(fused, H),
                 "K1 contiguous": lambda: A.flash_attention(q, k, v),
                 "SDPA": lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=1.0)}
        b_ms, by = bound_ms(8 * B * T * H * 64, 4 * B * H * T * T * 64, torch.bfloat16)
        for name, fn in calls.items():
            print(json.dumps({"shape": f"{B} seq x {H} heads x T={T}", "call": name,
                              "events_one_call_ms": median_ms(fn, 15), "device_one_call_ms": device_ms(fn, 15),
                              "events_back_to_back_ms": back_to_back_ms(fn),
                              "profiler_back_to_back_ms": profiled_back_to_back_ms(fn),
                              "bound_ms": b_ms, "bound_by": by}), flush=True)
        del q, k, v, fused, qh, kh, vh
        torch.cuda.empty_cache()
    smi = lambda query: subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                                       capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"clocks_sm_and_max_after": smi("clocks.sm,clocks.max.sm")}))
    print(smi("name,power.limit"))


if __name__ == "__main__":
    main()
