"""Kernel A's time at T = 1500, measured four ways, or against the kernel A
of other checkouts, on one NVIDIA GPU (gwkit_torch only; no JAX).

    python3 scripts/torch_attention_timing.py [--other DIR ...]

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

With --other, csrc/attention.cu of each other checkout (another commit's
kernel A, or a variant of this one) is built beside this one, all at once,
and each build's registers, spill bytes and ptxas performance warnings are
printed. Every build must equal this one bit for bit (torch.equal) at
OTHER_CASES: K3 in place from a fused projection and K1 on contiguous
tensors, K1 with and without the backward's row state (m, l and the f32
output, compared too), at T = 257, 300 and 1430 (an odd tile count whose
padded last tile is all masked) and 1500, and at a grid whose persistent
blocks take unequal numbers of items. Then each build is timed at TIMED (the
profiler's device time of one call, median of 20) in turn and back (a b c c
b a), SDPA's beside it. Exits 1 on a difference.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import _attention_inputs, _ptxas, bound_ms, device_ms, median_ms  # noqa: E402
from gwkit_torch.ops import _cuda  # noqa: E402
from gwkit_torch.ops import attention as A  # noqa: E402

REPS = 20
# --other's bit-for-bit cases: (sequences, heads, T, contracts, score scales).
# 3 x 6 x T = 1500 is 216 items of 128 rows, so on a 132-SM card 84
# persistent blocks take two items and 48 take one.
OTHER_CASES = ((128, 6, 1500, ("K3",), (1.0,)), (16, 20, 1500, ("K3",), (1.0,)),
               (64, 6, 1500, ("K1", "K1 state"), (1.0,)), (16, 6, 257, ("K3", "K1", "K1 state"), (1.0, 60.0)),
               (16, 6, 300, ("K3", "K1", "K1 state"), (1.0, 60.0)),
               (16, 6, 1430, ("K3", "K1", "K1 state"), (1.0, 60.0)),
               (3, 6, 1500, ("K3", "K1", "K1 state"), (1e-3, 1.0, 60.0, 1e3)))
# --other's timed launches: (sequences, heads, T, contract)
TIMED = ((128, 6, 1500, "K3"), (16, 20, 1500, "K3"), (64, 6, 1500, "K1"), (64, 6, 1500, "K1 state"),
         (256, 6, 256, "K3"))


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


def _build(tag, checkout):
    """(library path, the running nvcc) of ``checkout``'s csrc/attention.cu."""
    src = Path(checkout) / "gwkit_torch" / "csrc"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _cuda.BUILD_DIR / f"attention-{tag}.so"
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(src), "-o", str(path), str(src / "attention.cu")]
    return path, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _operands(B, T, H, contract, scale, seed):
    """(call(lib) -> the outputs as a tuple, the inputs): K3 reads q, k, v in
    place from a fused (B, T, 3D) projection, K1 contiguous tensors, with
    the row state beside the output for "K1 state"."""
    q, k, v = _attention_inputs(np.random.default_rng(seed), B, T, H, scale, torch.bfloat16)
    if contract == "K3":
        fused = torch.cat([t.reshape(B, T, H * 64) for t in (q, k, v)], dim=-1).view(-1)
        ops, ld = (fused, fused[H * 64:], fused[2 * H * 64:]), 3 * H * 64
    else:
        ops, ld = (q, k, v), H * 64

    def call(lib):
        out = torch.empty((B, T, H, 64), dtype=torch.bfloat16, device="cuda")
        state = None
        if contract == "K1 state":
            rows = torch.zeros((2, B * H, A.state_rows(T)), dtype=torch.float32, device="cuda")
            state = A.RowState(rows[0], rows[1], torch.zeros((B, T, H, 64), dtype=torch.float32, device="cuda"))
        A._launch(lib, _cuda.stream_of(q), *ops, out, B, T, H, ld, H * 64, k1=contract != "K3", state=state)
        return (out,) if state is None else (out, *state)
    return call, (q, k, v)


def compare(others):
    builds = {"port": _cuda.library("attention")}
    logs = {"port": _cuda.library_path("attention").with_suffix(".log").read_text()}
    procs = [(f"other{i}", other, *_build(f"other{i}", other)) for i, other in enumerate(others)]
    for tag, other, path, proc in procs:
        logs[f"{tag}:{other}"] = proc.communicate()[0]
        if proc.returncode:
            print(logs[f"{tag}:{other}"][-6000:], file=sys.stderr)
            raise RuntimeError(f"{other}: nvcc failed")
        builds[f"{tag}:{other}"] = _cuda.bind(ctypes.CDLL(str(path)), "attention")
    for tag, log in logs.items():
        funcs, warnings = _ptxas(log)
        print(json.dumps({"build": tag, "ptxas": [f for f in funcs if "hopper_attention" in f["function"]],
                          "performance_warnings": warnings}), flush=True)

    failed = []
    for B, H, T, contracts, scales in OTHER_CASES:
        for contract in contracts:
            for scale in scales:
                call, _ = _operands(B, T, H, contract, scale, seed=B * 7919 + T)
                outs = {tag: call(lib) for tag, lib in builds.items()}
                torch.cuda.synchronize()
                base = outs["port"]
                equal = {tag: all(torch.equal(a, b) for a, b in zip(base, got)) for tag, got in outs.items()
                         if tag != "port"}
                print(json.dumps({"check": f"{B} seq x {H} heads x T={T}", "contract": contract, "scale": scale,
                                  "compared": ["output", "m", "l", "o32"][:len(base)], "bit_equal": equal,
                                  "finite": bool(torch.isfinite(base[0].float()).all())}), flush=True)
                failed += [f"{tag} {B}x{H}xT={T} {contract} scale {scale}" for tag, ok in equal.items() if not ok]
                del outs, base
                torch.cuda.empty_cache()
    if failed:
        print("torch_attention_timing: NOT BIT-EQUAL " + ", ".join(failed), file=sys.stderr)
        sys.exit(1)

    order = list(builds) + list(builds)[::-1]
    for B, H, T, contract in TIMED:
        call, (q, k, v) = _operands(B, T, H, contract, 1.0, seed=1)
        times = {tag: [] for tag in builds}
        for tag in order:
            times[tag].append(device_ms(lambda: call(builds[tag])))
        qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
        sdpa = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=1.0))
        b_ms, by = bound_ms(8 * B * T * H * 64, 4 * B * H * T * T * 64, torch.bfloat16)
        print(json.dumps({"timed": f"{B} seq x {H} heads x T={T}", "contract": contract, "device_ms": times,
                          "sdpa_device_ms": sdpa, "bound_ms": b_ms, "bound_by": by,
                          "share_of_bound": {t: b_ms / min(v) for t, v in times.items()},
                          "over_port": {t: min(v) / min(times["port"]) for t, v in times.items()}}), flush=True)
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", nargs="*", default=[], help="checkouts whose csrc/attention.cu to build and compare")
    args = ap.parse_args()
    if args.other:
        if not torch.cuda.is_available():
            print("torch_attention_timing: no CUDA device", file=sys.stderr)
            sys.exit(2)
        compare(args.other)
    else:
        main()
