"""Kernel A's one-pass path against its two-pass path at T = 256, on one
NVIDIA GPU (gwkit_torch only; no JAX).

    python3 scripts/torch_attention_passes.py

Builds csrc/attention.cu twice: as the port builds it (T <= 256 takes one
pass over the scores) and with -DGW_TWO_PASS_ONLY (every T takes two
passes). At the main layer (256 sequences x 6 heads x T = 256, K3's
contract, q, k, v read in place from the fused projection) and at the
training forward (128 x 6 x T = 256, K1's contract, contiguous) it holds
each build against the plain version (bf16 tolerance 2e-2 of the max, as
chip_smoke.py), compares the two builds' outputs, and times both: the
median of CUDA events around one call and the profiler's device time of
one call, in the order one, two, two, one. Prints one JSON line a shape,
then the card's name and power limit. Exits 1 on a disagreement and 2
without CUDA.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import TOL, bound_ms, device_ms, median_ms  # noqa: E402
from gwkit_torch.ops import _cuda  # noqa: E402
from gwkit_torch.ops import attention as A  # noqa: E402


def _two_pass_library():
    """attention.cu built with -DGW_TWO_PASS_ONLY beside the port's build."""
    import ctypes

    path = _cuda.library_path("attention").with_name(f"attention-two-pass-{_cuda._digest('attention')}.so")
    if not path.is_file():
        _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-DGW_TWO_PASS_ONLY", "-I", str(_cuda.CSRC),
                        "-o", str(path), str(_cuda.CSRC / "attention.cu")], check=True, capture_output=True)
    return _cuda.bind(ctypes.CDLL(str(path)), "attention")


def main():
    if not torch.cuda.is_available():
        print("torch_attention_passes: no CUDA device", file=sys.stderr)
        sys.exit(2)
    libs = {"one_pass": _cuda.library("attention"), "two_pass": _two_pass_library()}
    rng = np.random.default_rng(0)
    H, T, failed = 6, 256, []
    for label, B, k1 in (("main layer, K3 contract, in place", 256, False),
                         ("training forward, K1 contract, contiguous", 128, True)):
        q, k, v = (torch.from_numpy(rng.normal(size=(B, T, H, 64)).astype(np.float32) / (8 if i == 0 else 1))
                   .cuda().to(torch.bfloat16) for i in range(3))
        want = A.reference_attention(q, k, v)
        if k1:
            ops, ld = (q, k, v), H * 64
        else:  # views of one (B, T, 3D) projection, as attention_from_qkv reads them
            fused = torch.cat([t.reshape(B, T, H * 64) for t in (q, k, v)], dim=-1)
            flat = fused.view(-1)
            ops, ld = (flat, flat[H * 64:], flat[2 * H * 64:]), 3 * H * 64
        outs = {}

        def call(name):
            out = torch.empty_like(q)
            A._launch(libs[name], _cuda.stream_of(q), *ops, out, B, T, H, ld, H * 64, k1=k1)
            return out

        rec = {"shape": f"{B} seq x {H} heads x T={T}", "path": label}
        for name in libs:
            outs[name] = call(name)
            torch.cuda.synchronize()
            err = float((outs[name].float() - want.float()).abs().max())
            mean_err = float((outs[name].float() - want.float()).abs().mean())
            ok = err <= TOL[torch.bfloat16] * float(want.float().abs().max()) and \
                mean_err <= TOL[torch.bfloat16] * float(want.float().abs().mean())
            rec[f"{name}_max_abs_err"] = err
            if not ok:
                failed.append(f"{name} {label}")
        rec["outputs_bit_equal"] = bool(torch.equal(outs["one_pass"], outs["two_pass"]))
        rec["one_vs_two_max_abs_diff"] = float((outs["one_pass"].float() - outs["two_pass"].float()).abs().max())
        for key, fn in (("ms", median_ms), ("device_ms", device_ms)):
            for name in ("one_pass", "two_pass", "two_pass", "one_pass"):
                rec.setdefault(f"{name}_{key}", []).append(fn(lambda: call(name)))
        rec["bound_ms"], rec["bound_by"] = bound_ms(8 * B * T * H * 64, 4 * B * H * T * T * 64, torch.bfloat16)
        print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    if failed:
        print("torch_attention_passes: FAILED " + ", ".join(failed), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
