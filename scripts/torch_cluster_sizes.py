"""Kernels B, C and E with their weight slices shared by clusters of 1, 2 or
4 blocks, on one NVIDIA GPU (gwkit_torch only; no JAX).

    python3 scripts/torch_cluster_sizes.py

Builds csrc/ln_gemm.cu, csrc/fused_mlp.cu and csrc/int8_gemm.cu once a
cluster size (the port builds 2; -DGW_LN_GEMM_CLUSTER, -DGW_MLP_CLUSTER and
-DGW_INT8_CLUSTER set 1 or 4), all at once. At the main layer (65,536 rows,
D = 384: B's LN1 + QKV and o-projection with its residual, C with the tanh
GELU, E's four int8 launches of a layer: LN1 + QKV, o + residual,
LN2 + fc1 + GELU handing its row maxima to fc2 + residual) and at
whisper-base width (24,000 rows, D = 512, F = 2048) it holds each build
against the plain version (bf16 tolerance 2e-2 of the max and of the mean,
as chip_smoke.py; each E launch on the same inputs as its plain version)
and times it by the profiler's device time of one call, in the order 1, 2,
4, 4, 2, 1. A cluster of n reads each weight slice from L2 once for n
blocks: the L2 weight reads of a call are M / (128 n) x 4 D^2 x 2 bytes for
B's two launches, M / (64 n) x 2 D F x 2 bytes for C and, for E (1-byte
weights), M / (128 n) x (4 D^2 + D F) + M / (64 n) x D F bytes.
Prints one JSON line a shape, then the card's name and power limit. Exits
1 on a disagreement and 2 without CUDA.
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import TOL, device_ms  # noqa: E402
from gwkit_torch.ops import _cuda  # noqa: E402
from gwkit_torch.ops import fused_block as FB  # noqa: E402
from gwkit_torch.ops import fused_mlp as FM  # noqa: E402
from gwkit_torch.ops import int8_gemm as IG  # noqa: E402

SIZES = (1, 2, 4)
MACROS = {"ln_gemm": "GW_LN_GEMM_CLUSTER", "fused_mlp": "GW_MLP_CLUSTER", "int8_gemm": "GW_INT8_CLUSTER"}


def _libraries():
    """{(kernel, cluster size): library}, the port's own build for size 2."""
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, []
    for name, macro in MACROS.items():
        for n in SIZES:
            if n == 2:
                libs[(name, n)] = _cuda.library(name)
                continue
            path = _cuda.library_path(name).with_name(f"{name}-cluster{n}-{_cuda._digest(name)}.so")
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-D{macro}={n}", "-I", str(_cuda.CSRC), "-o", str(path),
                   str(_cuda.CSRC / f"{name}.cu")]
            procs.append((name, n, path, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for name, n, path, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name} cluster {n}: nvcc failed\n{log.decode()[-4000:]}")
        libs[(name, n)] = _cuda.bind(ctypes.CDLL(str(path)), name)
    return libs


def _agrees(got, want):
    d, w = (got.float() - want.float()).abs(), want.float().abs()
    tol = TOL[torch.bfloat16]
    return bool(torch.isfinite(got.float()).all()) and float(d.max()) <= tol * float(w.max()) \
        and float(d.mean()) <= tol * float(w.mean())


def main():
    if not torch.cuda.is_available():
        print("torch_cluster_sizes: no CUDA device", file=sys.stderr)
        sys.exit(2)
    libs = _libraries()
    rng = np.random.default_rng(0)
    dt = torch.bfloat16
    rand = lambda *s, sc=1.0: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32)).cuda()
    failed = []
    for label, D, M in (("main layer", 384, 65536), ("whisper-base width", 512, 24000)):
        F = 4 * D
        x, a = rand(M, D).to(dt), rand(M, D).to(dt)
        g, b = (1 + rand(D, sc=0.1)).to(dt), rand(D, sc=0.1).to(dt)
        wqkv, bqkv = rand(D, 3 * D, sc=D ** -0.5).to(dt), rand(3 * D, sc=0.1)
        wo, bo = rand(D, D, sc=D ** -0.5).to(dt), rand(D, sc=0.1)
        w1, b1, w2, b2 = rand(D, F, sc=D ** -0.5).to(dt), rand(F, sc=0.1), rand(F, D, sc=F ** -0.5).to(dt), rand(D, sc=0.1)
        x3 = x.view(1, M, D)
        q = [IG.QuantProj.of(w, bias) for w, bias in ((wqkv, bqkv), (wo, bo), (w1, b1), (w2, b2))]
        h = rand(M, F).to(dt)
        h_amax = h.float().abs().amax(dim=-1)
        calls = {"ln_gemm": lambda: (FB.ln_gemm(x, wqkv, bqkv, ln=(g, b)), FB.ln_gemm(a, wo, bo, residual=x)),
                 "fused_mlp": lambda: FM.fused_mlp_block(x3, g, b, w1, b1, w2, b2, approx=True),
                 "int8_gemm": lambda: (IG.int8_gemm(x, q[0], ln=(g, b)), IG.int8_gemm(a, q[1], residual=x),
                                       IG.int8_gemm(x, q[2], ln=(g, b), act="tanh", return_row_amax=True)[0],
                                       IG.int8_gemm(h, q[3], residual=x, row_amax=h_amax))}
        want = {"ln_gemm": (FB._ln_gemm_reference(x, wqkv, bqkv, (g, b)), FB._ln_gemm_reference(a, wo, bo, None, x)),
                "fused_mlp": (FM._unfused(x3, g, b, w1, b1.to(dt), w2, b2.to(dt), True),),
                "int8_gemm": (IG._int8_gemm_reference(x, q[0], (g, b)), IG._int8_gemm_reference(a, q[1], None, None, x),
                              IG._int8_gemm_reference(x, q[2], (g, b), "tanh"),
                              IG._int8_gemm_reference(h, q[3], None, None, x))}
        times = {name: {n: [] for n in SIZES} for name in MACROS}
        agree = {name: {} for name in MACROS}
        for n in SIZES + SIZES[::-1]:
            for name, call in calls.items():
                _cuda._libs[name] = libs[(name, n)]
                got = call()
                got = got if isinstance(got, tuple) else (got,)
                ok = all(_agrees(o, w) for o, w in zip(got, want[name]))
                agree[name][n] = ok
                if not ok:
                    failed.append(f"{label} {name} cluster {n}")
                times[name][n].append(device_ms(call, 10))
        for name in MACROS:
            _cuda._libs[name] = libs[(name, 2)]
        print(json.dumps({"shapes": f"{label}: {M} rows, D={D}, F={F}",
                          "device_ms": {name: {str(n): t for n, t in by_n.items()} for name, by_n in times.items()},
                          "agrees_with_plain": {name: {str(n): ok for n, ok in by.items()} for name, by in agree.items()},
                          "ln_gemm_l2_weight_gb": {str(n): M / (128 * n) * 4 * D * D * 2 / 1e9 for n in SIZES},
                          "fused_mlp_l2_weight_gb": {str(n): M / (64 * n) * 2 * D * F * 2 / 1e9 for n in SIZES},
                          "int8_gemm_l2_weight_gb": {str(n): (M / (128 * n) * (4 * D * D + D * F) + M / (64 * n) * D * F)
                                                     / 1e9 for n in SIZES}}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    if failed:
        print("torch_cluster_sizes: FAILED " + ", ".join(failed), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
