"""Kernel B's streamed kernel (hopper_wide_ln_gemm_kernel) against other
builds of it at a 1280-wide layer's launches, on one NVIDIA GPU (gwkit_torch
only; no JAX).

    python3 scripts/torch_wide_ln_gemm.py [--other DIR ...]

Builds csrc/ln_gemm.cu and the ln_gemm.cu of each --other checkout (another
commit's kernel, or a variant of this one, for a comparison on the same
card), all at once. Each build is held against the
float64 function at the card tests' rule (rms error within 1.1x and the
largest within 1.5x of the plain bf16 version's) at the four launches of a
whisper-large-v3 layer over 16 x 1500 rows (LN1 + QKV, o + residual, LN2 +
fc1 + tanh GELU, fc2 + residual; fc1 also with the erf GELU), at ragged
shapes (200 x 64 x 136, 333 x 640 x 200), at a row mean of 30 standard
deviations and at a grid that leaves the two consumer warpgroups unequal
numbers of tiles. Then each launch is timed by the profiler's device time
of one call (median of 20), the builds in turn and back (a b c c b a).
Prints one JSON line a launch and one for the layer's four, each build's
registers and spill bytes, then the card's name and power limit. Exits 1
on a disagreement and 2 without CUDA.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import bound_ms, device_ms  # noqa: E402
from gwkit_torch.ops import _cuda  # noqa: E402
from gwkit_torch.ops import fused_block as FB  # noqa: E402

M = 16 * 1500
D, F = 1280, 5120
# (name, K, N, LayerNorm, residual, GELU)
LAUNCHES = (("qkv", D, 3 * D, True, False, None), ("o", D, D, False, True, None),
            ("fc1_tanh", D, F, True, False, "tanh"), ("fc1_erf", D, F, True, False, "erf"),
            ("fc2", F, D, False, True, None))
LAYER = ("qkv", "o", "fc1_tanh", "fc2")


def _build(tag, src_dir):
    """(library path, the running nvcc)."""
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _cuda.BUILD_DIR / f"ln_gemm-wide-{tag}.so"
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(src_dir), "-o", str(path),
           str(Path(src_dir) / "ln_gemm.cu")]
    return path, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _ptxas(log):
    """{function: (registers, spill bytes)} from nvcc's -Xptxas -v, and
    ptxas's performance warnings under "warnings"."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Performance Loss" in ln:
            out.setdefault("warnings", []).append(ln.strip())
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            name = m.group(1)
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            out.setdefault(name, [None, 0])[1] = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            out.setdefault(name, [None, 0])[0] = int(m.group(1))
    return {k: v for k, v in out.items() if "wide" in k or k == "warnings"}


def _operands(m, k, n, ln, res, seed=0, offset=0.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, std=1.0: torch.randn(*s, generator=g, device="cuda") * std
    x = (r(m, k) + offset).bfloat16()
    w = r(k, n, std=k ** -0.5).bfloat16()
    bias = r(n, std=0.1)
    lnp = ((1 + r(k, std=0.1)).bfloat16(), r(k, std=0.1).bfloat16()) if ln else None
    return x, w, bias, lnp, (r(m, n).bfloat16() if res else None)


def _exact(x, w, bias, ln, res, act):
    h = x.double()
    if ln is not None:
        mean = h.mean(-1, keepdim=True)
        h = (h - mean) * torch.rsqrt((h - mean).square().mean(-1, keepdim=True) + 1e-5)
        h = h * ln[0].double() + ln[1].double()
    y = h @ w.double() + bias.double()
    if act is not None:
        y = torch.nn.functional.gelu(y, approximate="tanh" if act == "tanh" else "none")
    return y if res is None else y + res.double()


def _rms(t):
    return float(t.double().square().mean().sqrt())


def _within_plain(y, x, w, bias, lnp, r, act):
    want = _exact(x, w, bias, lnp, r, act)
    err, plain = y.double() - want, FB._ln_gemm_reference(x, w, bias, lnp, r, act).double() - want
    e = dict(rms=_rms(err), plain_rms=_rms(plain), max=float(err.abs().max()), plain_max=float(plain.abs().max()))
    e["ok"] = bool(torch.isfinite(y).all()) and e["rms"] <= 1.1 * e["plain_rms"] and e["max"] <= 1.5 * e["plain_max"]
    return e


def _odd_rows(lib):
    """Rows of a 1280 x 1280 launch without LayerNorm that give each cluster
    three items, so the first consumer warpgroup of a block takes two tiles
    and the second one."""
    cluster, rows, cols, clusters = (ctypes.c_int() for _ in range(4))
    _cuda.check(lib.gw_ln_gemm_wide_clusters(*(ctypes.byref(v) for v in (cluster, rows, cols, clusters))), "ln_gemm")
    groups = -(-3 * clusters.value // -(-D // cols.value))
    return groups * cluster.value * rows.value - 37


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", nargs="*", default=[], help="checkouts whose csrc/ln_gemm.cu to build and compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_wide_ln_gemm: no CUDA device", file=sys.stderr)
        sys.exit(2)
    builds = [("port", _cuda.CSRC)]
    for i, other in enumerate(args.other):
        builds.append((f"other{i}:{other}", Path(other) / "gwkit_torch" / "csrc"))
    procs = [(tag, *_build(re.sub(r"\W", "_", tag), src)) for tag, src in builds]
    libs, failed = {}, []
    for tag, path, proc in procs:
        log = proc.communicate()[0].decode()
        if proc.returncode:
            print(log[-6000:], file=sys.stderr)
            raise RuntimeError(f"{tag}: nvcc failed")
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _cuda._SIGNATURES["ln_gemm"]:
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, ctypes.c_int
        libs[tag] = lib
        print(json.dumps({"build": tag, "ptxas": _ptxas(log)}), flush=True)

    def use(tag):
        _cuda._libs["ln_gemm"] = libs[tag]

    # correctness: ragged, single-stage, 30 sigma, unequal tiles, then the layer's launches
    cases = [("ragged_k64", 200, 64, 136, True, False, "tanh", 0.0), ("ragged", 333, 640, 200, False, True, None, 0.0),
             ("mean_30sigma", 4000, D, D, True, False, "tanh", 30.0)]
    cases += [(name, M, k, n, ln, res, act, 0.0) for name, k, n, ln, res, act in LAUNCHES]
    for tag in libs:
        use(tag)
        edges = list(cases)
        if hasattr(libs[tag], "gw_ln_gemm_wide_clusters"):  # an older checkout's library lacks it
            edges.append(("odd_tiles", _odd_rows(libs[tag]), D, D, False, False, "tanh", 0.0))
        for name, m, k, n, ln, res, act, offset in edges:
            x, w, bias, lnp, r = _operands(m, k, n, ln, res, offset=offset)
            y = FB.ln_gemm(x, w, bias, ln=lnp, residual=r, act=act)
            e = _within_plain(y, x, w, bias, lnp, r, act)
            print(json.dumps({"build": tag, "check": name, "shape": [m, k, n], **e}), flush=True)
            if not e["ok"]:
                failed.append(f"{tag} {name}")
            del x, w, bias, lnp, r, y
            torch.cuda.empty_cache()
    if failed:
        print("torch_wide_ln_gemm: FAILED " + ", ".join(failed), file=sys.stderr)
        sys.exit(1)

    # times: the builds in turn and back, each launch's device time of one call
    order = list(libs) + list(libs)[::-1]
    per = {}
    for name, k, n, ln, res, act in LAUNCHES:
        x, w, bias, lnp, r = _operands(M, k, n, ln, res)
        fold = FB.ln_fold(w, bias, *lnp) if ln else None
        call = lambda: FB.ln_gemm(x, w, bias, ln=lnp, residual=r, act=act, fold=fold)
        times = {tag: [] for tag in libs}
        for tag in order:
            use(tag)
            times[tag].append(device_ms(call))
        n_bytes = 2 * (M * k + k * n + M * n * (2 if res else 1) + (2 * k if ln else 0)) + 4 * n
        b_ms, by = bound_ms(n_bytes, 2 * M * k * n, torch.bfloat16)
        per[name] = times
        print(json.dumps({"launch": name, "shape": [M, k, n], "bound_ms": b_ms, "bound_by": by, "device_ms": times,
                          "share_of_bound": {t: b_ms / min(v) for t, v in times.items()}}), flush=True)
        del x, w, bias, lnp, r, fold
        torch.cuda.empty_cache()
    layer = {tag: [sum(per[nm][tag][i] for nm in LAYER) for i in range(2)] for tag in libs}
    print(json.dumps({"layer": "qkv + o + fc1_tanh + fc2", "device_ms": layer}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
