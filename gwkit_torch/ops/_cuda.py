"""Build, load and count the hand-written CUDA kernels (``gwkit_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries are built at first use
into ``gwkit_torch/_build/`` under a name keyed by a hash of the sources, so
a changed source rebuilds and a fresh checkout builds on its own;
:func:`build` starts one ``nvcc`` per source at once.

Nothing is imported or compiled when this module is imported: the CPU tests
import every module of the package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

from gwkit_torch.utils.tracing import COUNTERS

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("attention", "attention_bwd", "ln_gemm", "fused_mlp", "int8_gemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the dtype argument of every C entry point (GW_BF16 in csrc/common.cuh): the kernels take bfloat16 only
BF16_CODE = 1

# Launches per kernel: each wrapper adds one where it launches its kernel.
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
# Calls of the plain (PyTorch) versions, by name; a run on the kernels keeps these at 0.
PLAIN_CALLS: Dict[str, int] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
# each library's C entry points: (name, argtypes); kernel B's second is its streamed bf16 path
_SIGNATURES = {
    "attention": (("gw_attention", [_P] * 7 + [_I] * 8 + [_P]),),
    "attention_bwd": (("gw_attention_bwd", [_P] * 11 + [_I] * 8 + [_P]),),
    "ln_gemm": (("gw_ln_gemm", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
                ("gw_ln_gemm_wide", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
                ("gw_ln_gemm_wide_clusters", [_P] * 4)),
    "fused_mlp": (("gw_fused_mlp", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),),
    "int8_gemm": (("gw_int8_gemm", [_P] * 11 + [_I] * 5 + [_P]),),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    PLAIN_CALLS.clear()


def count_plain(name: str) -> None:
    PLAIN_CALLS[name] = PLAIN_CALLS.get(name, 0) + 1


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all at once.
    Writes each compiler log (``-Xptxas -v``: registers, spills) beside the
    library as ``<lib>.log``. Raises with the log if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = []
    for name, out in paths.items():
        if out.is_file():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log = proc.communicate()[0]
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            COUNTERS["builds"] += 1
            path = build([name])[name]
            _libs[name] = lib = bind(ctypes.CDLL(str(path)), name)
        return lib


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Set the argument and result types of library ``name``'s entry points on ``lib``."""
    for fn_name, argtypes in _SIGNATURES[name]:
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: cudaError {err}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t is not None and not t.is_cuda:
            raise ValueError(f"{name}: every operand must be on the CUDA device")


def require_bf16(name: str, *tensors: torch.Tensor) -> None:
    """On the card the kernel chain takes bfloat16 only; ``None`` operands pass."""
    for t in tensors:
        if t is not None and t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: dtype {t.dtype}: on the card the kernel chain takes bfloat16; "
                            "float32 runs the plain layer (fused_block=False)")


def require_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The kernels copy global memory in 16-byte pieces."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand not 16-byte aligned (a view at an odd offset?)")
