"""ctypes bindings for the host-IO runtime, ``gwkit_torch/csrc/hostio.cpp``
(counterpart of ``gwkit/native/hostio.py``, with gwkit's signatures).

The library is host code (no device code, no ``nvcc``): ``g++ -O3 -shared
-fPIC -std=c++17 -lpthread`` builds it at first use into
``gwkit_torch/_build/`` under a name keyed by a hash of the source, as
``gwkit_torch/ops/_cuda.py`` builds the kernels. Without a compiler
:func:`f64_to_f32` and :func:`extract_windows` fall back to numpy (the same
values) and the readers are unavailable; a failed build is logged with the
compiler's output.

The search's fast path: an uncompressed, contiguous HDF5 dataset exposes its
file offset (h5py's ``ds.id.get_offset()``), so a segment is read by a C++
thread, f64 converted to f32 there, while the card scores the previous one.
h5py is used only inside :func:`dataset_prefetch_meta` and
:func:`read_contiguous_dataset`; :class:`ChunkLoader` and
:class:`ArrayPrefetch` take a path and a byte offset.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "hostio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"hostio-{h.hexdigest()[:16]}.so"


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    out = library_path()
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
                                  capture_output=True, text=True)
        except FileNotFoundError:
            logging.warning("hostio: g++ not found; the numpy fallbacks run and the C++ readers "
                            "are unavailable")
            _build_failed = True
            return None
        if proc.returncode != 0:
            logging.warning("hostio: g++ exited %d building %s:\n%s", proc.returncode, SOURCE,
                            proc.stderr)
            _build_failed = True
            return None
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.f64_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    lib.f64_to_f32.restype = None
    lib.extract_windows.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                                    ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_void_p]
    lib.extract_windows.restype = None
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_long]
    lib.loader_next.restype = ctypes.c_long
    lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.loader_destroy.restype = None
    lib.prefetch_create.restype = ctypes.c_void_p
    lib.prefetch_create.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int]
    lib.prefetch_wait.restype = ctypes.c_long
    lib.prefetch_wait.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.prefetch_destroy.argtypes = [ctypes.c_void_p]
    lib.prefetch_destroy.restype = None
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is None and not _build_failed:
            _lib = _build()
        return _lib


def available() -> bool:
    """True when the C++ library is built (built now if needed)."""
    return _get() is not None


def f64_to_f32(src: np.ndarray) -> np.ndarray:
    lib = _get()
    src = np.ascontiguousarray(src, np.float64)
    if lib is None:
        return src.astype(np.float32)
    dst = np.empty(src.shape, np.float32)
    lib.f64_to_f32(src.ctypes.data, dst.ctypes.data, src.size)
    return dst


def extract_windows(src: np.ndarray, starts: np.ndarray, window: int) -> np.ndarray:
    """(D, N) f32 and window starts -> (count, D, window) f32."""
    lib = _get()
    src = np.ascontiguousarray(src, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    d, n = src.shape
    if len(starts) and (starts.min() < 0 or starts.max() + window > n):
        raise ValueError(f"extract_windows: a window of {window} leaves the {n} samples")
    if lib is None:
        return np.stack([src[:, s: s + window] for s in starts])
    dst = np.empty((len(starts), d, window), np.float32)
    lib.extract_windows(src.ctypes.data, d, n, starts.ctypes.data, len(starts), window, dst.ctypes.data)
    return dst


def _need_lib() -> ctypes.CDLL:
    lib = _get()
    if lib is None:
        raise RuntimeError("hostio: the C++ library is unavailable (no g++, or its build failed)")
    return lib


class ChunkLoader:
    """Double-buffered background reader of a contiguous on-disk f64/f32
    array: iterating yields f32 chunks of up to ``chunk_elems``."""

    def __init__(self, path: str, offset_bytes: int, n_elems: int, on_disk_f64: bool = True,
                 chunk_elems: int = 1 << 22):
        self._lib = _need_lib()
        self._chunk = chunk_elems
        self._handle = self._lib.loader_create(path.encode(), offset_bytes, n_elems,
                                               0 if on_disk_f64 else 1, chunk_elems)
        if not self._handle:
            raise IOError(f"loader_create failed for {path}")

    def __iter__(self):
        buf = np.empty(self._chunk, np.float32)
        while True:
            got = self._lib.loader_next(self._handle, buf.ctypes.data)
            if got <= 0:
                break
            yield buf[:got].copy()

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class ArrayPrefetch:
    """A whole contiguous on-disk f64/f32 array read by a C++ thread (no GIL);
    :meth:`wait` blocks, the GIL released inside the ctypes call, and returns
    the f32 array. The search reads segment i+1 so while the card scores
    segment i."""

    def __init__(self, path: str, offset_bytes: int, shape, on_disk_f64: bool):
        self._lib = _need_lib()
        self._shape = tuple(shape)
        self._n = int(np.prod(shape))
        self._handle = self._lib.prefetch_create(path.encode(), int(offset_bytes), self._n,
                                                 0 if on_disk_f64 else 1)
        if not self._handle:
            raise IOError(f"prefetch_create failed for {path}")

    def wait(self) -> np.ndarray:
        out = np.empty(self._n, np.float32)
        got = self._lib.prefetch_wait(self._handle, out.ctypes.data)
        self.close()
        if got != self._n:
            raise IOError(f"prefetch read {got}/{self._n} elements")
        return out.reshape(self._shape)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.prefetch_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def _contiguous_offset(dataset) -> Optional[int]:
    """The file offset of an uncompressed contiguous h5py dataset, else None."""
    offset = dataset.id.get_offset()
    if offset is None or dataset.compression is not None:
        return None
    return int(offset)


def dataset_prefetch_meta(dataset) -> Optional[tuple]:
    """(offset_bytes, shape, on_disk_f64) of a contiguous, uncompressed f64 or
    f32 h5py dataset (one :class:`ArrayPrefetch` can read); else None."""
    offset = _contiguous_offset(dataset)
    if offset is None or dataset.dtype not in (np.float64, np.float32):
        return None
    return offset, tuple(dataset.shape), dataset.dtype == np.float64


def read_contiguous_dataset(path: str, dataset, chunk_elems: int = 1 << 22) -> Optional[np.ndarray]:
    """An h5py dataset read through :class:`ChunkLoader` when it is
    contiguous, uncompressed f64; None when the fast path does not apply.
    An f32 dataset takes None too, as in gwkit: it has no conversion to
    hide, and h5py's direct read beats the loader's copies."""
    offset = _contiguous_offset(dataset)
    if offset is None or dataset.dtype != np.float64 or not available():
        return None
    n = int(np.prod(dataset.shape))
    out = np.empty(n, np.float32)
    pos = 0
    loader = ChunkLoader(path, offset, n, True, chunk_elems)
    try:
        for chunk in loader:
            out[pos: pos + len(chunk)] = chunk
            pos += len(chunk)
    finally:
        loader.close()
    return out.reshape(dataset.shape) if pos == n else None
