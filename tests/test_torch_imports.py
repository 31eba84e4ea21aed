"""The port stands alone: every module of gwkit_torch imports with jax,
gwkit, h5py, safetensors and transformers blocked, and its entry points
refuse to run on the CPU unless asked to."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = r"""
import importlib.abc, importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "gwkit", "h5py", "safetensors", "transformers")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Block())
import gwkit_torch
names = [m.name for m in pkgutil.walk_packages(gwkit_torch.__path__, "gwkit_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print(len(names), "modules")
"""


def test_every_module_imports_with_jax_gwkit_and_hdf5_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[0]) >= 20


def test_blocker_tells_gwkit_torch_from_gwkit():
    """The blocker must refuse gwkit itself (so the pass above means something)."""
    code = _BLOCKER.split("import gwkit_torch")[0] + "import gwkit\n"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "blocked import: gwkit" in out.stderr


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    import numpy as np

    from gwkit_torch.cli import inference
    from gwkit_torch.device import resolve_device
    from gwkit_torch.models.qadapter import QAdapterConfig
    from gwkit_torch.models.whisper import WhisperConfig
    from gwkit_torch.search.engine import score_segments
    from gwkit_torch.search.slicer import DeviceSlicer, Segment
    from gwkit_torch.train.tasks import build_mlgwsc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    run = os.path.join(ROOT, "artifacts", "capstone_r5", "run")
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.load_task_from_components(
            os.path.join(run, "best_lora_weights"), os.path.join(run, "best_dense_layers.npz"),
            os.path.join(run, "best_adapter.npz"), target_shape=(80, 512))
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.main(["in.hdf", str(tmp_path / "out.hdf"), "--lora-weights", "l",
                        "--dense-weights", "d", "--adapter-weights", "a"])
    seg = Segment("seg", np.zeros((2, 4096), np.float32), 0.0, 1 / 2048)
    with pytest.raises(RuntimeError, match="CUDA"):
        score_segments(lambda w: w[:, 0, 0], [seg])
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceSlicer(seg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_mlgwsc(WhisperConfig(), QAdapterConfig(), {})
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_mixed_devices():
    """A wrapper given a CPU tensor takes the plain version; it never builds
    or launches anything, and it refuses operands it cannot launch on."""
    from gwkit_torch.ops import _cuda
    from gwkit_torch.ops.fused_block import ln_gemm

    _cuda.reset_counts()
    x = torch.randn(4, 32)
    y = ln_gemm(x, torch.randn(32, 8), torch.zeros(8))
    assert y.shape == (4, 8)
    assert _cuda.LAUNCHES == {"attention": 0, "ln_gemm": 0, "fused_mlp": 0}
    assert _cuda.PLAIN_CALLS == {"ln_gemm": 1}
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.require_cuda("ln_gemm", x)
