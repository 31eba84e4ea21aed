"""Finding the benchmark's data by name: every configuration, cell, traffic
mix, driver and per-layer metric is a file of its own under ``gwbench/``,
so a later change adds one by adding a file.

  configs/<config>.json      the model configuration as it is run
  workloads/<cell>.json      a cell: its config, traffic, driver, chips, why,
                             parameters, traced slice and correctness limits
  traffic/<mix>.json         a traffic mix's parameters (``gwbench.generate``)
  drivers/<driver>.py        the entry a cell drives (a ``Cell`` class)
  metrics/<metric>.py        a per-layer metric's reader (``read(ctx)``)
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout: BENCHMARK.json, gwkit_torch/, artifacts/
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def process_env(root: Path = ROOT) -> None:
    """Set before torch is imported. Triton's, PyTorch's extension and CUDA's
    JIT caches at fixed paths inside the checkout (the port keeps its own
    kernels in ``gwkit_torch/_build/``), and one thread for OpenMP and the
    BLAS libraries: the load is one process whose host work is a Python
    loop feeding the card, and pool threads beside it could only compete
    with that loop for a shared host's cores."""
    cache = root / ".gwbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[name] = "1"


def _name(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r}: letters, digits, '_', '.' and '-' only, at most 64")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(name: str, here: Path = HERE) -> dict:
    spec = _json(here / "workloads" / f"{_name('cell', name)}.json")
    if spec.get("name") != name:
        raise ValueError(f"workloads/{name}.json names itself {spec.get('name')!r}")
    return spec


def config(name: str, here: Path = HERE) -> dict:
    spec = _json(here / "configs" / f"{_name('config', name)}.json")
    if spec.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself {spec.get('name')!r}")
    return spec


def traffic(name: str, here: Path = HERE) -> dict:
    return _json(here / "traffic" / f"{_name('traffic', name)}.json")


def _module(path: Path, qualname: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(qualname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, here: Path = HERE) -> ModuleType:
    return _module(here / "drivers" / f"{_name('driver', name)}.py", f"gwbench.drivers.{name}")


def metric_reader(name: str, here: Path = HERE) -> ModuleType:
    """The reader of per-layer metric ``name`` (dots allowed in the file name)."""
    return _module(here / "metrics" / f"{_name('metric', name)}.py", f"gwbench_metric_{name.replace('.', '_')}")


def names(kind: str, here: Path = HERE) -> List[str]:
    """Every name of ``kind`` ("workloads", "configs", "traffic", "drivers", "metrics") present."""
    suffix = ".py" if kind in ("drivers", "metrics") else ".json"
    return sorted(p.name[: -len(suffix)] for p in (here / kind).glob(f"*{suffix}") if not p.name.startswith("_"))


def per_layer_for(cell_name: str, bench: dict) -> Dict[str, dict]:
    """The per-layer metrics that cell ``cell_name`` reports: those listing it
    under ``workloads``, and those without the key whose ``moves`` metric the
    cell reports."""
    reported = {m["name"] for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])}
    out = {}
    for m in bench["per_layer"]:
        if cell_name in m.get("workloads", [cell_name] if m["moves"] in reported else []):
            out[m["name"]] = m
    return out


def end_to_end_for(cell_name: str, bench: dict) -> Dict[str, dict]:
    return {m["name"]: m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])}


def checkout_path(rel: str, root: Optional[Path] = None) -> Path:
    """A path relative to the checkout's root (weights in the repository)."""
    return (root or ROOT) / rel
