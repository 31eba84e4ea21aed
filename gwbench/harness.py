"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the plain reference, and the result line.

    python3 gwbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``) runs from the start of the process through the kernel
build (served from the port's cache in the checkout after the first run),
the inputs made from the seed, the weights and the warm pass over the cell's
own shapes. The window then runs for ``--seconds`` and ends at the first
unit (a segment, a batch) that completes after it. ``memory_peak_bytes`` is
read, the port's state is freed, and the reference judges a sample of what
the window produced. The numbers compared are printed with their limits as
the last lines of standard error and under ``checks``, the last key of the
result line, which is the last line of standard output.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from typing import Dict, List, Optional

from gwbench import files

FORBIDDEN = ("jax", "jaxlib", "flax", "gwkit")


class Run:
    """What a driver is handed: the cell, its configuration and traffic
    mix, the seed, the device, the spans and the set-up clock's parts."""

    def __init__(self, cell: dict, config: dict, mix: dict, seed: int, device, trace: bool):
        from gwbench.tracing import Spans

        self.cell, self.config, self.mix, self.seed, self.device = cell, config, mix, seed, device
        self.trace = trace
        self.spans = Spans(trace)
        self.parts: Dict[str, float] = {}

    @contextlib.contextmanager
    def part(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t0


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="gwbench/run.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json (gwbench/workloads/<name>.json)")
    p.add_argument("--seed", required=True, type=int, help="makes the inputs and weights")
    p.add_argument("--seconds", required=True, type=float, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="0: end-to-end metrics; 1: profile a slice of the window, per-layer metrics")
    return p.parse_args(argv)


def leaked_modules() -> List[str]:
    """Modules of jax, jaxlib, flax or the JAX package loaded in this
    process, by whole top-level name (``gwkit_torch`` is not ``gwkit``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi (or why not)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def run_cell(args: argparse.Namespace, t_start: float, overrides: Optional[dict] = None,
             device=None) -> dict:
    """Set-up, window, trace and check of one cell; returns the result line
    as a dict (``checks`` last). ``overrides`` replace keys of the cell's
    ``config``, ``traffic``, ``params``, ``trace`` and ``check`` (the
    precision control and the tests' small sizes; never reachable from
    run.py), and ``device`` is a CPU device in the tests."""
    import torch

    bench = files.benchmark()
    over = overrides or {}
    cell = files.cell(args.workload)
    for key in ("params", "trace", "check"):
        cell[key] = {**cell[key], **over.get(key, {})}
    config = {**files.config(cell["config"]), **over.get("config", {})}
    mix = {**files.traffic(cell["traffic"]), **over.get("traffic", {})}
    if device is None:
        device = torch.device("cuda")
    run = Run(cell, config, mix, args.seed, device, bool(args.trace))
    drv = files.driver(cell["driver"]).Cell(run)
    setup_s = time.perf_counter() - t_start
    for name, secs in run.parts.items():
        print(f"gwbench: setup part {name} {secs:.3f} s", file=sys.stderr)
    print(f"gwbench: setup_s {setup_s:.3f}", file=sys.stderr)

    win = drv.window(args.seconds)
    on_card = device.type == "cuda"
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if on_card else 0}
    result = {"correct": False, "attempted": int(win["attempted"]), "failed": int(win["failed"])}
    metrics: Dict[str, dict] = {}
    breakdown = None
    if args.trace:
        ctx = drv.trace_slice()
        device_info["busy_s"] = ctx.busy_s
        device_info["window_s"] = ctx.window_s
        for name, spec in files.per_layer_for(cell["name"], bench).items():
            value = files.metric_reader(name).read(ctx)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": spec["unit"]}
        breakdown = ctx.breakdown()
    else:
        e2e = files.end_to_end_for(cell["name"], bench)
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        for name, value in win["metrics"].items():
            if name in e2e:
                metrics[name] = {"value": float(value), "unit": e2e[name]["unit"]}
    for line in win.get("notes", []):
        print(f"gwbench: {line}", file=sys.stderr)
    if on_card:
        print(f"gwbench: card {card_line()}", file=sys.stderr)

    t0 = time.perf_counter()
    checks = drv.check()
    print(f"gwbench: check_s {time.perf_counter() - t0:.3f}", file=sys.stderr)
    result["correct"] = bool(checks) and all(c["value"] <= c["limit"] for c in checks)
    result["metrics"] = metrics
    result["device"] = device_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    import torch

    cell = files.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"gwbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args, t_start)
    leaked = leaked_modules()
    if leaked:
        print(f"gwbench: forbidden modules loaded in the measured process: {', '.join(leaked)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
