"""Readings of a cell's compared numbers over many seeds in one process,
for the program as configured, for its precision control (the reference
with its products and residual stream in float8 e4m3 in the model step's
place, the step below the configuration's bfloat16), or for the program
with a fault planted under its timed path (``gwbench.faults``):

    python3 gwbench/control.py --workload <cell> --variant program|fp8|half_batch|altered --seconds <s> --seeds <n> [<n> ...]

Each seed runs the cell's set-up, a window of ``--seconds`` and the check,
and prints one JSON line {"seed", "variant", "correct", "checks"}. The
benchmark's own runs (``run.py``) never take the control or a fault.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)

VARIANTS = ("program", "fp8", "half_batch", "altered")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--variant", choices=VARIANTS, default="fp8")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    from gwbench import files

    files.process_env()
    import torch

    from gwbench import faults, harness

    if not torch.cuda.is_available():
        print("gwbench control: no CUDA device", file=sys.stderr)
        return 2
    overrides = {"config": {"control": "fp8"}} if args.variant == "fp8" else {}
    fault = contextlib.nullcontext()
    if args.variant in faults.FAULTS:
        fault = faults.planted(files.cell(args.workload)["driver"], args.variant)
    with fault:
        for seed in args.seeds:
            run = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds, trace=0)
            res = harness.run_cell(run, time.perf_counter(), overrides)
            print(json.dumps({"seed": seed, "variant": args.variant, "correct": res["correct"],
                              "checks": res["checks"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
