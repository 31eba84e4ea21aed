"""On the card: the precision control, the reference with its encoder
products in float8 in place of the port's bfloat16 model step, is not
correct on three seeds at each cell's own size (a short window). Run on a
card with ``python -m pytest gwbench/tests -m card``; elsewhere each test
skips."""
import argparse
import time

import pytest
import torch

from gwbench import files, harness

CELLS = [w["name"] for w in files.benchmark()["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in SEEDS:
        args = argparse.Namespace(workload=cell, seed=seed, seconds=2.0, trace=0)
        res = harness.run_cell(args, time.perf_counter(), {"config": {"control": "fp8"}})
        assert not res["correct"], (seed, res["checks"])
