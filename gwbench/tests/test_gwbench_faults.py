"""A run driven on the CPU at a small size (the harness's look for a card
skipped, the port on its plain float32 path): correct as it stands, and not
correct with the timed path broken underneath, once for each fault an
inference cell can have: half of the batch left out (its answers the mean
of the rest), and an answer altered where it is produced."""
import argparse
import time

import pytest
import torch

from gwbench import faults, files, harness

SEED = 2 ** 31 + 11
SMALL = {
    "search-capstone-600s": {
        "traffic": {"segment_seconds": 6, "distinct": 2},
        "config": {"slicer": {"step_size": 0.1, "peak_offset": 0.6, "slice_length": 2048, "low_frequency_cutoff": 20.0,
                              "segment_duration": 0.5, "max_filter_duration": 0.25, "max_block": 8192},
                   "gelu": "erf"},
        "params": {"batch_size": 8}, "check": {"sample_windows": 24}},
    "classify-svn-b64": {"traffic": {"batch": 4, "pool_batches": 2}, "config": {"n_frames": 200, "gelu": "erf"},
                         "check": {"sample_batches": 2}},
}


def run_small(cell: str, trace: int = 0) -> dict:
    args = argparse.Namespace(workload=cell, seed=SEED, seconds=0.0, trace=trace)
    return harness.run_cell(args, time.perf_counter(), SMALL[cell], torch.device("cpu"))


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_broken_path_is_not_correct(cell, fault):
    with faults.planted(files.cell(cell)["driver"], fault):
        res = run_small(cell)
    assert not res["correct"], res["checks"]


def test_traced_run_on_the_cpu_reads_no_device_metric():
    res = run_small("classify-svn-b64", trace=1)
    assert res["correct"] and res["device"]["busy_s"] == 0.0
    assert not [m for m in res["metrics"] if "roofline" in m or "mfu" in m or "idle" in m]
