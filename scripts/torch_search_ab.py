"""A/B of the port's exact bf16 search throughput between two checkouts.

    python3 scripts/torch_search_ab.py PARENT_DIR CHANGE_DIR

Runs the capstone search (bf16 on the kernels, (80, 512), batch 128) on a
300 s N(0,1)·1e-21 segment in a fresh process per checkout, alternating
which side goes first over three rounds; each process makes two warm
passes and seven timed ones and prints their strain-seconds per second and
its median. Each directory holds a checkout of the repository (for example
a ``git archive`` of each commit unpacked into a git-ignored directory).
Needs the CUDA card.
"""
import json
import subprocess
import sys

if len(sys.argv) != 3:
    sys.exit(__doc__)
DIRS = dict(zip(("parent", "change"), sys.argv[1:3]))

CODE = r'''
import json, statistics, time
import numpy as np, torch
from gwkit_torch.cli.inference import load_task_from_components
from gwkit_torch.search.engine import score_segments
from gwkit_torch.search.slicer import Segment, SlicerConfig
cap = "artifacts/capstone_r5"
task = load_task_from_components(f"{cap}/run/best_lora_weights", f"{cap}/run/best_dense_layers.npz",
                                 f"{cap}/run/best_adapter.npz", pretrained_encoder=f"{cap}/encoder_pretrained.npz",
                                 target_shape=(80, 512))
strain = (np.random.default_rng(0).normal(size=(2, 300 * 2048)) * 1e-21).astype(np.float32)
seg = Segment(key="ab", strain=strain, start_time=0.0, delta_t=1.0 / 2048)
cfg = SlicerConfig(batch_size=128)
dev = torch.device("cuda")
for _ in range(2):
    score_segments(task.score, [seg], cfg, trigger_threshold=0.0, device=dev)
rates = []
for _ in range(7):
    torch.cuda.synchronize()
    rates.append(score_segments(task.score, [seg], cfg, trigger_threshold=0.0, device=dev).throughput_x_realtime)
print(json.dumps({"median": statistics.median(rates), "rates": rates}))
'''

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                     text=True, timeout=60).stdout.strip())
out = {"parent": [], "change": []}
for rep in range(3):
    for side in (("parent", "change") if rep % 2 == 0 else ("change", "parent")):
        r = subprocess.run([sys.executable, "-c", CODE], cwd=DIRS[side], capture_output=True,
                           text=True, timeout=600)
        if r.returncode:
            print(side, "failed", r.stderr[-2000:])
            sys.exit(1)
        res = json.loads(r.stdout.strip().splitlines()[-1])
        out[side].append(res)
        print(side, rep, json.dumps(res), flush=True)
print(json.dumps({k: [v["median"] for v in vals] for k, vals in out.items()}))
