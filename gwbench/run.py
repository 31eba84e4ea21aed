"""Run one benchmark cell once and print its result line:

    python3 gwbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Build and kernel caches stay inside the
checkout at fixed paths: the port's kernels in ``gwkit_torch/_build/``, and
Triton's, PyTorch's extension and CUDA's JIT caches under
``.gwbench_cache/``, so only a checkout's first run builds.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)  # the checkout, not gwbench/

from gwbench import files  # noqa: E402

files.process_env()

from gwbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
