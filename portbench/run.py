"""Run one cell of the benchmark of ``aukit_tpu_torch`` once and print its
result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is one entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic mix, driver, metric readers and comparison limits are
files under ``portbench/`` found by name. A run needs a CUDA card: without
one it exits with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness.core import run  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(run(sys.argv[1:], T_START))
