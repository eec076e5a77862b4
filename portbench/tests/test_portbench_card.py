"""The benchmark's command on the card: one short run of each cell comes
out correct and prints the cell's metrics. Needs a CUDA card."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_on_the_card_is_correct(workload, card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                          "--seed", "4000000001", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
