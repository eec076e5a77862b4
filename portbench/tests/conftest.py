"""Shared helpers of the benchmark's own tests: a rehearsal of a cell on the
CPU at a tiny size, and the ``cuda`` marker of the tests that need a card."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny sizes: the port's plain versions step a DFPWM lane one Python step a bit
SPEAKER_LANES = 4
RADIO = {"stations": 9, "track_pool": 2, "track_seconds": [2.0, 3.0],
         "check": {"flac": 2, "dfpwm": 2, "ima": 2}}
# a cell whose files stay under portbench/ while BENCHMARK.json leaves it out
# (its runs spread too widely for any bound the contract allows): rehearsed
# all the same, so that it can come back as one entry
KEPT = [{"name": "dfpwm_speakers.uniform_48k", "config": "dfpwm_speakers",
         "traffic": "uniform_48k", "chips": 1}]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs on an NVIDIA GPU; skipped elsewhere")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card")


def tiny_spec(workload: str, root: Path = ROOT) -> dict:
    from portbench.harness import registry

    bench = registry.benchmark(root)
    have = {w["name"] for w in bench["workloads"]}
    bench["workloads"] += [w for w in KEPT if w["name"] not in have]
    spec = registry.cell(workload, bench, root)
    cfg, tr = spec["config"], spec["traffic"]
    tr["warmup_ticks"] = 1
    if cfg["driver"] == "dfpwm_speakers":
        cfg["lanes"] = SPEAKER_LANES
        tr["check_lanes"] = SPEAKER_LANES
        tr["pool_chunks"] = 16
    else:
        cfg["stations"] = RADIO["stations"]
        cfg["track_pool"] = RADIO["track_pool"]
        tr["track_seconds"] = RADIO["track_seconds"]
        tr["check_stations"] = RADIO["check"]
    return spec


def rehearse(workload: str, seed: int = 2**31 + 99, seconds: float = 0.0, factory=None,
             spec: dict | None = None) -> dict:
    """One run of a cell on the CPU at a tiny size, the harness's look for a
    card skipped: set-up, one warm-up tick and one timed tick, the check."""
    from portbench.harness import core

    spec = spec or tiny_spec(workload)
    return core.execute(spec, seed, seconds, False, "cpu", time.perf_counter(),
                        engine_factory=factory)
