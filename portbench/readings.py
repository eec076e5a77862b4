"""The readings the comparison's limits are set from, in one process on the
card: the numbers a run's check compares, from the program on each seed
given, or from the control (the plain reference in the program's place, one
precision below the configuration's) on each seed.

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 --seconds 5 \
        [--control int16-bfloat16|int32-bfloat16]

Each seed prints one JSON line: the seed, the numbers compared and the
seconds the run and its check took. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import core, registry  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", default=None,
                   help="the control's integer and float types, as int16-bfloat16")
    a = p.parse_args(argv)
    core.cache_env(registry.ROOT)
    import torch

    factory = None
    if a.control:
        ints, floats = a.control.split("-")
        kind = registry.cell(a.workload)["config"]["driver"]
        factory = registry.driver(kind).control(getattr(torch, ints), getattr(torch, floats))
    for seed in a.seeds:
        spec = registry.cell(a.workload)
        t0 = time.perf_counter()
        r = core.execute(spec, seed, a.seconds, False, "cuda", t0, engine_factory=factory)
        print(json.dumps({"workload": a.workload, "seed": seed, "control": a.control,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "numbers": {k: c["value"] for k, c in r["checks"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
