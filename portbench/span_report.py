"""Run one cell once with a trace, as ``run.py --trace 1`` does, and report
the program's own spans of the traced ticks beside the result line: each
span's time, self time and entries a tick; the counters the steps' spans
carry; the device's idle time a tick by the innermost span the host was in;
the traced ticks' median; and what a span costs on this host when no
profiler records.

    python3 portbench/span_report.py --workload <cell> --seed <n> --seconds <s> [--out FILE]

The report is the last line of standard output (JSON), and ``--out`` writes
it to a file too. It needs a CUDA card, as ``run.py`` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import core, program_spans, registry  # noqa: E402


def off_cost_us(n: int = 200_000) -> float:
    """Microseconds a span costs when no profiler records."""
    from aukit_tpu_torch.utils.trace import span

    t0 = time.perf_counter()
    for _ in range(n):
        with span("aukit.off"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def traced_tick_ms(trace, cell):
    """Median milliseconds of the traced ticks, by the host clock."""
    off = program_spans.offset_us(trace, cell)
    if off is None:
        return None
    ms = [(t1 - t0) * 1e3 for _i, t0, t1 in cell.spans.rec["tick"]
          if any(abs(t0 * 1e6 + off - a) < 1e3 for a, _b in trace.ticks)]
    return statistics.median(ms) if ms else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    core.cache_env(registry.ROOT)
    import torch

    if not torch.cuda.is_available():
        core.fail("needs a CUDA card")
    spec = registry.cell(args.workload)
    seen = {}
    metric = registry.metric

    def capture(name):
        mod = metric(name)
        read = mod.read

        def reading(run, trace, cell, device):
            if trace is not None and "report" not in seen:
                seen["report"] = {
                    "spans": program_spans.spans_per_tick(trace, cell),
                    "idle_ms": program_spans.idle_by_span(trace, cell),
                    "traced_tick_ms": traced_tick_ms(trace, cell),
                    "n_traced_ticks": trace.n_ticks,
                }
            return read(run=run, trace=trace, cell=cell, device=device)

        mod.read = reading
        return mod

    registry.metric = capture
    result = core.execute(spec, args.seed, args.seconds, True, "cuda", T_START)
    rep = {"workload": args.workload, "seed": args.seed, "device": result["device"],
           "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           **seen.get("report", {}), "span_off_us": off_cost_us()}
    line = json.dumps(rep)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
