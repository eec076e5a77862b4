"""One run of one cell: set-up, the measured window, the output comparison,
the metrics, and the result line.

A tick is the driver's feed and step, then ``torch.cuda.synchronize()``: the
returned window complete on the card. The window runs from the start of the
first timed tick to the end of the last one, ticking back to back until
``--seconds`` have passed. Between ticks the driver keeps what the check
compares (a device gather of a few sampled rows), outside the ticks' timing.
With ``--trace 1`` a ``torch.profiler`` records ``trace_ticks`` ticks of the
window (the traffic file's), after one tick it discards: that stretch is what
the per-layer metrics read.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

from . import registry
from .trace import TraceView

FORBIDDEN = ("jax", "jaxlib", "flax", "aukit_tpu")


class Spans:
    """The harness's host spans: per name, the (tick, start, end) seconds of
    each entry by the host clock; under tracing also a profiler range of the
    same name, so the trace sees which span the host was in."""

    def __init__(self):
        self.rec: dict[str, list] = {}
        self.tick = -1
        self.tracing = False

    def __call__(self, name: str):
        return _Span(self, name)

    def wrap(self, name: str, fn):
        """``fn`` with every call inside span ``name``."""
        def wrapped(*a, **k):
            with self(name):
                return fn(*a, **k)
        return wrapped

    def names(self):
        return list(self.rec)


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.rf = None
        if self.spans.tracing:
            import torch
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.spans.rec.setdefault(self.name, []).append((self.spans.tick, self.t0, t1))
        return False


def cache_env(root) -> None:
    """Build and kernel caches at fixed paths inside the checkout: only the
    first run of a checkout builds. The port keeps its own nvcc and g++
    builds in ``aukit_tpu_torch/_build/``."""
    base = root / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(msg, file=sys.stderr, flush=True)
    raise SystemExit(code)


def run(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cache_env(registry.ROOT)
    spec = registry.cell(args.workload)
    import torch

    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"needs {chips} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    result = execute(spec, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()  # the check and the metric readers ran since the window
    if bad:
        fail(f"modules of another package were loaded after the window: {bad}")
    sys.stdout.flush()
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def execute(spec: dict, seed: int, seconds: float, trace: bool, device: str,
            t_start: float, engine_factory=None) -> dict:
    """Set up, tick for ``seconds``, compare, and build the result line. On
    the CPU (the tests' rehearsal) nothing is traced and no device is read."""
    import torch

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    spans = Spans()
    cell = registry.driver(spec["config"]["driver"]).Cell(
        spec["config"], spec["traffic"], seed, device, spans, engine_factory=engine_factory)
    cell.setup()
    sync()
    setup_s = time.perf_counter() - t_start

    traced = None
    trace_ticks = int(spec["traffic"].get("trace_ticks", 8))
    ticks, delivered, due = [], [], []
    prof = None
    while True:
        n = len(ticks)
        if trace and n == 1:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            prof = torch.profiler.profile(
                activities=acts,
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=trace_ticks, repeat=1))
            prof.__enter__()
            spans.tracing = True
        spans.tick = cell.tick_index()
        with spans("tick"):
            t0 = time.perf_counter()
            got, want = cell.tick()
            sync()
            t1 = time.perf_counter()
        ticks.append((t0, t1))
        delivered.append(got)
        due.append(want)
        if prof is not None:
            prof.step()
            if n == 1 + trace_ticks:
                prof.__exit__(None, None, None)
                spans.tracing = False
                traced = TraceView(prof.events(), spans.names())
                prof = None
        cell.keep()
        if t1 - ticks[0][0] >= seconds and prof is None:
            break
    window_s = ticks[-1][1] - ticks[0][0]
    peak = torch.cuda.max_memory_allocated(0) if cuda else 0
    bad = forbidden_modules()
    if bad:
        fail(f"modules of another package were loaded by the window's close: {bad}")
    cell.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = cell.check()
    ms = sorted((b - a) * 1e3 for a, b in ticks)
    print(f"phases setup_s={setup_s:.3f} window_s={window_s:.3f} ticks={len(ticks)} "
          f"tick_ms_min={ms[0]:.1f} tick_ms_median={ms[len(ms) // 2]:.1f} "
          f"tick_ms_max={ms[-1]:.1f} check_s={time.perf_counter() - t_check:.3f}",
          file=sys.stderr, flush=True)

    limits = spec["limits"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = set(numbers) == set(limits) and all(
        isinstance(v, (int, float)) and math.isfinite(v) and v <= limits[k]
        for k, v in numbers.items())
    run_view = {"ticks": ticks, "delivered": delivered, "due": due, "window_s": window_s,
                "setup_s": setup_s}
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    out_metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        v = registry.metric(m["name"]).read(run=run_view, trace=traced, cell=cell, device=name)
        if v is not None:
            out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": spec["workload"]["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(sum(due)),
              "failed": int(sum(due) - sum(delivered))
              + cell.failed_answers(limits.get("lsb_max", 0)),
              "metrics": out_metrics, "device": dev}
    if trace:
        dev["busy_s"] = traced.busy_us() / 1e6
        dev["window_s"] = traced.window_us / 1e6
        result["breakdown"] = {"device_ops": traced.top_ops(), "idle_gaps": traced.idle_gaps()}
    result["checks"] = checks
    return result
