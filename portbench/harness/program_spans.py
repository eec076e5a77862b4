"""The program's own spans in a traced run: the records that
``aukit_tpu_torch.utils.trace`` keeps of the spans inside the engine's step,
the FLAC lanes' step and the Fleet's step, put on the profiler's timeline and
reduced per traced tick.

The program records a span only while a ``torch.profiler`` records, so its
ring holds the traced ticks' spans. A program without the spans (an older
commit) gives no records, and every reader built on this file returns None.

**Clock alignment.** The records are timed by ``time.perf_counter_ns()``,
the profiler's events by its own microseconds. The harness's ``tick`` spans
are on both clocks: a profiler range (``trace.ticks``) and a host record
(``cell.spans.rec["tick"]``, ``perf_counter`` seconds). The traced ticks are
a run of consecutive host ticks; the run whose offsets to the profiler's
ticks spread least is theirs, and the median of those offsets moves the
records onto the profiler's timeline.

**Self time** of a span is its duration less its child spans' (the records
naming it as their parent: one thread runs a step, so children do not
overlap).
"""

from __future__ import annotations

import statistics


def records():
    """The program's span records, or None when it keeps none."""
    try:
        from aukit_tpu_torch.utils.trace import span_records
    except ImportError:
        return None
    return span_records()


def offset_us(trace, cell):
    """Profiler microseconds less ``perf_counter`` microseconds, from the
    traced ticks; None without them."""
    prof = [a for a, _b in trace.ticks]
    host = sorted(t0 * 1e6 for _tick, t0, _t1 in cell.spans.rec.get("tick", []))
    n = len(prof)
    if not n or len(host) < n:
        return None
    best = None
    for k in range(len(host) - n + 1):
        d = [p - h for p, h in zip(prof, host[k:k + n])]
        if best is None or max(d) - min(d) < best[0]:
            best = (max(d) - min(d), statistics.median(d))
    return best[1]


def timeline(trace, cell):
    """[(record, start_us, end_us)] on the profiler's clock, of the records
    whose middle lies in a traced tick; None when there are none."""
    recs, off = records(), offset_us(trace, cell)
    if not recs or off is None:
        return None
    out = []
    for r in recs:
        a, b = r.start_ns / 1e3 + off, r.end_ns / 1e3 + off
        if any(ta <= (a + b) / 2 <= tb for ta, tb in trace.ticks):
            out.append((r, a, b))
    return out or None


def spans_per_tick(trace, cell) -> dict:
    """Every program span that ran, per traced tick: {name: {"ms": its
    time, "self_ms": its self time, "count": its entries, "counts": the
    change of each counter its records carry}}; {} without records."""
    tl = timeline(trace, cell) or []
    tot: dict = {}
    for r, a, b in tl:
        e = tot.setdefault(r.name, {"ms": 0.0, "child_ms": 0.0, "count": 0, "counts": {}})
        e["ms"] += (b - a) / 1e3
        e["count"] += 1
        for k, v in r.counts.items():
            e["counts"][k] = e["counts"].get(k, 0) + v
    for r, a, b in tl:
        if r.parent in tot:
            tot[r.parent]["child_ms"] += (b - a) / 1e3
    n = trace.n_ticks
    return {name: {"ms": e["ms"] / n, "self_ms": (e["ms"] - e["child_ms"]) / n,
                   "count": e["count"] / n, "counts": {k: v / n for k, v in e["counts"].items()}}
            for name, e in sorted(tot.items())}


def ms_per_tick(trace, cell, name: str, self_time: bool = False):
    """Host milliseconds a traced tick spends in span ``name`` (its self time
    with ``self_time``); None when the span never ran."""
    e = spans_per_tick(trace, cell).get(name)
    return None if e is None else e["self_ms" if self_time else "ms"]


def count_per_tick(trace, cell, name: str, counter: str):
    """The change of ``counter`` that span ``name``'s records carry, per
    traced tick; None when the span never ran."""
    e = spans_per_tick(trace, cell).get(name)
    return None if e is None else e["counts"].get(counter, 0)


def idle_by_span(trace, cell) -> dict:
    """The traced ticks' device idle time, per tick, by the innermost span
    the host was in: a program span where one ran, else the innermost
    harness span. {name: ms per tick}, largest first."""
    tl = timeline(trace, cell) or []
    busy = sorted(trace.intervals())
    gaps = []
    for ta, tb in trace.ticks:
        at = ta
        for a, b in busy:
            if b <= ta or a >= tb:
                continue
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if tb > at:
            gaps.append((at, tb))
    harness = [(name, a, b) for name, ivs in trace.host.items() for a, b in ivs]
    spans = [(r.name, a, b) for r, a, b in tl] + [(f"harness:{n}", a, b) for n, a, b in harness]
    out: dict = {}
    for ga, gb in gaps:
        over = [(n, a, b) for n, a, b in spans if a < gb and b > ga]
        cuts = sorted({ga, gb} | {x for _n, a, b in over for x in (a, b) if ga < x < gb})
        for lo, hi in zip(cuts, cuts[1:]):
            mid = (lo + hi) / 2
            inner = min(((b - a, n) for n, a, b in over if a <= mid <= b), default=(0, "tick"))
            out[inner[1]] = out.get(inner[1], 0.0) + (hi - lo)
    n = max(trace.n_ticks, 1)
    return {k: v / 1e3 / n for k, v in sorted(out.items(), key=lambda kv: -kv[1])}
