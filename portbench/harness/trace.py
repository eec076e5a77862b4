"""Reduction of a ``torch.profiler`` trace of the traced ticks to what the
per-layer metrics read: the harness's host spans, the device's operations
clipped to the ticks, the port's own kernels by name, the busy share, the
longest device operations and the longest idle gaps with the harness span
the host was in.

The union arithmetic is the one the repository's ``chip_smoke.py`` uses
(``busy_ms``): device time is the union of intervals, so overlapping
operations count once.
"""

from __future__ import annotations

import re
from pathlib import Path

from .registry import ROOT


def union_us(intervals) -> float:
    """Microseconds covered by the union of (start_us, end_us) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def clip(intervals, windows):
    """The parts of ``intervals`` that lie inside any of ``windows``
    (sorted, disjoint)."""
    out = []
    for a, b in intervals:
        for wa, wb in windows:
            lo, hi = max(a, wa), min(b, wb)
            if hi > lo:
                out.append((lo, hi))
    return out


def port_kernel_names(root: Path = ROOT) -> list[str]:
    """The ``__global__`` functions of the port's CUDA sources: what a device
    event must name to count as one of the port's own kernels."""
    names = []
    for src in sorted((root / "aukit_tpu_torch" / "csrc").glob("*.cu")):
        names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                            src.read_text())
    return names


class TraceView:
    """The traced ticks of one run. Times are profiler microseconds."""

    def __init__(self, events, span_names, tick_name: str = "tick"):
        spans = set(span_names) | {tick_name}
        self.host: dict[str, list] = {}
        dev = []
        for e in events:
            iv = (e.time_range.start, e.time_range.end)
            if e.device_type.name == "CUDA":
                if e.name not in spans and not e.name.startswith("ProfilerStep"):
                    dev.append((e.name, *iv))
            elif e.name in spans:
                self.host.setdefault(e.name, []).append(iv)
        self.ticks = sorted(self.host.get(tick_name, []))
        self.window_us = sum(b - a for a, b in self.ticks)
        self.device = [(n, *iv) for n, a, b in dev for iv in clip([(a, b)], self.ticks)]
        self.kernel_names = port_kernel_names()
        pat = re.compile(r"\b(" + "|".join(self.kernel_names) + r")\b")
        self.kind = {n: ("copy" if "Memcpy" in n else
                         "kernel" if pat.search(n) else "op")
                     for n in {d[0] for d in self.device}}

    @property
    def n_ticks(self) -> int:
        return len(self.ticks)

    def intervals(self, kind: str | None = None, name_has: str | None = None):
        return [(a, b) for n, a, b in self.device
                if (kind is None or self.kind[n] == kind) and (name_has is None or name_has in n)]

    def busy_us(self) -> float:
        return union_us(self.intervals())

    def host_ms_per_tick(self, name: str):
        """Mean host milliseconds a traced tick spends in span ``name``; None
        when the span never ran."""
        ivs = clip(self.host.get(name, []), self.ticks)
        if not ivs or not self.ticks:
            return None
        return sum(b - a for a, b in ivs) / 1e3 / self.n_ticks

    def device_ms_per_tick(self, kind: str | None = None, name_has: str | None = None):
        ivs = self.intervals(kind, name_has)
        if not ivs or not self.ticks:
            return None
        return union_us(ivs) / 1e3 / self.n_ticks

    def top_ops(self, k: int = 10):
        """The device operations that took most time: [[name, seconds]]."""
        tot: dict[str, float] = {}
        for n, a, b in self.device:
            tot[n] = tot.get(n, 0.0) + (b - a)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], v / 1e6] for n, v in top]

    def idle_gaps(self, k: int = 10):
        """The longest stretches of a tick with no device activity, each named
        by the innermost harness span the host was in at its middle:
        [[span, seconds]]."""
        busy = sorted(self.intervals())
        gaps = []
        for ta, tb in self.ticks:
            at = ta
            for a, b in busy:
                if b <= ta or a >= tb:
                    continue
                if a > at:
                    gaps.append((at, a))
                at = max(at, b)
            if tb > at:
                gaps.append((at, tb))
        named = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = (a + b) / 2
            inner, width = "tick", float("inf")
            for name, ivs in self.host.items():
                for sa, sb in ivs:
                    if sa <= mid <= sb and sb - sa < width:
                        inner, width = name, sb - sa
            named.append([inner, (b - a) / 1e6])
        return named
