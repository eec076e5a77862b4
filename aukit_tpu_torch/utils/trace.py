"""Tracing / profiling hooks — counterpart of ``aukit_tpu.utils.trace``
(SURVEY.md §5.1 — the reference has none): a ``torch.profiler`` trace in
place of the JAX package's ``jax.profiler`` one, plus lightweight per-chunk
timing.

Usage:
    with trace_session("/tmp/aukit-trace"):   # host + CUDA trace (Perfetto)
        engine.step()

    meter = ChunkMeter()
    with meter.measure(samples=48000):
        ...
    print(meter.summary())

CLIs expose this via ``--trace DIR``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

from ..config import require_device


@contextlib.contextmanager
def trace_session(log_dir: str, *, device="cuda"):
    """``torch.profiler`` trace of the block, written into ``log_dir`` as a
    Chrome/Perfetto JSON trace (``trace_<pid>_<ns>.json``; open it in
    Perfetto or ``chrome://tracing``). It records the host's operations, and
    the card's kernels and copies when ``device`` is the card ("cuda", the
    default, raises without one); a profiler that cannot trace CUDA raises
    rather than record the host alone."""
    device = require_device(device, "trace_session")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        if torch.profiler.ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("trace_session(device='cuda'): this torch.profiler cannot "
                               "trace CUDA")
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # the block's kernels end inside the trace
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir,
                                              f"trace_{os.getpid()}_{time.time_ns()}.json"))


@dataclasses.dataclass
class ChunkMeter:
    """Per-chunk wall-time meter with realtime-factor reporting."""

    chunks: int = 0
    samples: int = 0
    seconds: float = 0.0
    worst: float = 0.0
    rate: int = 48000

    @contextlib.contextmanager
    def measure(self, samples: int):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.chunks += 1
        self.samples += samples
        self.seconds += dt
        self.worst = max(self.worst, dt)

    @property
    def realtime_factor(self) -> float:
        return self.samples / self.seconds / self.rate if self.seconds else 0.0

    def summary(self) -> dict:
        return {
            "chunks": self.chunks,
            "samples": self.samples,
            "wall_seconds": round(self.seconds, 6),
            "worst_chunk_seconds": round(self.worst, 6),
            "realtime_factor": round(self.realtime_factor, 1),
        }
