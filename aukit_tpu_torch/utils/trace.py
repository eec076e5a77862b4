"""Tracing hooks — counterpart of ``aukit_tpu.utils.trace`` (SURVEY.md §5.1 —
the reference has none): a ``torch.profiler`` trace in place of the JAX
package's ``jax.profiler`` one, and the program's own spans inside the
engines' steps.

Usage:
    with trace_session("/tmp/aukit-trace"):   # host + CUDA trace (Perfetto)
        engine.step()
    records = span_records()                  # the same steps' spans, in memory

CLIs expose this via ``--trace DIR`` (``austream``).

**Spans.** ``span(name, metrics)`` marks one stretch of a step. It is on only
while a ``torch.profiler`` records: inside ``trace_session``, under
``austream --trace DIR``, or in the active steps of any profiler the caller
runs (``torch.autograd.profiler._is_profiler_enabled``). Off, it is a bool
check and a shared ``nullcontext``, and records nothing. On, it

 - enters a profiler range of that name, so the exported trace shows the
   span on the host's timeline with the operations it ran and the kernels
   and copies they issued. The range is a host operation
   (``torch._C._profiler._RecordFunctionFast``): a
   ``torch.profiler.record_function`` range would also be mirrored onto the
   device's timeline as an event spanning the work launched inside it, and
   a reader of the trace's device events would count that as device time;
 - appends one ``SpanRecord`` to an in-memory ring of the newest ``RING``
   records: the span's name, the name of the span it ran in, the owning
   engine's step number (its ``metrics.steps`` at entry), its start and end
   by ``time.perf_counter_ns()`` (CLOCK_MONOTONIC), and the change over the
   span of each of the owning engine's ``BatchMetrics`` counters.

``span_records()`` reads the ring and ``clear_span_records()`` empties it.
Spans mark per-step and per-batch stretches only; the per-lane calls
(``feed``, ``Fleet.feed``, ``set_filter``) have none.

The spans, by name (the stretch each marks):

 - ``aukit.engine.feed``: ``BatchStreamEngine.feed_many`` / ``feed_array``;
 - ``aukit.engine.step``: one step of ``BatchStreamEngine`` or an encoder;
 - ``aukit.engine.stage``: gathering the lanes' fed bytes into a staged matrix;
 - ``aukit.engine.htod``: one host-to-device copy of a step's host array; a
   pageable copy first waits for the work already queued on the device, and
   that wait is inside the span;
 - ``aukit.engine.launch``: issuing one group's decode and DSP work;
 - ``aukit.engine.fifo``: the group FIFOs' push and pop, the window assembly;
 - ``aukit.flac.step``: ``FlacFleet.step``, whose own time is the windows' pop;
 - ``aukit.flac.parse``: the per-lane incremental frame parse;
 - ``aukit.flac.restore``: the fleet-wide LPC restore (on the device-resident
   route, each geometry group's whole device step);
 - ``aukit.flac.dsp``: decorrelation, resample, lowpass, gain, scale and the
   lane FIFOs' push (on a card the host route's copies to and from it and
   the f64 DSP kernel);
 - ``aukit.flac.dsp.numpy``: inside ``aukit.flac.dsp``, the numpy route
   (``FlacFleet._host_dsp``) of the lanes the kernel does not take;
 - ``aukit.fleet.step``: ``Fleet.step``, whose own time is the station
   bookkeeping and the windows' merge;
 - ``aukit.fleet.htod``: the FLAC windows' and the station mask's copies to
   the device.

**Counters** (``stream.batch.BatchMetrics``, always on, added once a step):
``steps``, ``samples_decoded``, ``underruns``, ``bytes_staged`` (fed bytes
moved into staged matrices), ``htod_copies`` and ``htod_bytes`` (copies of
host arrays onto the engine's device), ``lanes_ready`` (lane chunks decoded
from real bytes), and on ``FlacFleet`` ``frames_parsed`` and
``bytes_parsed`` (frames and frame bytes committed by the parse) and
``dsp_lanes_device`` and ``dsp_lanes_host`` (the host route's lanes whose
float64 DSP ran in the kernel ``aukit_flac_dsp_f64`` or in numpy, added
inside ``aukit.flac.dsp``). ``FlacFleet`` counts some only while a profiler
records (``recording()``), for they cost a pass over each lane's frames:
``frames_asgn_indep``, ``frames_asgn_left_side``, ``frames_asgn_side_right``
and ``frames_asgn_mid_side`` (parsed frames by channel assignment, mono as
independent; added inside ``aukit.flac.parse``), and ``dsp_frames_device``,
``dsp_frames_host`` (the frames of the host route's lanes on each DSP route),
``dsp_lanes_mixed_asgn`` and ``dsp_lanes_mixed_asgn_device`` (the numpy
route's and the kernel route's lanes whose frames this step mix channel
assignments; the kernel reads one a block; added inside ``aukit.flac.dsp``).
``Fleet.metrics`` adds up both engines' and the FLAC windows' copies.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

from ..config import require_device

RING = 65536  # span records kept; the oldest drop first


class SpanRecord(NamedTuple):
    name: str
    parent: str | None  # the span this one ran inside, None at the top
    step: int | None  # the owning engine's ``metrics.steps`` at entry
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    counts: dict  # counter -> its change over the span (changed counters only)


_ring: collections.deque = collections.deque(maxlen=RING)
_local = threading.local()
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a ``torch.profiler`` records: the spans are on, and so are the
    counters that cost more than an addition a step."""
    return _profiler._is_profiler_enabled


def span(name: str, metrics=None):
    """A context manager marking ``name`` (see the module docstring): on
    while a ``torch.profiler`` records, else a shared no-op. ``metrics`` is
    the owning engine's ``BatchMetrics``: its step number and the change of
    its counters go into the record."""
    if not recording():
        return _OFF
    return _Span(name, metrics)


def span_records() -> list[SpanRecord]:
    """The ring's records, oldest first."""
    return list(_ring)


def clear_span_records() -> None:
    _ring.clear()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    __slots__ = ("name", "metrics", "parent", "step", "before", "rf", "t0")

    def __init__(self, name: str, metrics):
        self.name, self.metrics = name, metrics

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        m = self.metrics
        self.step = None if m is None else m.steps
        self.before = None if m is None else dict(vars(m))
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _stack().pop()
        counts = {}
        if self.metrics is not None:
            counts = {k: v - self.before[k] for k, v in vars(self.metrics).items()
                      if v != self.before[k]}
        _ring.append(SpanRecord(self.name, self.parent, self.step, self.t0, t1, counts))
        return False


@contextlib.contextmanager
def trace_session(log_dir: str, *, device="cuda"):
    """``torch.profiler`` trace of the block, written into ``log_dir`` as a
    Chrome/Perfetto JSON trace (``trace_<pid>_<ns>.json``; open it in
    Perfetto or ``chrome://tracing``). It records the host's operations and
    the program's spans, and the card's kernels and copies when ``device`` is
    the card ("cuda", the default, raises without one); a profiler that
    cannot trace CUDA raises rather than record the host alone. The spans'
    in-memory records of the block are in ``span_records()`` afterwards."""
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
