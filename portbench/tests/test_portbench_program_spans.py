"""The readers of the program's spans (``harness/program_spans.py`` and the
metrics of ``source: program_span`` that read it) against the span sums of
the program's own records, on a CPU profile of a tiny Fleet ticked the way
the harness ticks it (its ``tick`` spans, a profiler over the ticks after
one warm-up tick). Without the program's records every reader gives None,
as at a commit whose program has no spans."""

import numpy as np
import pytest
import torch

NEW = ["engine.stage_ms", "engine.htod_host_ms", "engine.launch_ms", "engine.fifo_ms",
       "engine.htod_copies", "flac.parse_ms", "flac.restore_ms", "flac.dsp_host_ms",
       "flac.parse_us_per_frame", "fleet.htod_host_ms"]
TRACED = 2


class _Cell:
    def __init__(self, spans):
        self.spans = spans


def flac_bytes(seed: int, nframes: int, n: int = 1024) -> bytes:
    """A mono 48 kHz FLAC stream of FIXED-order-2 frames."""
    from tests import fixtures

    r = np.random.default_rng(seed)
    frames = []
    for k in range(nframes):
        s = r.integers(-3000, 3000, n)
        sub = {"type": "fixed", "order": 2, "warmup": [int(s[0]), int(s[1])],
               "residuals": [int(s[i] - (2 * s[i - 1] - s[i - 2])) for i in range(2, n)]}
        frames.append(fixtures.flac_frame([sub], n, 0, 16, frame_number=k))
    return fixtures.flac_stream_header(48000, 1, 16, nframes * n) + b"".join(frames)


@pytest.fixture(scope="module")
def profiled():
    """A live Fleet of two FLAC and four PCM16 WAV stations (48 and 32 kHz):
    a warm-up tick, then a profiler's warm-up tick and ``TRACED`` recorded
    ticks. Returns (the TraceView, a cell holding the harness's spans, the
    program's records)."""
    from portbench.harness.core import Spans
    from portbench.harness.trace import TraceView
    from aukit_tpu_torch.stream.fleet import Fleet
    from aukit_tpu_torch.utils import trace
    from tests import fixtures

    rng = np.random.default_rng(5)
    secs = 2 + TRACED
    wavs = [fixtures.wav_pcm(rng.integers(-3000, 3000, (1, rate * secs)), rate, 16)
            for rate in (48000, 48000, 32000, 32000)]
    flacs = [flac_bytes(s, 50 * secs) for s in (1, 2)]
    srcs = flacs + wavs
    fleet = Fleet([s[:4096] for s in srcs], eof=False, device="cpu")
    at = [4096] * len(srcs)
    spans = Spans()
    trace.clear_span_records()
    prof = None
    for n in range(2 + TRACED):
        if n == 1:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU],
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=TRACED, repeat=1))
            prof.__enter__()
            spans.tracing = True
        spans.tick = n
        with spans("tick"):
            for i, s in enumerate(srcs):
                step = len(s) // secs + 1
                fleet.feed(i, s[at[i]: at[i] + step] or None)
                at[i] += step
            with spans("fleet.step"):
                assert fleet.step() is not None
        if prof is not None:
            prof.step()
    prof.__exit__(None, None, None)
    view = TraceView(prof.events(), spans.names())
    return view, _Cell(spans), trace.span_records()


def sums(records, n_ticks):
    """Per name: (total ms, self ms, counters) per tick, from the records."""
    out = {}
    for r in records:
        e = out.setdefault(r.name, [0.0, 0.0, {}])
        d = (r.end_ns - r.start_ns) / 1e6
        e[0] += d
        e[1] += d
        for k, v in r.counts.items():
            e[2][k] = e[2].get(k, 0) + v
    for r in records:
        if r.parent in out:
            out[r.parent][1] -= (r.end_ns - r.start_ns) / 1e6
    return {k: (t / n_ticks, s / n_ticks, {c: v / n_ticks for c, v in cs.items()})
            for k, (t, s, cs) in out.items()}


def read(name, view, cell):
    from portbench.harness import registry

    return registry.metric(name).read(run=None, trace=view, cell=cell, device="cpu")


def test_the_ring_holds_the_traced_ticks(profiled):
    view, cell, records = profiled
    from portbench.harness import program_spans

    assert view.n_ticks == TRACED
    assert {r.step for r in records if r.name == "aukit.fleet.step"} == {2, 3}
    assert len(program_spans.timeline(view, cell)) == len(records)


def test_each_reader_equals_the_span_sums(profiled):
    view, cell, records = profiled
    want = sums(records, TRACED)
    expect = {
        "engine.stage_ms": want["aukit.engine.stage"][1],
        "engine.htod_host_ms": want["aukit.engine.htod"][0],
        "engine.launch_ms": want["aukit.engine.launch"][1],
        "engine.fifo_ms": want["aukit.engine.fifo"][1],
        "engine.htod_copies": want["aukit.engine.step"][2]["htod_copies"],
        "flac.parse_ms": want["aukit.flac.parse"][0],
        "flac.restore_ms": want["aukit.flac.restore"][0],
        "flac.dsp_host_ms": want["aukit.flac.dsp"][0],
        "flac.parse_us_per_frame": 1e3 * want["aukit.flac.parse"][0]
        / want["aukit.flac.parse"][2]["frames_parsed"],
        "fleet.htod_host_ms": want["aukit.fleet.htod"][0],
    }
    assert set(expect) == set(NEW)
    for name, v in expect.items():
        got = read(name, view, cell)
        assert got is not None and got > 0, name
        assert got == pytest.approx(v, rel=1e-6), name  # the clock offset costs digits
    # the program's spans nest inside the harness's, on the profiler's clock
    step = view.host_ms_per_tick("fleet.step")
    assert want["aukit.fleet.step"][0] <= step
    assert want["aukit.fleet.step"][0] > 0.5 * step


def test_idle_time_is_named_by_program_span(profiled):
    from portbench.harness import program_spans

    view, cell, _records = profiled
    idle = program_spans.idle_by_span(view, cell)
    window_ms = view.window_us / 1e3 / view.n_ticks
    assert sum(idle.values()) == pytest.approx(window_ms, rel=1e-6)  # no device: all idle
    assert {"aukit.flac.parse", "aukit.engine.stage", "aukit.fleet.step"} <= set(idle)


def test_readers_give_none_without_the_programs_spans(profiled, monkeypatch):
    from portbench.harness import program_spans

    view, cell, _records = profiled
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert all(read(name, view, cell) is None for name in NEW)
    assert program_spans.idle_by_span(view, cell)  # the harness's spans still name it
