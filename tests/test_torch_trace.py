"""The program's spans and counters (``aukit_tpu_torch.utils.trace`` and
``BatchMetrics``) on the CPU: off without a profiler, on under one; every
span of the engine, the FLAC lanes and the Fleet with its parent and step;
the in-memory records on the profiler's timeline; the counters against
values counted from the fed inputs; the ring's bound; the names."""

import json
import re
import statistics
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from aukit_tpu_torch.stream.batch import BatchStreamEngine, LaneSpec
from aukit_tpu_torch.stream.flac_fleet import FlacFleet
from aukit_tpu_torch.stream.fleet import Fleet
from aukit_tpu_torch.utils import trace
from tests import fixtures

HARNESS_SPANS = {"tick", "engine.feed", "engine.step", "flac.step", "fleet.step",
                 "fleet.rotate"}
PACKAGE = Path(__file__).resolve().parents[1] / "aukit_tpu_torch"


def profiled(fn, ticks: int = 1):
    """Run ``fn`` ``ticks`` times under a CPU ``torch.profiler``, each run
    inside a ``tick`` range timed by ``perf_counter_ns``. Returns (the ring's
    records, the profiler's events, the host tick intervals in ns)."""
    trace.clear_span_records()
    host = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(ticks):
            with torch.profiler.record_function("tick"):
                t0 = time.perf_counter_ns()
                fn()
                host.append((t0, time.perf_counter_ns()))
    return trace.span_records(), prof.events(), host


def by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


# -- the inputs --------------------------------------------------------------------

SPECS = [LaneSpec("pcm16", 48000)] * 3 + [LaneSpec("pcm16", 32000)] * 3


def pcm_engine():
    """A mixed-rate engine of six PCM16 lanes, a lowpass on two of them."""
    eng = BatchStreamEngine(SPECS, interpolation="linear", device="cpu")
    eng.set_filter(1, "lowpass", 8000.0)
    eng.set_filter(4, "lowpass", 8000.0)
    return eng


def pcm_feeds(rng, seconds: int = 1):
    return [rng.integers(0, 256, s.sample_rate * 2 * seconds, dtype=np.uint8).tobytes()
            for s in SPECS]


def flac_stream(seed: int, nframes: int, n: int = 1024):
    """A mono 48 kHz FLAC stream of ``nframes`` LPC and FIXED frames. Returns
    (bytes, the frames' byte lengths)."""
    r = np.random.default_rng(seed)
    frames = []
    for k in range(nframes):
        s = r.integers(-3000, 3000, n).astype(np.int64)
        if k % 2:
            sub = {"type": "fixed", "order": 2, "warmup": [int(s[0]), int(s[1])],
                   "residuals": [int(s[i]) - (2 * int(s[i - 1]) - int(s[i - 2]))
                                 for i in range(2, n)]}
        else:
            coefs, shift = [700, -300, 100], 4
            sub = {"type": "lpc", "order": 3, "warmup": [int(v) for v in s[:3]],
                   "precision": 12, "shift": shift, "coefs": coefs,
                   "residuals": [int(s[i]) - (int(np.dot(s[i - 3:i][::-1], coefs)) >> shift)
                                 for i in range(3, n)]}
        frames.append(fixtures.flac_frame([sub], n, 0, 16, frame_number=k))
    head = fixtures.flac_stream_header(48000, 1, 16, nframes * n)
    return head + b"".join(frames), [len(f) for f in frames]


# -- off -----------------------------------------------------------------------------

def test_span_is_off_without_a_profiler():
    """No profiler recording: ``span`` is the shared no-op, an engine step
    leaves the ring empty, and a profiler started afterwards sees none of it."""
    trace.clear_span_records()
    eng = pcm_engine()
    m = eng.metrics
    assert trace.span("aukit.engine.step", m) is trace.span("aukit.flac.step")
    eng.feed_many(pcm_feeds(np.random.default_rng(1)))
    assert eng.step() is not None
    assert trace.span_records() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pass
    assert not [e for e in prof.events() if e.name.startswith("aukit.")]


# -- on: every span with its parent and step -------------------------------------------

def test_engine_step_records_its_spans():
    rng = np.random.default_rng(2)
    eng = pcm_engine()
    eng.feed_many(pcm_feeds(rng))
    eng.step()
    steps = eng.metrics.steps
    feeds = pcm_feeds(rng)

    def tick():
        eng.feed_many(feeds)
        assert eng.step() is not None

    records, _events, _host = profiled(tick)
    got = by_name(records)
    assert set(got) == {"aukit.engine.feed", "aukit.engine.step", "aukit.engine.stage",
                        "aukit.engine.htod", "aukit.engine.launch", "aukit.engine.fifo"}
    parents = {name: {r.parent for r in rs} for name, rs in got.items()}
    assert parents["aukit.engine.feed"] == {None}
    assert parents["aukit.engine.step"] == {None}
    for name in ("aukit.engine.stage", "aukit.engine.launch", "aukit.engine.fifo"):
        assert parents[name] == {"aukit.engine.step"}
    # the staged bytes and masks beside the stage, the filter's rows in the launch
    assert parents["aukit.engine.htod"] == {"aukit.engine.step", "aukit.engine.launch"}
    assert {r.step for r in records} == {steps}
    assert len(got["aukit.engine.step"]) == 1 and len(got["aukit.engine.stage"]) == 2


def test_flac_fleet_step_records_its_spans():
    data, _ = flac_stream(3, 6)
    fleet = FlacFleet(2, device="cpu")
    fleet.feed(0, data[:4000])
    fleet.feed(1, data)
    fleet.feed(1, None)
    fleet.step()
    fleet.feed(0, data[4000:])
    fleet.feed(0, None)
    records, _events, _host = profiled(fleet.step)
    got = by_name(records)
    assert set(got) == {"aukit.flac.step", "aukit.flac.parse", "aukit.flac.restore",
                        "aukit.flac.dsp"}
    assert [r.parent for r in got["aukit.flac.step"]] == [None]
    for name in ("aukit.flac.parse", "aukit.flac.restore", "aukit.flac.dsp"):
        assert [r.parent for r in got[name]] == ["aukit.flac.step"]
    assert {r.step for r in records} == {1}
    assert got["aukit.flac.parse"][0].counts["frames_parsed"] > 0


def test_fleet_step_records_its_spans():
    rng = np.random.default_rng(4)
    data, _ = flac_stream(5, 50)
    pcm = fixtures.wav_pcm(rng.integers(-3000, 3000, (1, 48000 * 2)), 48000, 16)
    fleet = Fleet([data, pcm], eof=True, device="cpu")
    records, _events, _host = profiled(fleet.step)
    got = by_name(records)
    assert {"aukit.fleet.step", "aukit.fleet.htod", "aukit.engine.step", "aukit.flac.step",
            "aukit.flac.parse", "aukit.flac.restore", "aukit.flac.dsp", "aukit.engine.stage",
            "aukit.engine.htod", "aukit.engine.launch", "aukit.engine.fifo"} == set(got)
    parent = {name: {r.parent for r in rs} for name, rs in got.items()}
    assert parent["aukit.fleet.step"] == {None}
    for name in ("aukit.fleet.htod", "aukit.engine.step", "aukit.flac.step"):
        assert parent[name] == {"aukit.fleet.step"}
    assert len(got["aukit.fleet.htod"]) == 1
    assert got["aukit.fleet.htod"][0].counts == {"htod_copies": 2,
                                                 "htod_bytes": 48000 * 4 + 2}
    assert {r.step for r in got["aukit.engine.step"] + got["aukit.flac.step"]} == {0}
    assert fleet.metrics.htod_copies == fleet.engine.metrics.htod_copies + 2


# -- the profiler's timeline ---------------------------------------------------------

def test_records_lie_on_the_profilers_timeline():
    """Moved onto the profiler's clock by the ticks (the median offset of
    the profiler's ``tick`` starts from the host's), every record lies within
    its profiler event widened by 50 us on each side: the record
    is timed inside the range's entry and exit."""
    rng = np.random.default_rng(6)
    eng = pcm_engine()
    feeds = pcm_feeds(rng)

    def tick():
        eng.feed_many(feeds)
        eng.step()

    records, events, host = profiled(tick, ticks=3)
    ticks = sorted((e.time_range.start, e.time_range.end) for e in events if e.name == "tick")
    assert len(ticks) == len(host) == 3
    off = statistics.median(p[0] - h[0] / 1e3 for p, h in zip(ticks, host))
    evs = by_name(e for e in events if e.name.startswith("aukit."))
    recs = by_name(records)
    assert set(evs) == set(recs)
    worst = 0.0
    for name, rs in recs.items():
        es = sorted(evs[name], key=lambda e: e.time_range.start)
        assert len(es) == len(rs)
        for r, e in zip(sorted(rs, key=lambda r: r.start_ns), es):
            worst = max(worst, e.time_range.start - (r.start_ns / 1e3 + off),
                        r.end_ns / 1e3 + off - e.time_range.end)
    assert worst < 50.0, worst


# -- the counters ----------------------------------------------------------------------

def test_engine_counters_equal_the_fed_inputs():
    """``bytes_staged`` is every fed byte (whole chunks), ``lanes_ready`` a
    lane a chunk, and the copies are, each group step, the staged bytes and
    the ready mask, plus the filter's four rows (gain, kind, alpha, started)
    in groups with a filter set."""
    rng = np.random.default_rng(7)
    eng = pcm_engine()
    feeds = pcm_feeds(rng, seconds=2)
    eng.feed_many(feeds)
    while eng.step() is not None:
        pass
    m = eng.metrics
    assert m.bytes_staged == sum(len(f) for f in feeds)
    chunks = [len(f) // g.in_bytes for f, g in zip(feeds[::3], eng.groups)]
    assert m.lanes_ready == 3 * sum(chunks)
    copies = nbytes = 0
    for g, k in zip(eng.groups, chunks):
        copies += k * (2 + 4)  # every group holds a filtered lane
        nbytes += k * (g.lanes * g.in_bytes + g.lanes + g.lanes * (4 + 4 + 4 + 1))
    assert (m.htod_copies, m.htod_bytes) == (copies, nbytes)


def test_flac_counters_equal_the_fed_frames():
    datas = [flac_stream(8 + i, 3 + 2 * i) for i in range(3)]
    fleet = FlacFleet(3, device="cpu")
    for lane, (data, _) in enumerate(datas):
        for at in range(0, len(data), 1500):
            fleet.feed(lane, data[at: at + 1500])
            fleet.step()
        fleet.feed(lane, None)
    while fleet.step() is not None:
        pass
    assert fleet.metrics.frames_parsed == sum(len(sizes) for _, sizes in datas)
    assert fleet.metrics.bytes_parsed == sum(sum(sizes) for _, sizes in datas)


# -- the ring, the names, the exported trace ---------------------------------------------

def test_the_ring_stays_bounded():
    trace.clear_span_records()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(trace.RING + 5):
            with trace.span("aukit.test"):
                pass
    records = trace.span_records()
    assert len(records) == trace.RING
    assert records[0].start_ns > 0 and records[-1].name == "aukit.test"
    trace.clear_span_records()
    assert trace.span_records() == []


def test_no_program_span_shares_a_harness_name():
    names = set()
    for path in PACKAGE.rglob("*.py"):
        names |= set(re.findall(r'span\("([^"]+)"', path.read_text()))
    assert len(names) == 12
    assert all(n.startswith("aukit.") for n in names)
    assert not names & HARNESS_SPANS


def test_trace_session_names_the_engine_step(tmp_path):
    rng = np.random.default_rng(9)
    eng = pcm_engine()
    eng.feed_many(pcm_feeds(rng))
    with trace.trace_session(str(tmp_path / "tr"), device="cpu"):
        eng.step()
    (path,) = (tmp_path / "tr").glob("*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"aukit.engine.step", "aukit.engine.stage", "aukit.engine.launch"} <= names
    assert [r.name for r in trace.span_records()].count("aukit.engine.step") == 1


@pytest.mark.parametrize("kind", ["dfpwm", "pcm8"])
def test_encoder_step_records_its_spans(kind):
    from aukit_tpu_torch.stream.batch_encode import BatchEncodeEngine, EncodeSpec

    enc = BatchEncodeEngine([EncodeSpec(kind)] * 2, chunk_samples=64, device="cpu")
    for lane in range(2):
        enc.feed(lane, np.linspace(-0.5, 0.5, 64))
    records, _events, _host = profiled(enc.step)
    got = by_name(records)
    assert set(got) == {"aukit.engine.step", "aukit.engine.stage", "aukit.engine.htod",
                        "aukit.engine.launch"}
    assert {r.parent for r in got["aukit.engine.htod"]} == {"aukit.engine.step"}
    assert enc.metrics.bytes_staged == 2 * 64 * 4 and enc.metrics.lanes_ready == 2
