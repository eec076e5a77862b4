"""aukit_tpu_torch's playback (``play``, ``player``, ``play_fleet``, the sinks,
``play_file``) and ``utils.trace`` against the JAX package: twins of the
playback tests of tests/test_stream.py (4, and the WebSocket ingestion),
tests/test_fleet.py (3) and tests/test_batch.py (1). The same seeded inputs
go through ``aukit_tpu.playback`` and ``aukit_tpu_torch.playback`` on the CPU
(the port's engines with ``device="cpu"``); every sink's captured int8 bytes
are held equal (tolerance 0), beside each JAX test's own assertions.

The port's chunks and windows may be torch tensors (a fleet's windows are,
``stream.pcm``'s device twin yields them): the playback engines bring each
to the host once, and the sinks see the same bytes as for numpy chunks.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import aukit_tpu as ak
import aukit_tpu_torch as tk
from aukit_tpu import playback as jpb
from aukit_tpu.stream import batch as jax_batch
from aukit_tpu.stream import fleet as jax_fleet
from aukit_tpu_torch import playback as tpb
from aukit_tpu_torch.stream import batch, fleet
from tests import fixtures
from tests.test_flac_fleet import make_flac

RNG = np.random.default_rng(2112)
PACKAGES = ((ak, jpb), (tk, tpb))


def wait_for(cond, seconds: float = 10.0):
    deadline = time.time() + seconds
    while time.time() < deadline and not cond():
        time.sleep(0.01)


def twin_fleets(sources, **kw):
    """(JAX Fleet, port Fleet on the CPU) over the same container bytes."""
    return jax_fleet.Fleet(sources, **kw), fleet.Fleet(sources, device="cpu", **kw)


def fleet_collect(f):
    """Each station's concatenated windows (test_fleet.py's ``collect``)."""
    outs = [[] for _ in f.stations]
    for _ in range(10000):
        if f.done:
            break
        r = f.step()
        if r is None:
            continue
        w = r[0].numpy() if isinstance(r[0], torch.Tensor) else np.asarray(r[0])
        for i in range(len(f.stations)):
            if r[1][i]:
                outs[i].append(w[i])
    return [np.concatenate(o, axis=-1) if o else np.zeros(0, np.int8) for o in outs]


# -- tests/test_stream.py ----------------------------------------------------------------


def test_play_split_rule_and_backpressure():
    big = np.zeros((1, 120000), np.float32)
    sizes = []
    for pkg, pb in PACKAGES:
        sink = pb.BufferSink()
        pkg.play(iter([(big, 0.0)]), sink)
        sizes.append([c.shape[-1] for c in sink.chunks])
    assert sizes[0] == sizes[1] == [48000, 48000, 24000]


def test_player_pause_seek():
    chunks = [(np.full((1, 48000), float(i), np.float32), float(i)) for i in range(3)]
    outs = []
    for pkg, pb in PACKAGES:
        sink = pb.BufferSink()
        p = pkg.player(iter(chunks), sink)
        wait_for(lambda: len(sink.samples()) >= 3 * 48000)
        p.stop()
        outs.append(sink.samples())
    assert len(outs[1]) == 3 * 48000 and outs[1][0] == 0 and outs[1][-1] == 2
    np.testing.assert_array_equal(outs[1], outs[0])


def test_player_windows_span_chunk_boundaries():
    n, total = 12345, 12345 * 9  # windows never align with chunk edges
    ramp = (np.arange(total) % 101 - 50).astype(np.float32)
    chunks = [(ramp[None, i: i + n], i / 48000.0) for i in range(0, total, n)]
    outs = []
    for pkg, pb in PACKAGES:
        sink = pb.BufferSink()
        p = pkg.player(iter(chunks), sink)
        wait_for(lambda: len(sink.samples()) >= total)
        p.stop()
        outs.append(sink.samples())
    np.testing.assert_array_equal(outs[1], ramp)
    np.testing.assert_array_equal(outs[1], outs[0])


def test_play_multi_sink_channel_fanout():
    chunk = np.concatenate([np.full((1, 1000), 10.0, np.float32),
                            np.full((1, 1000), -20.0, np.float32)], axis=0)
    outs = []
    for pkg, pb in PACKAGES:
        sinks = [pb.BufferSink() for _ in range(3)]
        pkg.play(iter([(chunk, 0.0)]), *sinks)
        outs.append([s.samples() for s in sinks])
    (j1, j2, j3), (s1, s2, s3) = outs
    assert s1[0] == 10 and s2[0] == -20 and s3[0] == 10  # sink 3 falls back to channel 1
    for g, w in zip((s1, s2, s3), (j1, j2, j3)):
        np.testing.assert_array_equal(g, w)


def test_ws_ingestion_end_to_end():
    """A ws:// source through the port's austream ``open_source`` feeds the
    port's ``stream.wav``: the chunks equal the JAX package's over its own
    ``open_source`` of the same server, and ``stream.pcm`` of the payload."""
    pytest.importorskip("websockets")
    from websockets.sync.server import serve

    from aukit_tpu.cli.austream import open_source as jax_open
    from aukit_tpu_torch.cli.austream import open_source

    sig = RNG.integers(-3000, 3000, 48000)
    payload = sig.astype("<i2").tobytes()
    data = fixtures.wav_pcm(sig[None, :], 48000, 16)
    chunks = [data[i: i + 4096] for i in range(0, len(data), 4096)]

    def handler(conn):
        for c in chunks:
            conn.send(c)
        conn.close()

    got = {}
    with serve(handler, "127.0.0.1", 0) as server:
        port = server.socket.getsockname()[1]
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        src = open_source(f"ws://127.0.0.1:{port}", True)
        it, _ = tk.stream.wav(src, device="cpu")
        got["port"] = np.concatenate([c for c, _ in it], axis=1)
        it, _ = ak.stream.wav(jax_open(f"ws://127.0.0.1:{port}", True))
        got["jax"] = np.concatenate([np.asarray(c) for c, _ in it], axis=1)
        server.shutdown()
    it2, _ = tk.stream.pcm(payload, 16, "signed", 1, 48000, False, False)
    exp = np.concatenate([c for c, _ in it2], axis=1)
    np.testing.assert_array_equal(got["port"], exp)
    np.testing.assert_array_equal(got["port"], got["jax"])


def test_play_refuses_a_chunk_over_the_sink_limit():
    """A chunk of 48,001 to 95,999 samples passes ``play``'s split rule
    whole and the sink refuses it (its limit is 48000), in both packages
    with the same error (ROADMAP fault 3.11: the IMA, MS ADPCM, QOA and
    DFPWM-in-WAV iterators' chunks at 44.1 kHz). The port's decode thread
    has ended when the error reaches the caller."""
    chunks = [(np.zeros((1, 48620), np.float32), float(i)) for i in range(12)]
    msgs = []
    for pkg, pb in PACKAGES:
        before = set(threading.enumerate())
        with pytest.raises(ValueError, match="chunk too large") as ei:
            pkg.play(iter(chunks), pb.BufferSink())
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0] == "chunk too large (48620 > 48000)"
    assert set(threading.enumerate()) <= before


# -- tests/test_fleet.py -----------------------------------------------------------------


def test_fleet_facade_station_iterator_playback():
    """``station_iterator`` into ``play``: the port's station chunks (CPU
    tensors) reach the sink as the JAX station's do."""
    wav = ak.tone(330, 1.0, 0.5, "sine", sample_rate=24000).wav(16)
    outs = []
    for f, pb in zip(twin_fleets([wav]), (jpb, tpb)):
        sink = pb.BufferSink()
        pb.play(f.station_iterator(0), sink)
        outs.append(sink.samples())
    assert len(outs[1]) >= 47000 and np.abs(outs[1]).max() > 20
    np.testing.assert_array_equal(outs[1], outs[0])


def test_play_fleet_concurrent_stations():
    """play_fleet over stereo stations with sink tuples: every sink equals
    the sequential collect() and the JAX play_fleet's sink."""
    wav = ak.tone(440, 1.0, 0.5, "sine", sample_rate=24000).wav(16)
    flac = make_flac(44100, 60, channels=2, chan_asgn=10, seed=98)
    expected = fleet_collect(fleet.Fleet([wav, flac], mono=False, channels=2, device="cpu"))
    outs = []
    for f, pb in zip(twin_fleets([wav, flac], mono=False, channels=2), (jpb, tpb)):
        sinks = [(pb.BufferSink(), pb.BufferSink()) for _ in range(2)]
        seen = []
        pb.play_fleet(f, sinks, progress=lambda i, p: seen.append((i, p)))
        outs.append(([[s.samples() for s in pair] for pair in sinks], seen))
    (jax_out, jax_seen), (got, seen) = outs
    for st in range(2):
        for ch in range(2):
            np.testing.assert_array_equal(got[st][ch], expected[st][ch])
            np.testing.assert_array_equal(got[st][ch], jax_out[st][ch])
    assert any(i == 1 for i, _ in seen)
    assert sorted(seen) == sorted(jax_seen)


def refusing_sink(pb):
    class RefusingSink(pb.SinkBase):
        def __init__(self):
            super().__init__()
            self.attempts = 0

        def play_audio(self, samples, volume=None):
            self.attempts += 1
            return False  # forever full

        def wait_drain(self, timeout=None):
            time.sleep(min(timeout or 0.1, 0.1))
            return False

        def _consume(self, samples, volume):
            pass

    return RefusingSink()


def test_play_fleet_drop_isolates_slow_sink():
    """drop=True: a sink that never accepts cannot stall the batch; the
    healthy station receives all its audio, as in the JAX play_fleet."""
    wav = ak.tone(440, 1.0, 0.5, "sine", sample_rate=24000).wav(16)
    expected = fleet_collect(fleet.Fleet([wav, wav], device="cpu"))
    outs = []
    for f, pb in zip(twin_fleets([wav, wav]), (jpb, tpb)):
        slow, ok = refusing_sink(pb), pb.BufferSink()
        done = threading.Event()

        def run():
            pb.play_fleet(f, [slow, ok], drop=True, queue_windows=1)
            done.set()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        done.wait(20)
        t.join(5)
        assert done.is_set() and not t.is_alive()
        assert slow.attempts > 0
        outs.append(ok.samples())
    np.testing.assert_array_equal(outs[1], expected[1])
    np.testing.assert_array_equal(outs[1], outs[0])


# -- tests/test_batch.py -----------------------------------------------------------------


def test_batch_multichannel_playback_fanout():
    """lane_iterator + play: a stereo engine lane drives two sinks, sink i
    receiving channel i, as the JAX engine's lane does."""
    rate = 24000
    t = np.arange(rate)
    left = (np.sin(t / 9.0) * 20000).astype(np.int16)
    right = (np.cos(t / 5.0) * 15000).astype(np.int16)
    inter = np.stack([left, right], axis=1).reshape(-1).tobytes()
    outs = []
    for eng, pb in ((jax_batch.BatchStreamEngine([jax_batch.LaneSpec("pcm16", rate, 2)],
                                                 mono=False), jpb),
                    (batch.BatchStreamEngine([batch.LaneSpec("pcm16", rate, 2)], mono=False,
                                             device="cpu"), tpb)):
        eng.feed(0, inter)
        eng.feed(0, None)
        s1, s2 = pb.BufferSink(), pb.BufferSink()
        pb.play(eng.lane_iterator(0), s1, s2)
        outs.append((s1.samples(), s2.samples()))
    for g, w in zip(outs[1], outs[0]):
        assert len(g) >= rate * 2 - 1 and np.abs(g).max() > 50
        np.testing.assert_array_equal(g, w)


# -- the port's own: torch tensors, play_file, trace_session --------------------------------


def tensor_chunks(chunks):
    return [(torch.from_numpy(c.copy()), p) for c, p in chunks]


def test_play_and_player_take_tensors():
    """``play`` and ``Player`` fed torch tensors give the sinks the bytes
    that numpy chunks give them."""
    x = (RNG.random((2, 130000)) * 300 - 150).astype(np.float32)
    chunks = [(x[:, i: i + 40000], i / 48000) for i in range(0, x.shape[1], 40000)]
    outs = {}
    for kind, feed in (("numpy", chunks), ("tensor", tensor_chunks(chunks))):
        a, b = tpb.BufferSink(), tpb.BufferSink()
        tk.play(iter(feed), a, b, volume=0.5)
        s = tpb.BufferSink()
        p = tk.player(iter(feed), s)
        wait_for(lambda: len(s.samples()) >= x.shape[1])
        p.stop()
        p.join(5)
        outs[kind] = (a.samples(), b.samples(), s.samples())
        assert [c.shape[-1] for c in a.chunks] == [40000, 40000, 40000, 10000]
    for g, w in zip(outs["tensor"], outs["numpy"]):
        assert len(g) == x.shape[1]
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(outs["numpy"][0], np.clip(np.floor(x[0]), -128, 127))


class WindowSource:
    """A batched source of fixed windows (``step`` -> (windows, mask,
    positions) | None), as numpy arrays or as tensors."""

    def __init__(self, windows, as_tensor: bool):
        self.windows = list(windows)
        self.as_tensor = as_tensor
        self.done = False

    def step(self):
        if not self.windows:
            self.done = True
            return None
        w, mask = self.windows.pop(0)
        pos = np.zeros(len(mask))
        return (torch.from_numpy(w.copy()) if self.as_tensor else w), mask, pos


def test_play_fleet_takes_tensor_windows():
    """``play_fleet`` over tensor windows (``int8[N, T]`` and
    ``int8[N, C, T]``) fills every station's sinks as numpy windows do."""
    for shape in ((3, 4800), (3, 2, 4800)):
        wins = [(RNG.integers(-128, 128, shape).astype(np.int8),
                 np.array([True, k != 1, True])) for k in range(3)]
        outs = []
        for as_tensor in (False, True):
            sinks = [(tpb.BufferSink(), tpb.BufferSink()) for _ in range(3)]
            tpb.play_fleet(WindowSource(wins, as_tensor), sinks)
            outs.append([[s.samples() for s in pair] for pair in sinks])
        for st in range(3):
            want = np.concatenate([w[st] for w, m in wins if m[st]], axis=-1)
            want = want if want.ndim == 2 else np.stack([want, want])
            for ch in range(2):
                np.testing.assert_array_equal(outs[1][st][ch], want[ch])
                np.testing.assert_array_equal(outs[1][st][ch], outs[0][st][ch])


def play_file_cases():
    sig = RNG.integers(-9000, 9000, (2, 22050))
    qoa = fixtures.qoa_stream(np.random.default_rng(7), 1, 44100, [5120] * 3)
    dfpwm = np.random.default_rng(8).integers(0, 256, 3000, dtype=np.uint8).tobytes()
    return {"wav": fixtures.wav_pcm(sig, 22050, 16), "qoa": qoa, "dfpwm": dfpwm}


@pytest.mark.parametrize("kind", ["wav", "qoa", "dfpwm"])
def test_play_file_matches_jax(kind, tmp_path):
    path = tmp_path / f"x.{kind}"
    path.write_bytes(play_file_cases()[kind])
    outs = []
    for pkg, pb, kw in ((ak, jpb, {}), (tk, tpb, {"device": "cpu"})):
        sinks = [pb.BufferSink(), pb.BufferSink()]
        pkg.play_file(str(path), *sinks, volume=0.7, **kw)
        outs.append([s.samples() for s in sinks])
    for g, w in zip(outs[1], outs[0]):
        assert len(g) > 0
        np.testing.assert_array_equal(g, w)


def test_trace_session_writes_a_trace(tmp_path):
    """``trace_session(dir, device="cpu")`` writes a Chrome trace into
    ``dir`` that names an operation run inside the block."""
    from aukit_tpu_torch.utils.trace import trace_session

    x = torch.arange(4096, dtype=torch.float32)
    with trace_session(str(tmp_path / "tr"), device="cpu"):
        torch.cumsum(x, 0)
    files = list((tmp_path / "tr").glob("*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::cumsum" in names


def test_entry_points_raise_without_a_card(tmp_path):
    """``play_file`` and ``trace_session`` default to the card and raise
    without one; nothing carries on on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from aukit_tpu_torch.utils.trace import trace_session

    path = tmp_path / "x.wav"
    path.write_bytes(play_file_cases()["wav"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tk.play_file(str(path), tpb.BufferSink())
    with pytest.raises(RuntimeError, match="CUDA"):
        with trace_session(str(tmp_path / "tr")):
            pass
