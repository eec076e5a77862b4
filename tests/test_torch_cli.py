"""aukit_tpu_torch's four programs (``cli.auplay``, ``.austream``,
``.austream_tm``, ``.auconvert``) against the JAX package's: twins of the 15
tests of tests/test_cli.py, and of tests/test_fuzz.py's map-language fuzz.
Each runs ``aukit_tpu.cli.X.main(argv)`` (JAX on the CPU) and
``aukit_tpu_torch.cli.X.main(argv + ["--device", "cpu"])`` on the same
seeded inputs, beside the JAX test's own assertions.

Tolerances: output files and standard output are equal byte for byte, but
for auplay's lowpass (the one-pole scan's residue, ROADMAP fault 3.2, held
as tests/test_torch_auplay.py holds it): at least 99.8% of its int8 bytes
equal and the rest within 1 LSB, and every byte equal with the port's scan
swapped for the JAX package's jitted ``_affine_scan``. TCP tests use local
sockets only.

Also here: the constructor slots of ``Fleet``, ``BatchEncodeEngine`` and
``BatchDfpwmEncoder`` (a positional call in the JAX package's order binds
the same arguments in both packages; ``device`` is keyword only), the
effects namespace that ``auconvert -e list`` reads, and the programs'
default device (the card: without one they raise).
"""

import inspect
import os
import random
import socket
import threading
import time

import numpy as np
import pytest
import torch

import aukit_tpu as ak
import aukit_tpu_torch as tk
from aukit_tpu import effects as jfx
from aukit_tpu.cli import auconvert as jconvert
from aukit_tpu.cli import auplay as jplay
from aukit_tpu.cli import austream as jstream
from aukit_tpu.cli import austream_tm as jstream_tm
from aukit_tpu.stream import batch_encode as jax_encode
from aukit_tpu.stream import fleet as jax_fleet
from aukit_tpu_torch import effects as tfx
from aukit_tpu_torch.cli import auconvert, auplay, austream, austream_tm
from aukit_tpu_torch.stream import batch_encode, fleet

CPU = ["--device", "cpu"]
SCAN_EQUAL_FRAC = 0.998  # tests/test_torch_auplay.py's bound on the lowpass


@pytest.fixture
def wav_file(tmp_path):
    a = ak.tone(440, 0.5, 0.7, "sine", channels=2, sample_rate=44100)
    p = tmp_path / "t.wav"
    p.write_bytes(a.wav(16))
    return str(p)


def twin_run(jax_main, port_main, argv, tmp_path, outs, capsys=None):
    """Both programs over ``argv`` with each ``{name}`` placeholder turned
    into a path of the package's own: -> ({name: (JAX bytes, port bytes)},
    (JAX stdout, port stdout) when ``capsys`` is given)."""
    printed = []
    for tag, main, extra in (("jax", jax_main, []), ("port", port_main, CPU)):
        args = list(argv)
        for o in outs:
            args = [a.replace("{" + o + "}", str(tmp_path / f"{tag}_{o}")) for a in args]
        main(args + extra)
        if capsys is not None:
            printed.append(capsys.readouterr().out.replace(str(tmp_path / tag), "OUT"))
    files = {o: tuple((tmp_path / f"{tag}_{o}").read_bytes() for tag in ("jax", "port"))
             for o in outs}
    return files, tuple(printed)


def assert_lowpass_close(got: bytes, want: bytes):
    g, w = np.frombuffer(got, np.int8), np.frombuffer(want, np.int8)
    assert g.shape == w.shape
    assert np.abs(g.astype(np.int16) - w).max() <= 1
    assert (g == w).mean() >= SCAN_EQUAL_FRAC


def jax_scan(A, B):
    """The JAX package's jitted scan on the port's tensors."""
    return torch.from_numpy(np.array(jfx._affine_scan(A.numpy(), B.numpy())))


# -- tests/test_cli.py -------------------------------------------------------------------


def test_auplay(wav_file, tmp_path):
    files, _ = twin_run(jplay.main, auplay.main, [wav_file, "-o", "{out}"], tmp_path, ["out"])
    want, got = files["out"]
    data = np.frombuffer(got, np.int8)
    assert len(data) == 24000  # 0.5 s @48k mono
    assert np.abs(data.astype(np.int32)).max() > 50
    assert_lowpass_close(got, want)


def test_auplay_bit_equal_given_jax_scan(wav_file, tmp_path, monkeypatch):
    """The witness for auplay's residue: with the port's scan swapped for
    the jitted JAX scan, its output file equals the JAX program's."""
    monkeypatch.setattr(tfx, "_linear_scan", jax_scan)
    files, _ = twin_run(jplay.main, auplay.main, [wav_file, "-o", "{out}"], tmp_path, ["out"])
    assert files["out"][0] == files["out"][1]


def test_austream_params_and_dispatch(wav_file, tmp_path):
    files, _ = twin_run(jstream.main, austream.main, [wav_file, "mono=true,volume=0.5", "-o",
                                                      "{s}"], tmp_path, ["s"])
    want, got = files["s"]
    assert len(got) > 20000 and got == want
    text = "type=pcm,sampleRate=8000,channels=2,mono=true,volume=0.25"
    v = austream.parse_params(text)
    assert v == {"type": "pcm", "sampleRate": 8000, "channels": 2, "mono": True, "volume": 0.25}
    assert v == jstream.parse_params(text)


def test_auconvert_simple(wav_file, tmp_path, capsys):
    files, (jout, out) = twin_run(jconvert.main, auconvert.main,
                                  ["-i", wav_file, "-o", "{o.dfpwm}", "-e", "mono", "-R", "48000"],
                                  tmp_path, ["o.dfpwm"], capsys)
    want, got = files["o.dfpwm"]
    assert len(got) == 48000 * 0.5 // 8 and got == want
    assert out == jout and "auconvert, using aukit-tpu 0.3.0 (AUKit 1.10.0 semantics)" in out


def test_auconvert_map_language(wav_file, tmp_path, capsys):
    files, (jout, out) = twin_run(
        jconvert.main, auconvert.main,
        ["-i", wav_file, "-o", "{m.wav}", "-m", "1&2=1", "-m", "1[,0]*2=2", "-B", "16"],
        tmp_path, ["m.wav"], capsys)
    want, got = files["m.wav"]
    b = tk.wav(got, device="cpu")
    assert b.channels == 2 and b.duration == 1.0  # channel 2 = full slice repeated twice
    assert got == want and out == jout


@pytest.mark.parametrize("text", ["1:2=2:1", "1+2&3=1", "(1+2)*3=1", "1[2,3]+2:1*4=3",
                                  "12&(3+4)[,5]=2:3"])
def test_auconvert_map_parser(text):
    assert auconvert.parse_map(text) == jconvert.parse_map(text)
    if text == "1:2=2:1":
        assert auconvert.parse_map(text) == (2, 1, [{"file": 1, "channel": 2}])
    if text == "1+2&3=1":  # & binds tighter than +: 1+(2&3)
        assert [t for t in auconvert.parse_map(text)[2] if isinstance(t, str)] == ["&", "+"]
    if text == "(1+2)*3=1":
        assert auconvert.parse_map(text)[2] == [{"channel": 1}, {"channel": 2}, "+", 3, "*"]


@pytest.mark.parametrize("text", ["1(=1", "hello", "1)=1", "(1=1", "1:2:3=1", "1[2]=1"])
def test_auconvert_map_parser_rejects(text):
    with pytest.raises(SystemExit) as want:
        jconvert.parse_map(text)
    with pytest.raises(SystemExit) as got:
        auconvert.parse_map(text)
    assert type(got.value).__name__ == type(want.value).__name__ == "MapError"
    assert str(got.value) == str(want.value)


def test_auconvert_wav8_unsigned(wav_file, tmp_path):
    files, _ = twin_run(jconvert.main, auconvert.main, ["-i", wav_file, "-o", "{u8.wav}", "-B",
                                                        "8"], tmp_path, ["u8.wav"])
    want, got = files["u8.wav"]
    assert tk.wav(got, device="cpu").info == {"dataType": "unsigned", "bitDepth": 8}
    assert got == want


class FakePlayer:
    def __init__(self):
        self.is_paused = False
        self.seeked = []
        self.stopped = False

    def pause(self):
        self.is_paused = True

    def play(self):
        self.is_paused = False

    def live_position(self):
        return 10.0

    def seek(self, p):
        self.seeked.append(p)

    def stop(self):
        self.stopped = True


def test_austream_tm_keyboard_loop():
    keys = [" ", " ", "left", "right", "\x1b[D", " ", "q", " "]
    states = []
    for loop in (jstream_tm.keyboard_loop, austream_tm.keyboard_loop):
        fp, flag = FakePlayer(), threading.Event()
        loop(fp, flag, key_source=iter(keys))
        states.append((fp.is_paused, fp.seeked, fp.stopped, flag.is_set()))
    assert states[1] == states[0] == (True, [5.0, 15.0, 5.0], True, True)


@pytest.mark.parametrize("name", ["nosuch", "fma_kernel", "linear_scan", "_set", "Audio"])
def test_auconvert_unknown_effect_rejected(name, wav_file, tmp_path):
    """Both programs refuse an effect the JAX effects module lacks, the
    port's private kernel imports included."""
    for main, extra in ((jconvert.main, []), (auconvert.main, CPU)):
        with pytest.raises(SystemExit, match="Unknown effect"):
            main(["-i", wav_file, "-o", str(tmp_path / "x.wav"), "-e", name] + extra)


def serve_once(payload: bytes):
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def serve():
        conn, _ = srv.accept()
        for i in range(0, len(payload), 8192):
            conn.sendall(payload[i: i + 8192])
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return srv, t


def test_austream_tcp_source(tmp_path):
    """tcp:// ingestion: each program reads the same payload from a local
    server of its own; the outputs are equal."""
    payload = np.clip(np.random.default_rng(0).integers(-500, 500, 48000), -32768,
                      32767).astype("<i2").tobytes()
    got = []
    for main, extra in ((jstream.main, []), (austream.main, CPU)):
        srv, t = serve_once(payload)
        out = tmp_path / f"tcp{len(got)}.raw"
        main([f"tcp://127.0.0.1:{srv.getsockname()[1]}",
              "type=pcm,bitDepth=16,dataType=signed,sampleRate=48000", "-o", str(out)] + extra)
        t.join(5)
        srv.close()
        assert not t.is_alive()
        got.append(out.read_bytes())
    assert len(got[1]) == 48000 and got[1] == got[0]


def fan_in(listen, proto_lines, payloads):
    """Feeds ``payloads`` over one connection each to a fresh listen source;
    -> the bytes its data function returned, in arrival order."""
    data_fn, port = listen(0, "radio")
    barrier = threading.Barrier(len(payloads))

    def feed(payload, proto_line):
        s = socket.create_connection(("127.0.0.1", port))
        try:
            s.sendall(proto_line)
            s.sendall(payload)
        except OSError:
            pass  # the filtered feeder may be dropped mid-send
        try:
            barrier.wait(timeout=10)  # keep connections open until all have sent
        except threading.BrokenBarrierError:
            pass
        time.sleep(0.05)
        s.close()

    threads = [threading.Thread(target=feed, args=a) for a in zip(payloads, proto_lines)]
    for t in threads:
        t.start()
    got = bytearray()
    while (d := data_fn()) is not None:
        got.extend(d)
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    return bytes(got)


def test_tcp_listen_broadcast_fan_in():
    """Two feeders fan in, a feeder with another protocol line is dropped:
    both programs' listen sources deliver the same bytes (their order is
    the arrival order)."""
    half = 24000
    sig = np.random.default_rng(4).integers(0, 256, 2 * half, dtype=np.uint8).tobytes()
    payloads = [sig[:half], sig[half:], b"\xff" * 999]
    lines = [b"radio\n", b"radio\n", b"tv\n"]
    got = [fan_in(mod._tcp_listen_source, lines, payloads) for mod in (jstream, austream)]
    assert len(got[1]) == 2 * half
    assert sorted(got[1]) == sorted(sig) == sorted(got[0])


def test_austream_plays_from_two_tcp_feeders(tmp_path, monkeypatch):
    """The port's austream fed by its broadcast listen source from two
    feeders in turn: its output equals the JAX program's over the same bytes
    as a file."""
    rng = np.random.default_rng(11)
    half = 24000
    payload = rng.integers(0, 256, 2 * half, dtype=np.uint8).tobytes()
    params = "type=pcm,bitDepth=8,dataType=signed,sampleRate=48000"
    out = tmp_path / "out.pcm"
    bound = {}
    orig = austream._tcp_listen_source

    def wrapped(port, proto):
        fn, p = orig(port, proto)
        bound["port"] = p
        return fn, p

    monkeypatch.setattr(austream, "_tcp_listen_source", wrapped)
    t = threading.Thread(target=austream.main, args=(["tcp://listen:0?proto=radio", params,
                                                      "-o", str(out)] + CPU,), daemon=True)
    t.start()
    for _ in range(100):
        if "port" in bound:
            break
        time.sleep(0.05)
    assert "port" in bound
    barrier = threading.Barrier(2)

    def feed(chunk, delay):
        s = socket.create_connection(("127.0.0.1", bound["port"]))
        time.sleep(delay)
        s.sendall(b"radio\n")
        s.sendall(chunk)
        try:
            barrier.wait(timeout=10)
        except threading.BrokenBarrierError:
            pass
        time.sleep(0.05)
        s.close()

    # feeder order enforced by delays so the byte stream is deterministic
    f1 = threading.Thread(target=feed, args=(payload[:half], 0.0))
    f1.start()
    f1.join(timeout=5)
    f2 = threading.Thread(target=feed, args=(payload[half:], 0.2))
    f2.start()
    t.join(timeout=60)
    f1.join(timeout=5)
    f2.join(timeout=5)
    assert not t.is_alive()
    src = tmp_path / "in.pcm"
    src.write_bytes(payload)
    want = tmp_path / "want.pcm"
    jstream.main([str(src), params, "-o", str(want)])
    assert len(out.read_bytes()) == 2 * half
    assert out.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("kind", ["ima", "msadpcm", "qoa"])
def test_austream_refuses_wide_chunks_as_in_jax(kind, tmp_path):
    """The IMA and MS ADPCM WAV and QOA iterators at 44.1 kHz yield chunks
    of 48,356 to 50,155 samples, which ``play`` passes whole and the sink
    refuses: both programs raise the same error (ROADMAP fault 3.11)."""
    from tests import torch_tracks as tracks

    x = tracks.synth_track(1.2, 44100, seed=3)
    raw, ext = {"ima": (tracks.ima_wav, ".wav"), "msadpcm": (tracks.msadpcm_wav, ".wav"),
                "qoa": (tracks.qoa_file, ".qoa")}[kind]
    path = tmp_path / f"x{ext}"
    path.write_bytes(raw(x, 44100))
    msgs = []
    for main, extra in ((jstream.main, []), (austream.main, CPU)):
        with pytest.raises(ValueError, match="chunk too large") as ei:
            main([str(path), "-o", str(tmp_path / "o.raw")] + extra)
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]


PER_FILE_FLAGS = (["-e", "mono"], ["-F", "wav"], ["-B", "16"], ["-T", "signed"], ["-C", "1"],
                  ["-R", "48000"], ["-f", "wav"], ["-b", "16"], ["-t", "signed"], ["-c", "1"],
                  ["-r", "8000"])


@pytest.mark.parametrize("flag", PER_FILE_FLAGS, ids=lambda f: f[0])
def test_auconvert_per_file_flags_before_any_file_error(flag, tmp_path):
    msgs = []
    for main, extra in ((jconvert.main, []), (auconvert.main, CPU)):
        with pytest.raises(SystemExit) as ei:
            main(flag + ["-i", "x.wav", "-o", str(tmp_path / "y.wav")] + extra)
        msgs.append(str(ei.value))
    assert "requires a preceding" in msgs[1] and msgs[1] == msgs[0]


def test_austream_fleet_mode(tmp_path):
    """--fleet: every path a station; volume= drives the decode-side gain;
    -o captures station 0, equal to the JAX program's capture and to the
    port's Fleet run directly."""
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    wav_a = ak.tone(440, 1.0, 0.5, "sine", sample_rate=24000).wav(16)
    a.write_bytes(wav_a)
    b.write_bytes(ak.tone(330, 1.0, 0.5, "sine", sample_rate=24000).wav(16))
    files, _ = twin_run(jstream.main, austream.main,
                        [str(a), "volume=0.5", "--fleet", str(b), "-o", "{out}"], tmp_path,
                        ["out"])
    want, got = files["out"]
    ref = fleet.Fleet([wav_a], device="cpu")
    ref.set_volume(0, 0.5)
    exp = np.concatenate([r[0][0].numpy() for r in iter(ref.step, None) if r[1][0]])
    assert np.frombuffer(got, np.int8).tobytes() == exp.tobytes() and got == want
    base = fleet.Fleet([wav_a], device="cpu")
    base = np.concatenate([r[0][0].numpy() for r in iter(base.step, None) if r[1][0]])
    assert np.abs(exp.astype(np.int32)).sum() < np.abs(base.astype(np.int32)).sum()


def test_auconvert_fleet_transcode(tmp_path, capsys):
    """--fleet: N inputs -> N outputs through the batched decode + encode;
    the outputs and standard output equal the JAX program's, and the port's
    direct Fleet + BatchEncodeEngine + transcode_fleet pipeline."""
    from aukit_tpu_torch.containers.wav import pcm_wav_header

    w1, w2 = tmp_path / "a.wav", tmp_path / "b.wav"
    w1.write_bytes(ak.tone(300, 1.0, 0.6, "sine", sample_rate=48000).wav(16))
    w2.write_bytes(ak.tone(500, 1.5, 0.5, "sine", sample_rate=24000).wav(16))
    files, (jout, out) = twin_run(
        jconvert.main, auconvert.main,
        ["--fleet", "-i", str(w1), "-i", str(w2), "-o", "{a.dfpwm}", "-o", "{b16.wav}", "-B",
         "16"], tmp_path, ["a.dfpwm", "b16.wav"], capsys)
    assert "batched fleet" in out and out == jout
    d, o2 = files["a.dfpwm"][1], files["b16.wav"][1]
    assert files["a.dfpwm"][0] == d and files["b16.wav"][0] == o2
    assert len(d) == 48000 // 8  # 1 s of DFPWM at the window grid
    back = tk.wav(o2, device="cpu")
    assert back.sample_rate == 48000 and back.channels == 1
    assert back.num_samples % 48000 == 0 and back.num_samples >= 2 * 48000
    bodies = batch_encode.transcode_fleet(
        fleet.Fleet([w1.read_bytes(), w2.read_bytes()], device="cpu"),
        batch_encode.BatchEncodeEngine([batch_encode.EncodeSpec("dfpwm"),
                                        batch_encode.EncodeSpec("pcm16")], device="cpu"))
    assert d == bodies[0]
    assert o2 == pcm_wav_header(1, 48000, 16, len(bodies[1])) + bodies[1]


@pytest.mark.parametrize("extra,match", [(["-m", "1=1"], "--map is not available"),
                                         (["-e", "normalize,0.8"], "--effect is not available")])
def test_auconvert_fleet_rejects_maps_effects(extra, match, tmp_path):
    w = tmp_path / "x.wav"
    w.write_bytes(ak.tone(300, 0.3, 0.5, "sine", sample_rate=48000).wav(16))
    for main, dev in ((jconvert.main, []), (auconvert.main, CPU)):
        with pytest.raises(SystemExit, match=match):
            main(["--fleet", "-i", str(w), "-o", str(tmp_path / "y.dfpwm")] + extra + dev)


# -- tests/test_fuzz.py: the map language --------------------------------------------------


def outcome(fn, *args):
    """("ok", the result) or ("raises", the exception's type name): each
    package has its own ``MapError``."""
    try:
        return "ok", fn(*args)
    except (Exception, SystemExit) as e:  # noqa: BLE001 - the exception's type is the outcome
        return "raises", type(e).__name__


def test_auconvert_map_language_fuzz():
    """The fuzz's seeded strings: the port's ``parse_map`` returns the JAX
    one's result or raises the JAX one's exception type, and the fuzz's
    valid maps parse."""
    alphabet = "0123456789+&*[],()=. "
    rng = random.Random(31337)
    outcomes = set()
    for _ in range(300):
        s = "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 24)))
        want = outcome(jconvert.parse_map, s)
        got = outcome(auconvert.parse_map, s)
        assert got == want, s
        outcomes.add(got[0] if got[0] == "ok" else got[1])
    assert outcomes <= {"ok", "MapError", "ValueError", "IndexError", "KeyError"}
    for good in ("1=1", "1+2=1", "1:2=2:1", "(1+2)*3=1", "1+2&3=1"):
        assert auconvert.parse_map(good) == jconvert.parse_map(good)


# -- the port's own: the lists, the effects namespace, the device ---------------------------


@pytest.mark.parametrize("what", [["-e", "list"], ["-f", "list"], ["-F", "list"]])
def test_auconvert_lists_match_jax(what, capsys):
    """``-e list`` (built from the effects module's public callables) and the
    format lists print the JAX program's lines; they need no device."""
    jconvert.main(list(what))
    want = capsys.readouterr().out
    auconvert.main(list(what))
    assert capsys.readouterr().out == want and want.startswith("List of ")


def test_effects_public_callables_match_jax():
    def public(mod):
        return {k for k in dir(mod) if not k.startswith("_") and callable(getattr(mod, k))}

    assert public(tfx) == public(jfx)
    assert {"fma_kernel", "linear_scan"}.isdisjoint(public(tfx))
    assert tk.__version__ == ak.__version__ and tk._REFERENCE_VERSION == ak._REFERENCE_VERSION


@pytest.mark.parametrize("program", ["auplay", "austream", "austream_tm", "auconvert"])
def test_programs_default_to_the_card(program, wav_file, tmp_path):
    """Without ``--device`` a program runs on the card: here, with none,
    it raises ``require_device``'s error instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = str(tmp_path / "o.raw")
    argv = {"auplay": [wav_file, "-o", out], "austream": [wav_file, "-o", out],
            "austream_tm": [wav_file, "-o", out],
            "auconvert": ["-i", wav_file, "-o", str(tmp_path / "o.wav")]}[program]
    main = {"auplay": auplay.main, "austream": austream.main,
            "austream_tm": austream_tm.main, "auconvert": auconvert.main}[program]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert not os.path.exists(tmp_path / "o.wav")


def test_device_option_is_checked():
    for main, argv in ((auplay.main, ["x.wav", "--device", "tpu"]),
                       (auconvert.main, ["-i", "x.wav", "--device", "tpu"]),
                       (auconvert.main, ["-i", "x.wav", "--device"])):
        with pytest.raises(SystemExit):
            main(argv)


# -- the constructors' positional slots ---------------------------------------------------


def bound(cls, *args):
    return dict(inspect.signature(cls).bind(*args).arguments)


def test_fleet_binds_jax_positional_order():
    """``Fleet(sources, eof, mesh, mono, channels, interpolation, use_pallas,
    device_restore, device_dsp)`` binds as in the JAX package, and a call in
    that order builds the fleet those arguments name."""
    wav = ak.tone(440, 0.2, 0.5, "sine", sample_rate=24000).wav(16)
    args = ([wav], True, None, False, 2, "cubic", None, True, True)
    assert bound(fleet.Fleet, *args) == bound(jax_fleet.Fleet, *args)
    assert "device" not in bound(fleet.Fleet, *args)
    assert inspect.signature(fleet.Fleet).parameters["device"].kind is \
        inspect.Parameter.KEYWORD_ONLY
    f = fleet.Fleet(*args, device="cpu")
    assert not f.mono and f.out_ch == 2 and f.engine.interpolation == "cubic"
    flac = make_flac_bytes()
    f = fleet.Fleet([flac], True, None, True, 1, None, False, True, True, device="cpu")
    assert f.flac.device_restore and f.flac.device_dsp


def make_flac_bytes():
    from tests import fixtures

    sig = [int(v) for v in np.random.default_rng(5).integers(-500, 500, 256)]
    frame = fixtures.flac_frame([{"type": "verbatim", "values": sig}], 256, 0, 16)
    return fixtures.flac_stream_header(8000, 1, 16, 256 * 4) + frame * 4


def test_encode_engine_binds_jax_positional_order():
    specs = [batch_encode.EncodeSpec("dfpwm")]
    jspecs = [jax_encode.EncodeSpec("dfpwm")]
    assert bound(batch_encode.BatchEncodeEngine, specs, 4800, None, False) == \
        {**bound(jax_encode.BatchEncodeEngine, jspecs, 4800, None, False), "specs": specs}
    assert inspect.signature(batch_encode.BatchEncodeEngine).parameters["device"].kind is \
        inspect.Parameter.KEYWORD_ONLY
    enc = batch_encode.BatchEncodeEngine(specs, 4800, None, device="cpu")
    assert enc.chunk_samples == 4800 and enc.device.type == "cpu"
    assert batch_encode.BatchEncodeEngine(specs, 4800, None, False, device="cpu").lanes == 1


def test_dfpwm_encoder_binds_jax_positional_order():
    args = (2, 64, False)
    assert bound(batch_encode.BatchDfpwmEncoder, *args) == \
        bound(jax_encode.BatchDfpwmEncoder, *args)
    assert inspect.signature(batch_encode.BatchDfpwmEncoder).parameters["device"].kind is \
        inspect.Parameter.KEYWORD_ONLY
    enc = batch_encode.BatchDfpwmEncoder(*args, device="cpu")
    enc.feed_array(np.random.default_rng(3).integers(0, 256, (2, 128), dtype=np.uint8))
    assert enc.step()[0].shape == (2, 8) and enc.chunk_samples == 64
