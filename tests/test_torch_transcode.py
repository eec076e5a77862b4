"""Device-to-device transcodes: a decode engine or the FLAC fleet feeding
``encode_windows`` through ``transcode_fleet``, in aukit_tpu_torch (plain
PyTorch on the CPU) and in aukit_tpu (JAX on the CPU) on the same files.
Encoded bytes are compared bit for bit (tolerance 0).

The plain DFPWM encode loop costs one Python step per sample (~80 us), and a
decode window is one second at 48 kHz, so the DFPWM cases keep to one or two
windows."""

import dataclasses

import numpy as np
import torch

import aukit_tpu as ak
from aukit_tpu.stream import batch as jax_batch
from aukit_tpu.stream import batch_encode as jax_encode
from aukit_tpu.stream.fleet import Fleet
from aukit_tpu_torch.codecs.dfpwm import encode_dfpwm_bytes
from aukit_tpu_torch.containers.wav import pcm_wav_header
from aukit_tpu_torch.ops.pcmcode import normalize_pcm
from aukit_tpu_torch.stream import batch, batch_codecs, batch_encode
from aukit_tpu_torch.stream.flac_fleet import FlacFleet
from tests.test_flac_fleet import make_flac
from tests.test_torch_batch import feed_lanes, to_numpy


def decode_engine(module, specs, feeds, **kw):
    if module is batch:
        kw["device"] = "cpu"
    eng = module.BatchStreamEngine([module.LaneSpec(**dataclasses.asdict(s)) for s in specs], **kw)
    feed_lanes(eng, feeds)
    return eng


def encode_engine(module, specs):
    kw = {"device": "cpu"} if module is batch_encode else {}
    return module.BatchEncodeEngine([module.EncodeSpec(*s) for s in specs], **kw)


def test_transcode_wav_fleet_to_dfpwm_matches_jax():
    """Three WAV files (16-bit, 24 kHz, 1.2 s) -> windowed decode engine ->
    DFPWM encode engine through ``transcode_fleet``: two windows a lane, the
    second zero-padded to the one-second grid. The port's bytes also equal
    the solo chain over its own windows (int8 -> 8-bit loader -> encoder)."""
    wavs = [ak.tone(200 + 90 * i, 1.2, 0.6, "sine", sample_rate=24000).wav(16) for i in range(3)]
    parts = [batch_codecs.lane_spec_for_wav(w) for w in wavs]
    specs = [p[0] for p in parts]
    feeds = [w[off: off + size] for w, (_s, off, size) in zip(wavs, parts)]
    outs = []
    for dec_mod, enc_mod in ((batch, batch_encode), (jax_batch, jax_encode)):
        dec = decode_engine(dec_mod, specs, feeds, windowed=True)
        outs.append(enc_mod.transcode_fleet(dec, encode_engine(enc_mod, [("dfpwm",)] * 3)))
    assert outs[0] == outs[1]
    assert [len(o) for o in outs[0]] == [2 * 6000] * 3
    # the solo chain: the decode engine's own windows through the plain encoder
    dec = decode_engine(batch, specs[:1], feeds[:1], windowed=True)
    first = dec.step()[0]
    levels = batch_encode.float_to_target_ints(normalize_pcm(first[0].numpy(), 8, "signed"),
                                               "dfpwm")
    assert (levels != first[0].numpy()).any()  # the float32 normalise drops some levels by one
    solo, _ = encode_dfpwm_bytes(levels, device="cpu")
    assert outs[0][0][:6000] == solo


def test_transcode_flac_fleet_to_wav16_matches_jax():
    """Two FLAC sources -> the port's ``FlacFleet`` (host route; its float
    windows quantise with the truncating int8 cast of the JAX ``Fleet``
    facade) -> pcm16 encode engine, against the JAX ``Fleet`` -> encode
    engine. Wrapped with ``pcm_wav_header``, each body is the WAV file the
    JAX solo writer makes of the same windows."""
    flacs = [make_flac(48000, 50, seed=40 + i) for i in range(2)]
    want = jax_encode.transcode_fleet(Fleet(flacs), encode_engine(jax_encode, [("pcm16",)] * 2))
    fleet = FlacFleet(2, device="cpu")
    fleet.feed_many(flacs)
    fleet.feed_many([None, None])
    got = batch_encode.transcode_fleet(fleet, encode_engine(batch_encode, [("pcm16",)] * 2))
    assert got == want and all(len(b) % 96000 == 0 and len(b) > 0 for b in got)
    for body in got:
        samples = np.frombuffer(body, "<i2")
        assert samples.any()
    ref = Fleet(flacs)
    windows = [[] for _ in flacs]
    while not ref.done:
        r = ref.step()
        if r is not None:
            for i in np.nonzero(r[1])[0]:
                windows[i].append(np.asarray(r[0])[i])
    for i, body in enumerate(got):
        audio = ak.pcm(np.concatenate(windows[i]).astype(np.int8).tobytes(), 8, "signed", 1, 48000)
        assert pcm_wav_header(1, 48000, 16, len(body)) + body == audio.wav(16)


def test_transcode_stereo_windows_match_jax():
    """``mono=False`` decode engines feed ``[L, 2, T]`` windows to stereo
    encoders: interleaved stereo DFPWM (one encoder state per lane) and
    stereo pcm16 from the same windows; a mono DFPWM source lane rides along,
    its channel 0 replicated. One window a lane."""
    rng = np.random.default_rng(3)
    rate = 8000
    specs = [batch.LaneSpec("pcm16", rate, 2), batch.LaneSpec("ulaw", rate, 2),
             batch.LaneSpec("dfpwm", 48000)]
    feeds = [(np.sin(np.arange(2 * rate) / 5.0) * 9000).astype("<i2").tobytes(),
             rng.integers(0, 256, 2 * rate, dtype=np.uint8).tobytes(),
             rng.integers(0, 256, 6000, dtype=np.uint8).tobytes()]
    runs = []
    for dec_mod, enc_mod in ((batch, batch_encode), (jax_batch, jax_encode)):
        dec = decode_engine(dec_mod, specs, feeds, mono=False)
        dfpwm_enc = encode_engine(enc_mod, [("dfpwm", 2)] * 3)
        pcm_enc = encode_engine(enc_mod, [("pcm16", 2, 44100)] * 3)
        res = []
        while not dec.done:
            windows, mask, pos = dec.step()
            assert tuple(windows.shape) == (3, 2, 48000)
            for enc in (dfpwm_enc, pcm_enc):
                out, nbytes, m, p = enc.encode_windows(windows, mask)
                res.append((to_numpy(out), nbytes, m, p))
        runs.append(res)
    assert len(runs[0]) == len(runs[1]) == 2
    for (bg, ng, mg, pg), (bw, nw, mw, pw) in zip(*runs):
        np.testing.assert_array_equal(bg, bw)
        np.testing.assert_array_equal(ng, nw)
        np.testing.assert_array_equal(mg, mw)
        np.testing.assert_array_equal(pg, pw)
    assert runs[0][0][1].tolist() == [12000] * 3 and runs[0][1][1].tolist() == [192000] * 3
    # the replicated mono lane: both channels of every pcm16 frame are equal
    frames = np.frombuffer(runs[0][1][0][2].tobytes(), "<i2").reshape(-1, 2)
    assert frames.any() and np.array_equal(frames[:, 0], frames[:, 1])


def test_transcode_fleet_polls_a_starved_source_like_jax():
    """A source that is starved but not done is polled ``max_steps`` times
    and yields nothing (the reference's behaviour); once fed to its end the
    same engines finish the transcode."""
    rate = 8000
    spec = batch.LaneSpec("pcm8", rate)
    data = np.arange(rate + 500, dtype=np.uint8).tobytes()
    outs = []
    for dec_mod, enc_mod in ((batch, batch_encode), (jax_batch, jax_encode)):
        kw = {"device": "cpu"} if dec_mod is batch else {}
        dec = dec_mod.BatchStreamEngine([dec_mod.LaneSpec(**dataclasses.asdict(spec))] * 2,
                                        windowed=True, **kw)
        enc = encode_engine(enc_mod, [("pcm8",), ("pcm24",)])
        dec.feed(0, data[:300])
        dec.feed(1, data[:300])
        starved = enc_mod.transcode_fleet(dec, enc, max_steps=3)
        assert starved == [b"", b""] and not dec.done
        dec.feed(0, data[300:])
        dec.feed(1, data[300: rate])
        dec.feed(0, None)
        dec.feed(1, None)
        outs.append(enc_mod.transcode_fleet(dec, enc))
    assert outs[0] == outs[1]
    assert [len(b) for b in outs[0]] == [2 * 48000, 48000 * 3]


def test_transcode_quantises_float_windows_like_the_fleet_facade():
    """``transcode_fleet`` takes a source whose windows are float int8-range
    samples (the FLAC fleet's): clip to [-128, 127], truncate toward zero."""
    class Source:
        def __init__(self):
            self.windows = [np.array([[-200.0, -128.9, -0.9, 0.9, 126.99, 127.5, 300.0, 5.0]],
                                     np.float32)]

        @property
        def done(self):
            return not self.windows

        def step(self):
            return self.windows.pop(), np.array([True]), np.zeros(1)

    enc = encode_engine(batch_encode, [("pcm8",)])
    (got,) = batch_encode.transcode_fleet(Source(), enc)
    want = torch.tensor([-128, -128, 0, 0, 126, 127, 127, 5], dtype=torch.int8)
    assert got == enc.groups[0]._lut[want.to(torch.int32) + 128].to(torch.uint8).numpy().tobytes()
