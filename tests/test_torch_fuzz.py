"""Fuzz twins of tests/test_fuzz.py: malformed inputs, truncations and feed
schedules through both packages on the same seeded bytes. Each port result
equals the JAX package's result, or raises the exception type the JAX package
raises on that input (its shared crashes, ROADMAP queue 3, are matched, not
fixed). Engine outputs are bit-equal to the JAX engines' and invariant under
the feed schedule; the device-routed FLAC fleet stays within the reference's
5e-3 of the host fleet. Sizes are cut from the JAX tests' (the DFPWM plain
loop costs ~80 us a bit step on the CPU); each cut is stated where it is made.
``test_auconvert_map_language_fuzz`` waits for the CLIs.
"""

import numpy as np
import pytest

import aukit_tpu as ak
import aukit_tpu_torch as tk
from aukit_tpu.codecs import flac as jflac
from aukit_tpu.stream import batch as jax_batch
from aukit_tpu.stream import batch_encode as jax_encode
from aukit_tpu_torch.codecs import flac as tflac
from aukit_tpu_torch.stream import batch, batch_encode
from tests import fixtures

RNG = np.random.default_rng(2024)
PARSERS = ("wav", "aiff", "au", "flac", "qoa", "mdfpwm")


def outcome(fn):
    """("ok", samples, shape, rate, metadata, info) of a loader, or ("raised",
    the exception type's name: each package has its own ``FlacError``)."""
    try:
        a = fn()
    except Exception as e:  # noqa: BLE001 - the type is the result compared
        return ("raised", type(e).__name__)
    data = a.numpy() if isinstance(a, tk.Audio) else np.asarray(a.data)
    return ("ok", data.tobytes(), data.shape, a.sample_rate, a.metadata, a.info)


def assert_same_outcome(kind: str, data: bytes):
    got = outcome(lambda: getattr(tk, kind)(data, device="cpu"))
    want = outcome(lambda: getattr(ak, kind)(data))
    assert got == want, (kind, got[:2], want[:2])
    return got


@pytest.mark.parametrize("seed", range(8))
def test_random_garbage(seed):
    rng = np.random.default_rng(seed)
    data = bytes(rng.integers(0, 256, int(rng.integers(0, 4000)), dtype=np.uint8))
    for kind in PARSERS:
        assert_same_outcome(kind, data)
    assert tk.detect(data) == ak.detect(data)


def test_truncations_of_valid_files():
    sig = RNG.integers(-3000, 3000, (2, 400))
    files = {
        "wav": fixtures.wav_pcm(sig, 44100, 16),
        "aiff": fixtures.aiff_file(sig.T.reshape(-1).astype(">i2").tobytes(), 2, 44100, 16),
        "au": fixtures.au_file(sig.reshape(-1).astype(">i2").tobytes(), 3, 8000, 2),
        "qoa": fixtures.qoa_stream(RNG, 1, 48000, [1000]),
        "flac": fixtures.flac_stream_header(48000, 1, 16, 400) + fixtures.flac_frame(
            [{"type": "verbatim", "values": sig[0].tolist()}], 400, 0, 16),
    }
    for kind, data in files.items():
        for cut in (1, 4, 11, len(data) // 3, len(data) - 3, len(data)):
            assert_same_outcome(kind, data[:cut])


def test_flac_malformed_headers():
    good = fixtures.flac_stream_header(48000, 1, 16, 100)
    b = bytearray(fixtures.flac_stream_header(48000, 1, 16, 0))
    b[8 + 10: 8 + 18] = ((48000 << 44) | ((12 - 1) << 36)).to_bytes(8, "big")  # 12-bit depth
    for data in (b"NOPE" + good[4:], bytes(b)):
        assert assert_same_outcome("flac", data) == ("raised", "FlacError")
        with pytest.raises(tflac.FlacError):
            tk.flac(data, device="cpu")
        with pytest.raises(jflac.FlacError):
            ak.flac(data)


@pytest.mark.parametrize("use_native", [False, True])
def test_flac_order_exceeds_block_size(use_native):
    """block_size 1 with LPC order 32 and fixed order 4: both packages emit
    the one sample, through the Python and the native parser."""
    warmup = RNG.integers(-1000, 1000, 32).tolist()
    lpc = fixtures.flac_frame(
        [{"type": "lpc", "order": 32, "warmup": warmup, "precision": 7, "shift": 5,
          "coefs": [1] * 32, "residuals": [], "param": 4, "partition_order": 0}], 1, 0, 16)
    fixed = fixtures.flac_frame(
        [{"type": "fixed", "order": 4, "warmup": warmup[:4], "residuals": [], "param": 4,
          "partition_order": 0}], 1, 0, 16)
    for frame in (lpc, fixed):
        data = fixtures.flac_stream_header(48000, 1, 16, 1) + frame
        got = tflac.decode_flac(data, False, use_native, device="cpu")[0]
        want = jflac.decode_flac(data, use_native=use_native)[0]
        assert got.shape == (1, 1) and got[0, 0] == np.float32(warmup[0] / (1 << 16))
        np.testing.assert_array_equal(got, want)


def test_stream_iterators_tolerate_garbage_tails():
    """A valid header, frames, then garbage: every iterator ends the stream
    as the JAX package's does, with the same chunks."""
    n = 192
    vals = RNG.integers(-100, 100, n).tolist()
    frame = fixtures.flac_frame([{"type": "verbatim", "values": vals}], n, 0, 16)
    tail = b"\xde\xad\xbe\xef" * 10
    cases = [("flac", fixtures.flac_stream_header(48000, 1, 16, n) + frame + tail, ()),
             ("qoa", fixtures.qoa_stream(RNG, 2, 48000, [700]) + tail, ()),
             ("wav", fixtures.wav_ima(fixtures.ima_wav_blocks(RNG, 3, 256, 2), 24000, 2, 256)
              + tail, ())]
    for name, data, args in cases:
        got = [c for c, _ in getattr(tk.stream, name)(data, *args, device="cpu")[0]]
        want = [np.asarray(c) for c, _ in getattr(ak.stream, name)(data, *args)[0]]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert sum(c.shape[1] for c, _ in tk.stream.flac(cases[0][1], device="cpu")[0]) == n


def drain(eng, lanes: int):
    """Every lane's concatenated output of an engine stepped to its end."""
    outs = [[] for _ in range(lanes)]
    while (r := eng.step()) is not None:
        chunk, mask = np.asarray(r[0]), np.asarray(r[1])
        for i in range(lanes):
            if mask[i]:
                outs[i].append(chunk[i])
    return [np.concatenate(o) if o else np.zeros(0, np.int8) for o in outs]


def test_batch_lane_poisoning_isolated():
    """Garbage in one lane never changes another lane's output (1200 good
    bytes, as the JAX test; the ragged garbage lane 37 bytes)."""
    good = bytes(RNG.integers(0, 256, 1200, dtype=np.uint8))
    outs = []
    for eng in (batch.BatchDfpwmDecoder(2, 48000, chunk_bytes=600, device="cpu"),
                jax_batch.BatchDfpwmDecoder(2, 48000, chunk_bytes=600)):
        eng.feed(0, good)
        eng.feed(0, None)
        eng.feed(1, b"\xff" * 37)
        eng.feed(1, None)
        outs.append(drain(eng, 2))
    alone = batch.BatchDfpwmDecoder(1, 48000, chunk_bytes=600, device="cpu")
    alone.feed(0, good)
    alone.feed(0, None)
    np.testing.assert_array_equal(outs[0][0], drain(alone, 1)[0])
    for g, w in zip(*outs):
        np.testing.assert_array_equal(g, w)


def scheduled(eng, streams, rng, max_piece):
    """Feed ``streams`` in random pieces (some steps starved) while stepping
    ``eng``; ``rng`` None feeds each stream whole first. -> every lane's output."""
    cursors = [0] * len(streams)
    outs = [[] for _ in streams]
    if rng is None:
        for i, s in enumerate(streams):
            eng.feed(i, s)
            eng.feed(i, None)
    idle = 0
    while idle < 50:
        if rng is not None:
            for i, s in enumerate(streams):
                if cursors[i] < len(s) and rng.random() < 0.7:
                    n = int(rng.integers(1, max_piece(s)))
                    eng.feed(i, s[cursors[i]: cursors[i] + n])
                    cursors[i] += n
                    if cursors[i] >= len(s):
                        eng.feed(i, None)
        r = eng.step()
        if r is None:
            if rng is None or all(c >= len(s) for c, s in zip(cursors, streams)):
                break
            idle += 1
            continue
        chunk, mask = np.asarray(r[0]), np.asarray(r[1])
        for i in range(len(streams)):
            if mask[i]:
                outs[i].append(chunk[i])
    return [np.concatenate(o) if o else np.zeros(0, np.int8) for o in outs]


def test_batch_engine_feed_schedule_invariance():
    """A DFPWM, a PCM16 and an IMA lane under random feed schedules: every
    lane's output is the one-shot feed's, and the JAX engine's. Cut from the
    JAX test's 2 s a lane to 0.25 s."""
    streams = [bytes(RNG.integers(0, 256, 1500, dtype=np.uint8)),
               RNG.integers(-20000, 20000, 6000).astype("<i2").tobytes(),
               bytes(RNG.integers(0, 256, 256 * 8, dtype=np.uint8))]

    def engine(module, **kw):
        specs = [module.LaneSpec("dfpwm", 48000), module.LaneSpec("pcm16", 24000),
                 module.LaneSpec("ima", 8000, 1, block_align=256)]
        return module.BatchStreamEngine(specs, **kw)

    ref = scheduled(engine(batch, device="cpu"), streams, None, None)
    want = scheduled(engine(jax_batch), streams, None, None)
    for seed in (1, 2):
        got = scheduled(engine(batch, device="cpu"), streams, np.random.default_rng(seed),
                        lambda s: len(s) // 2 + 2)
        for i in range(3):
            np.testing.assert_array_equal(got[i], ref[i], err_msg=f"lane {i} seed {seed}")
    for g, w in zip(ref, want):
        np.testing.assert_array_equal(g, w)


def test_batch_engine_homogeneous_schedule_invariance():
    """One DFPWM lane of the homogeneous engine (kernel (b)'s plain version)
    under random schedules. Cut from 19,234 bytes to 1,834 (600-byte chunks)."""
    stream = bytes(RNG.integers(0, 256, 600 * 3 + 34, dtype=np.uint8))

    def engine(module, **kw):
        return module.BatchDfpwmDecoder(1, 48000, chunk_bytes=600, **kw)

    ref = scheduled(engine(batch, device="cpu"), [stream], None, None)
    np.testing.assert_array_equal(ref[0], scheduled(engine(jax_batch), [stream], None, None)[0])
    for seed in (4, 5):
        got = scheduled(engine(batch, device="cpu"), [stream], np.random.default_rng(seed),
                        lambda s: 900)
        np.testing.assert_array_equal(got[0], ref[0], err_msg=f"seed {seed}")


def test_incremental_stream_drip_size_invariance():
    """stream.flac / stream.qoa: the same chunks for any source chunking, in
    both packages."""
    n = 2048
    vals = RNG.integers(-(1 << 13), 1 << 13, n).tolist()
    frame = fixtures.flac_frame([{"type": "verbatim", "values": vals}], n, 0, 16)
    cases = (("flac", fixtures.flac_stream_header(48000, 1, 16, 8 * n) + frame * 8),
             ("qoa", fixtures.qoa_stream(RNG, 1, 10240, [5120] * 4) + b"\x00" * 8))

    def collect_all(module, name, src, **kw):
        it, _ = getattr(module.stream, name)(src, **kw)
        return np.concatenate([np.asarray(c) for c, _ in it], axis=1)

    for name, data in cases:
        ref = collect_all(tk, name, data, device="cpu")
        np.testing.assert_array_equal(ref, collect_all(ak, name, data))
        for seed in (7, 8):
            rng = np.random.default_rng(seed)
            pos = 0

            def drip():
                nonlocal pos
                if pos >= len(data):
                    return None
                out = data[pos: pos + int(rng.integers(1, 5000))]
                pos += len(out)
                return out

            np.testing.assert_array_equal(collect_all(tk, name, drip, device="cpu"), ref,
                                          err_msg=f"{name} seed {seed}")


def test_batch_checkpoint_restore_at_random_points():
    """Checkpoint after k chunks, restore into a fresh engine of either
    package: the continuation is bit-identical (7 chunks of 200 bytes; the
    JAX test's are 600)."""
    stream = bytes(RNG.integers(0, 256, 200 * 7, dtype=np.uint8))

    def fed(module, **kw):
        eng = module.BatchDfpwmDecoder(1, 48000, chunk_bytes=200, **kw)
        eng.feed(0, stream)
        eng.feed(0, None)
        return eng

    ref = [np.asarray(r[0][0]) for r in iter(fed(batch, device="cpu").step, None)]
    for k in (1, 3, 6):
        for src_mod, dst_mod, skw, dkw in ((batch, batch, {"device": "cpu"}, {"device": "cpu"}),
                                           (batch, jax_batch, {"device": "cpu"}, {}),
                                           (jax_batch, batch, {}, {"device": "cpu"})):
            eng = fed(src_mod, **skw)
            for _ in range(k):
                eng.step()
            ckpt = eng.checkpoint(0)
            eng2 = dst_mod.BatchDfpwmDecoder(1, 48000, chunk_bytes=200, **dkw)
            eng2.restore(0, {**ckpt, "pending": stream[ckpt["byte_offset"]:], "eof": True})
            got = [np.asarray(r[0][0]) for r in iter(eng2.step, None)]
            np.testing.assert_array_equal(np.concatenate(got), np.concatenate(ref[k:]),
                                          err_msg=f"k={k}")


def test_batch_encoder_schedule_invariance():
    """The encoder engine under random schedules, and against the JAX
    encoder, at the JAX test's sizes."""
    stream = (RNG.integers(-90, 90, 4800 * 3 + 800) & 0xFF).astype(np.uint8).tobytes()

    def encoder(module, **kw):
        return module.BatchDfpwmEncoder(1, chunk_samples=4800, **kw)

    ref = scheduled(encoder(batch_encode, device="cpu"), [stream], None, None)
    np.testing.assert_array_equal(
        ref[0], scheduled(encoder(jax_encode), [stream], None, None)[0])
    for seed in (9, 10):
        got = scheduled(encoder(batch_encode, device="cpu"), [stream],
                        np.random.default_rng(seed), lambda s: 7000)
        np.testing.assert_array_equal(got[0], ref[0], err_msg=f"seed {seed}")


def test_fuzz_fleet_device_resident_drip_invariance():
    """The FLAC fleet's device routes (kernels (g), (h) and the FMA, their
    plain versions here) under random drip cadences stay within 5e-3 of the
    host fleet, which equals the JAX host fleet bit for bit. One seed of the
    JAX test's three, and 4 frames a lane of its 8 (3 of 6 at 44.1 kHz)."""
    from tests.test_flac_fleet import make_flac
    from aukit_tpu.stream.flac_fleet import FlacFleet as JaxFlacFleet
    from aukit_tpu_torch.stream.flac_fleet import FlacFleet

    datas = [make_flac(48000, 4, seed=120, final_short=300),
             make_flac(48000, 4, seed=121, channels=2, chan_asgn=10),
             make_flac(44100, 3, seed=122)]

    def run(fleet, rng):
        outs = [[] for _ in datas]
        offs = [0] * len(datas)
        eof = [False] * len(datas)
        guard = 0
        while not fleet.done:
            for i, d in enumerate(datas):
                if offs[i] < len(d):
                    step = int(rng.integers(700, 9000))
                    fleet.feed(i, d[offs[i]: offs[i] + step])
                    offs[i] += step
                elif not eof[i]:
                    fleet.feed(i, None)
                    eof[i] = True
            r = fleet.step()
            if r is not None:
                window, mask, _ = r
                for i in range(len(datas)):
                    if mask[i]:
                        outs[i].append(np.asarray(window[i]))
            guard += 1
            assert guard < 500
        return [np.concatenate(o) if o else np.zeros(0, np.float32) for o in outs]

    host = run(FlacFleet(len(datas), device="cpu"), np.random.default_rng(1000))
    jax_host = run(JaxFlacFleet(len(datas)), np.random.default_rng(1000))
    dev = run(FlacFleet(len(datas), device_restore=True, device_dsp=True, device="cpu"),
              np.random.default_rng(1000))
    for a, j, d in zip(host, jax_host, dev):
        np.testing.assert_array_equal(a, j)
        assert a.shape == d.shape
        np.testing.assert_allclose(d, a, atol=5e-3)
