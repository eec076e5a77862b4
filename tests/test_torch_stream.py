"""aukit_tpu_torch's single-stream iterators (``stream.*``), ``ChunkResampler``
and its device twin against the JAX package: twins of the 38 tests of
tests/test_stream.py that need neither playback nor a CLI. The same seeded
inputs go through ``aukit_tpu.stream`` and ``aukit_tpu_torch.stream`` on the
CPU (``device="cpu"``: the block decodes run the kernels' plain versions);
function sources are made twice, one for each package.

Tolerances:
 - every host chunk (the float64 host oracle, the native chunk DSP, every
   block codec's integer decode and its resample) is bit-equal to the JAX
   package's, and so is every position and length;
 - the device twin (``ChunkResampler.process`` on a torch tensor, its
   ``fma_kernel`` calls on the CPU through their plain version) is bit-equal
   to the JAX package's jitted ``_device_chunk_fn`` in all four modes, with
   and without the lowpass, with ``compat_quirks``, and within the
   reference's own 2e-3 (chunks) and 2e-2 (a value source) of the host
   oracle;
 - checkpoints restore across the two packages both ways.
"""

import contextlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aukit_tpu as ak
import aukit_tpu_torch as tk
from aukit_tpu import config as jconfig
from aukit_tpu.stream import engine as jengine
from aukit_tpu.stream import seek as jseek
from aukit_tpu_torch import config as tconfig
from aukit_tpu_torch.native import flacbits
from aukit_tpu_torch.stream import engine, seek
from tests import fixtures

RNG = np.random.default_rng(1123)
# the iterators that decode blocks take the port's keyword-only device
DEVICE_ITERATORS = ("dfpwm", "adpcm", "msadpcm", "mdfpwm", "wav", "flac", "qoa")


def collect(it):
    return [(c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c), p) for c, p in it]


def assert_same_chunks(got, want):
    assert len(got) == len(want)
    for (g, gp), (w, wp) in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        assert gp == wp


def twin(name: str, source, *args, **kw):
    """Both packages' ``stream.<name>`` over ``source()`` (called once for
    each, so function sources are not shared): -> (port chunks, JAX chunks),
    held bit-equal, positions and lengths equal."""
    extra = {"device": "cpu"} if name in DEVICE_ITERATORS else {}
    it_t, len_t = getattr(tk.stream, name)(source(), *args, **kw, **extra)
    it_j, len_j = getattr(ak.stream, name)(source(), *args, **kw)
    got, want = collect(it_t), collect(it_j)
    assert len_t == len_j
    assert_same_chunks(got, want)
    return got, want


def const(value):
    return lambda: value


def feeder(chunks):
    """A fresh function source over ``chunks`` each call."""
    def make():
        feed = list(chunks)
        return lambda: feed.pop(0) if feed else None
    return make


def dripper(data: bytes, size: int):
    def make():
        pos = 0

        def drip():
            nonlocal pos
            if pos >= len(data):
                return None
            out = data[pos: pos + size]
            pos += len(out)
            return out
        return drip
    return make


@contextlib.contextmanager
def config(**settings):
    """The same CONFIG settings in both packages for the block's duration."""
    saved = [(cfg, k, getattr(cfg, k)) for cfg in (jconfig.CONFIG, tconfig.CONFIG)
             for k in settings]
    for cfg, k, _ in saved:
        setattr(cfg, k, settings[k])
    try:
        yield
    finally:
        for cfg, k, v in saved:
            setattr(cfg, k, v)


def pcm16(n: int, amp: float = 1.0) -> bytes:
    vals = (RNG.random(n) * 2 - 1) * amp
    return np.clip(np.round(vals * 32767), -32768, 32767).astype("<i2").tobytes()


# -- stream.pcm ---------------------------------------------------------------------


@pytest.mark.parametrize("rate", [48000, 44100, 24000, 8000, 32000])
@pytest.mark.parametrize("mode", ["linear", "none", "cubic"])
def test_stream_pcm_parity(rate, mode):
    raw = pcm16(int(rate * 2.35))
    with config(default_interpolation=mode):
        got, _ = twin("pcm", const(raw), 16, "signed", 1, rate)
    assert len(got) == 3 and got[-1][0].shape[1] < 48000


def test_stream_pcm_sinc_parity():
    raw = pcm16(int(32000 * 1.6), 0.7)
    with config(default_interpolation="sinc"):
        twin("pcm", const(raw), 16, "signed", 1, 32000)


def test_stream_pcm_downsample_fixed():
    """96 kHz -> 48 kHz decimates by 2 (reference quirk Q18 fixed)."""
    raw = RNG.integers(-20000, 20000, 96000 * 2).astype("<i2").tobytes()
    got, _ = twin("pcm", const(raw), 16, "signed", 1, 96000)
    assert sum(c.shape[1] for c, _ in got) == 96000 + 1


def test_stream_pcm_stereo_and_mono_mix():
    raw = pcm16(32000 * 2, 0.9)
    for mono in (False, True):
        got, _ = twin("pcm", const(raw), 16, "signed", 2, 32000, False, mono)
        assert got[0][0].shape[0] == (1 if mono else 2)


def test_stream_pcm_quirk_q9_reseed():
    raw = pcm16(24000 * 2, 0.5)
    with config(compat_quirks=True):
        q9, _ = twin("pcm", const(raw), 16, "signed", 1, 24000)
    fixed, _ = twin("pcm", const(raw), 16, "signed", 1, 24000)
    assert not np.array_equal(q9[1][0], fixed[1][0])  # the re-seed shows after chunk 0


def test_stream_pcm_function_source():
    raw = np.clip(RNG.integers(-1000, 1000, 48000 * 2), -32768, 32767).astype("<i2").tobytes()
    chunks = [raw[i: i + 9973] for i in range(0, len(raw), 9973)]
    got, _ = twin("pcm", feeder(chunks), 16, "signed", 1, 48000)
    whole, _ = twin("pcm", const(raw), 16, "signed", 1, 48000)
    assert_same_chunks(got, whole)


# -- stream.dfpwm, g711, adpcm, msadpcm, mdfpwm ---------------------------------------


def test_stream_dfpwm_mono_rate48k():
    data = RNG.integers(0, 256, 6000 * 2 + 1234, dtype=np.uint8).tobytes()
    got, _ = twin("dfpwm", const(data), 48000, 1)
    assert got[0][1] == 0.0 and got[1][1] == 6000 * 8 / 48000


def test_stream_dfpwm_resampled():
    data = RNG.integers(0, 256, 6000, dtype=np.uint8).tobytes()
    (chunk, _), = twin("dfpwm", const(data), 24000, 1)[0]
    assert chunk.shape == (1, 96000)


def test_stream_dfpwm_without_native_takes_the_kernel_route(monkeypatch):
    """Without the native library the decoder runs kernel (a) on its device
    (its plain version here): the same chunks as the native route."""
    data = RNG.integers(0, 256, 6000 * 2 + 77, dtype=np.uint8).tobytes()
    want = collect(tk.stream.dfpwm(data, 24000, 2, device="cpu")[0])
    tk.kernels.reset_counts()
    monkeypatch.setattr(flacbits, "available", lambda: False)
    got = collect(tk.stream.dfpwm(data, 24000, 2, device="cpu")[0])
    assert tk.kernels.dfpwm_decode_ref.calls == 2
    assert_same_chunks(got, want)


def test_stream_g711():
    data = bytes(RNG.integers(0, 256, 8000 * 2 + 777, dtype=np.uint8))
    got, _ = twin("g711", const(data), True, 1, 8000)
    assert sum(c.shape[1] for c, _ in got) == 8000 * 6 * 2 + 777 * 6


def test_stream_adpcm_blocks():
    payload = fixtures.ima_wav_blocks(RNG, 5, 256, 2)
    got, _ = twin("adpcm", const(payload), 256, 2, 24000)
    assert sum(c.shape[1] for c, _ in got) == 5 * 248 * 2 and got[0][0].shape[0] == 2


def test_stream_msadpcm():
    sig = np.stack([(np.sin(np.arange(8192) / 21) * 10000).astype(np.int64)] * 2)
    payload = fixtures.ms_encode(sig, 256)
    got, _ = twin("msadpcm", const(payload), 256, 2, 24000)
    assert got
    mono, _ = twin("msadpcm", const(payload), 256, 2, 24000, mono=True)
    assert mono[0][0].shape[0] == 1


def test_stream_mdfpwm():
    left = bytes(RNG.integers(0, 256, 12000, dtype=np.uint8))
    right = bytes(RNG.integers(0, 256, 12000, dtype=np.uint8))
    f = fixtures.mdfpwm_file(left, right, 24000)
    got, _ = twin("mdfpwm", const(f))
    assert sum(c.shape[1] for c, _ in got) == 96000 and got[1][1] == 1.0
    twin("mdfpwm", const(f), mono=True)


# -- containers ---------------------------------------------------------------------


def test_stream_wav_dispatch_matches_direct():
    sig = RNG.integers(-3000, 3000, (2, 44100))
    got, _ = twin("wav", const(fixtures.wav_pcm(sig, 44100, 16)))
    payload = sig.T.reshape(-1).astype("<i2").tobytes()
    direct, _ = twin("pcm", const(payload), 16, "signed", 2, 44100, False, False)
    assert_same_chunks(got, direct)


def test_stream_aiff_dispatch():
    sig = RNG.integers(-3000, 3000, (2, 24000))
    payload = sig.T.reshape(-1).astype(">i2").tobytes()
    got, _ = twin("aiff", const(fixtures.aiff_file(payload, 2, 24000, 16)))
    direct, _ = twin("pcm", const(payload), 16, "signed", 2, 24000, True, False)
    assert_same_chunks(got, direct)


def test_stream_au_dispatch():
    payload = RNG.integers(-3000, 3000, 16000).astype(">i2").tobytes()
    got, _ = twin("au", const(fixtures.au_file(payload, 3, 16000, 1)))
    direct, _ = twin("pcm", const(payload), 16, "signed", 1, 16000, True, False)
    assert_same_chunks(got, direct)


def test_stream_wav_ima_and_dfpwm_dispatch():
    payload = fixtures.ima_wav_blocks(RNG, 3, 256, 2)
    got, _ = twin("wav", const(fixtures.wav_ima(payload, 24000, 2, 256)))
    direct, _ = twin("adpcm", const(payload), 256, 2, 24000)
    assert_same_chunks(got, direct)
    tone = ak.tone(300, 0.25, 0.4, sample_rate=48000)
    got2, _ = twin("wav", const(tone.wav(1)))
    direct2, _ = twin("dfpwm", const(tone.dfpwm(True)), 48000, 1)
    assert_same_chunks(got2, direct2)


def test_stream_wav_ignore_header_resync():
    sig = RNG.integers(-2000, 2000, (1, 48000)).astype(np.int64)
    w = fixtures.wav_pcm(sig, 48000, 16)
    got, _ = twin("wav", feeder([w, w]), ignore_header=True)
    assert sum(c.shape[1] for c, _ in got) == 2 * 48000


def test_stream_aiff_function_source_form_resync():
    payload = RNG.integers(-3000, 3000, (2, 48000)).T.reshape(-1).astype(">i2").tobytes()
    f = fixtures.aiff_file(payload, 2, 48000, 16)
    got, _ = twin("aiff", feeder([f, f]), ignore_header=True)
    direct, _ = twin("pcm", const(payload + payload), 16, "signed", 2, 48000, True, False)
    np.testing.assert_array_equal(np.concatenate([c for c, _ in got], axis=1),
                                  np.concatenate([c for c, _ in direct], axis=1))


def test_stream_au_function_source_snd_restrip():
    payload = RNG.integers(-3000, 3000, 48000).astype(">i2").tobytes()
    f = fixtures.au_file(payload, 3, 48000, 1)
    got, _ = twin("au", feeder([f, f]), ignore_header=True)
    direct, _ = twin("pcm", const(payload + payload), 16, "signed", 1, 48000, True, False)
    np.testing.assert_array_equal(np.concatenate([c for c, _ in got], axis=1),
                                  np.concatenate([c for c, _ in direct], axis=1))


def test_stream_au_function_source_plain():
    payload = RNG.integers(-3000, 3000, 48000 * 3).astype(">i2").tobytes()
    f = fixtures.au_file(payload, 3, 48000, 1)
    got, _ = twin("au", dripper(f, 70000))
    direct, _ = twin("pcm", const(payload), 16, "signed", 1, 48000, True, False)
    np.testing.assert_array_equal(np.concatenate([c for c, _ in got], axis=1),
                                  np.concatenate([c for c, _ in direct], axis=1))


# -- FLAC and QOA -------------------------------------------------------------------


def flac_verbatim(n: int, frames: int, lo: int, hi: int) -> bytes:
    vals = RNG.integers(lo, hi, n).tolist()
    frame = fixtures.flac_frame([{"type": "verbatim", "values": vals}], n, 0, 16)
    return fixtures.flac_stream_header(48000, 1, 16, frames * n) + frame * frames


def test_stream_flac():
    got, _ = twin("flac", const(flac_verbatim(4096, 1, -(1 << 14), 1 << 14)))
    assert sum(c.shape[1] for c, _ in got) == 4096


def test_stream_flac_lpc_stereo_track():
    """A mid/side LPC-8 track (tests/torch_tracks.py) in both packages: the
    restore runs kernel (g)'s plain version in the port."""
    from tests import torch_tracks

    raw, _ = torch_tracks.flac_file(torch_tracks.synth_track(1.5, 22050, 9), 22050, 3, 1024)
    tk.kernels.reset_counts()
    twin("flac", const(raw))
    assert tk.kernels.lpc_restore_ref.calls >= 1  # one a refill that commits frames
    twin("flac", const(raw), mono=True)


def test_stream_flac_restore_leaving_int32():
    """ROADMAP queue 3, fault 3.3 on the stream path: the LPC track with
    byte 68 set to 0 (its unstable predictor leaves int32) streams as in the
    JAX package. In the port the rows kernel (g)'s plain version reports
    wrapped are restored again in int64 rows by the same wrapper, so it runs
    twice for a batch with such rows."""
    from tests import torch_tracks

    raw, _ = torch_tracks.flac_file(torch_tracks.synth_track(0.5, 22050, 6), 22050, 3, 1024)
    tk.kernels.reset_counts()
    twin("flac", const(raw[:68] + b"\x00" + raw[69:]))
    assert tk.kernels.lpc_restore_ref.calls >= 2


def test_stream_qoa():
    data = fixtures.qoa_stream(RNG, 2, 48000, [5120, 3000]) + b"\x00" * 8
    got, _ = twin("qoa", const(data))
    assert sum(c.shape[1] for c, _ in got) == 8120
    twin("qoa", const(data), mono=True)


def test_stream_flac_incremental_drip_fed():
    data = flac_verbatim(4096, 24, -(1 << 14), 1 << 14)
    whole, _ = twin("flac", const(data))
    drip = dripper(data, 4096)
    src = drip()
    pulls = []
    it, _ = tk.stream.flac(lambda: pulls.append(1) or src(), device="cpu")
    first = next(iter(it))
    assert len(pulls) * 4096 < len(data), "stream.flac buffered the entire source"
    got = [(first[0], first[1])] + collect(it)
    assert_same_chunks(got, whole)
    twin("flac", drip)


def test_stream_qoa_incremental_drip_fed():
    data = fixtures.qoa_stream(RNG, 2, 48000, [5120] * 20) + b"\x00" * 8
    whole, _ = twin("qoa", const(data))
    src = dripper(data, 4096)()
    pulls = []
    it, _ = tk.stream.qoa(lambda: pulls.append(1) or src(), device="cpu")
    first = next(iter(it))
    assert len(pulls) * 4096 < len(data), "stream.qoa buffered the entire source"
    assert_same_chunks([first] + collect(it), whole)
    twin("qoa", dripper(data, 4096))


def test_stream_flac_incremental_garbage_mid_stream_ends():
    n = 1024
    vals = RNG.integers(-(1 << 10), 1 << 10, n).tolist()
    frame = fixtures.flac_frame([{"type": "verbatim", "values": vals}], n, 0, 16)
    data = fixtures.flac_stream_header(48000, 1, 16, 2 * n) + frame + b"\x00\x01" * 600 + frame
    got, _ = twin("flac", feeder([data[:2048], data[2048:]]))
    assert sum(c.shape[1] for c, _ in got) == n


def test_stream_adpcm_malformed_step_index_clamped():
    rng = np.random.default_rng(33)
    good = bytes([0, 0, 40, 0]) + rng.integers(0, 256, 252, dtype=np.uint8).tobytes()
    bad = bytes([0, 0, 0xFF, 0]) + rng.integers(0, 256, 252, dtype=np.uint8).tobytes()
    got, _ = twin("adpcm", const(good + bad + good), 256, 1, 8000)
    bad88 = bytes([0, 0, 88, 0]) + bad[4:]
    clamped, _ = twin("adpcm", const(good + bad88 + good), 256, 1, 8000)
    assert_same_chunks(got, clamped)


def test_stream_adpcm_malformed_step_index_compat_errors():
    rng = np.random.default_rng(33)
    bad = bytes([0, 0, 0xFF, 0]) + rng.integers(0, 256, 252, dtype=np.uint8).tobytes()
    with config(compat_quirks=True):
        for stream in (tk.stream.adpcm(bad, 256, 1, 8000, device="cpu")[0],
                       ak.stream.adpcm(bad, 256, 1, 8000)[0]):
            with pytest.raises(ValueError, match="malformed IMA step index"):
                list(stream)


# -- seek ---------------------------------------------------------------------------


def test_stream_seek_points_resume_exactly():
    ba, rate = 256, 8000
    payload = fixtures.ima_wav_blocks(RNG, 40, ba, 1)
    off, landing = seek.ima_seek(1.3, rate, ba, 1)
    assert (off, landing) == jseek.ima_seek(1.3, rate, ba, 1)
    full, _ = twin("adpcm", const(payload), ba, 1, rate)
    part, _ = twin("adpcm", const(payload[off:]), ba, 1, rate)
    full = np.concatenate([c for c, _ in full], axis=1)
    part = np.concatenate([c for c, _ in part], axis=1)
    skip = int(round(landing * 48000))
    n = min(part.shape[1], full.shape[1] - skip)
    assert n > 48000
    np.testing.assert_allclose(part[:, :n], full[:, skip: skip + n], atol=2.0)
    data = fixtures.qoa_stream(RNG, 1, 10240, [5120] * 4) + b"\x00" * 8
    assert seek.qoa_seek(data, 1.2) == jseek.qoa_seek(data, 1.2)


def flac_frames(n: int, count: int, rng) -> list:
    return [fixtures.flac_frame([{"type": "verbatim",
                                  "values": [int(v) for v in rng.integers(-2000, 2000, n)]}],
                                n, 0, 16, frame_number=k) for k in range(count)]


def test_flac_seek_frame_boundary_resume():
    n, rate = 4096, 48000
    frames = [fixtures.flac_frame(
        [{"type": "verbatim", "values": [int(v) for v in (np.arange(n) * (k + 3) % 1999 - 999)]}],
        n, 0, 16, frame_number=k) for k in range(24)]
    hdr = fixtures.flac_stream_header(rate, 1, 16, 24 * n)
    data = hdr + b"".join(frames)
    off, landing = seek.flac_seek(data, 1.3)
    assert (off, landing) == jseek.flac_seek(data, 1.3)
    assert off == len(hdr) + sum(len(f) for f in frames[: int(1.3 * rate) // n])
    full, _ = twin("flac", const(data))
    part, _ = twin("flac", const(hdr + data[off:]))
    full = np.concatenate([c for c, _ in full], axis=1)
    part = np.concatenate([c for c, _ in part], axis=1)
    skip = int(round(landing * rate))
    np.testing.assert_allclose(part[:, 16:], full[:, skip + 16: skip + part.shape[1]], atol=1e-9)
    assert seek.flac_seek(data, 0.0) == (len(hdr), 0.0)


def test_flac_seek_estimated_probe_on_long_stream():
    n, rate, count = 256, 48000, 2200
    frames = flac_frames(n, count, np.random.default_rng(8))
    data = fixtures.flac_stream_header(rate, 1, 16, count * n) + b"".join(frames)
    for target in (9.0, 0.5, 11.7, 10_000.0):
        assert seek.flac_seek(data, target) == jseek.flac_seek(data, target)
        assert seek.flac_seek.last_scanned == jseek.flac_seek.last_scanned
        assert seek.flac_seek.last_scanned < 300_000


def test_flac_seek_probe_bounded_on_frameless_suffix():
    n, rate, count = 256, 48000, 400
    frames = flac_frames(n, count, np.random.default_rng(9))
    garbage = b"\x01\x02" * (1 << 20)
    data = fixtures.flac_stream_header(rate, 1, 16, count * n) + b"".join(frames) + garbage
    off, landing = seek.flac_seek(data, 1.5)
    assert (off, landing) == jseek.flac_seek(data, 1.5)
    assert landing == (int(1.5 * rate) // n) * n / rate
    assert seek.flac_seek.last_scanned < len(garbage) + 600_000


# -- the native chunk DSP and PCM unpack --------------------------------------------


def test_stream_pcm_native_dsp_bit_identical(monkeypatch):
    """The native unpack and chunk DSP against the numpy oracle, and each
    against the JAX package, across dtypes, rates, channels and chunks."""
    from aukit_tpu.ops.pcmcode import pack_pcm

    assert flacbits.available()
    cases = [(8, "unsigned", 2, 32000, False), (16, "signed", 2, 44100, True),
             (24, "signed", 2, 96000, True), (32, "float", 2, 22050, False)]
    for depth, dtype, ch, rate, be in cases:
        n = rate // 2 + 371
        if dtype == "float":
            raw = (RNG.random(n * ch).astype("f4") * 2 - 1).astype(">f4" if be else "<f4")
            raw = raw.tobytes()
        else:
            v = RNG.integers(0, 1 << depth, n * ch, dtype=np.int64)
            raw = pack_pcm(v - (1 << (depth - 1)) if dtype == "signed" else v, depth, dtype, be)
        for mode in ("none", "linear"):
            with config(default_interpolation=mode):
                native, _ = twin("pcm", const(raw), depth, dtype, ch, rate, be, True)
                monkeypatch.setattr(flacbits, "available", lambda: False)
                plain = collect(tk.stream.pcm(raw, depth, dtype, ch, rate, be, True)[0])
                monkeypatch.undo()
            assert_same_chunks(plain, native)


def test_stream_pcm_native_dsp_q9_compat(monkeypatch):
    raw = RNG.integers(0, 256, 44100 * 2, dtype=np.uint8).tobytes()
    with config(compat_quirks=True):
        native, _ = twin("pcm", const(raw), 8, "signed", 1, 44100)
        monkeypatch.setattr(flacbits, "available", lambda: False)
        plain = collect(tk.stream.pcm(raw, 8, "signed", 1, 44100)[0])
    assert len(plain) >= 2
    assert_same_chunks(plain, native)


def test_iir_doubling_zero_pass_skip_bit_identical(monkeypatch):
    """The recursive-doubling lowpass (the FLAC and QOA streams'), native and
    numpy, bit-equal to the JAX package's at alphas whose decay underflows."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 2, 4096)) * 0.4
    state = rng.standard_normal((5, 2)) * 0.1
    for alpha in (0.9568, 0.407, 0.02):
        want = jengine.iir_lowpass_scan(x.copy(), alpha, state.copy())
        got = engine.iir_lowpass_scan(x.copy(), alpha, state.copy())
        monkeypatch.setattr(flacbits, "available", lambda: False)
        plain = engine.iir_lowpass_scan(x.copy(), alpha, state.copy())
        monkeypatch.undo()
        for a in (got, plain):
            np.testing.assert_array_equal(a[0], want[0])
            np.testing.assert_array_equal(a[1], want[1])


# -- ChunkResampler -----------------------------------------------------------------


def run_resampler(rs, sig, tensor: bool):
    """Drain ``rs`` over ``sig[C, N]`` a chunk at a time: jax arrays for the
    JAX package's device twin, torch CPU tensors for the port's, numpy for
    the host oracles. -> [(chunk numpy, position)]."""
    out, pos = [], 0
    while True:
        need = rs.samples_needed
        fresh = sig[:, pos: pos + need]
        pos += need
        if tensor:
            fresh = fresh.astype(np.float32)
            fresh = (torch.from_numpy(fresh) if isinstance(rs, engine.ChunkResampler)
                     else jnp.asarray(fresh))
        r = rs.process(fresh)
        if r is None:
            return out
        chunk, p = r
        out.append((chunk.numpy() if isinstance(chunk, torch.Tensor) else np.asarray(chunk), p))
        if fresh.shape[1] < need:
            return out


def test_chunk_resampler_checkpoint_roundtrip():
    """Checkpoints restore across the two packages both ways."""
    rate = 32000
    data = (RNG.random((1, int(rate * 2.2))) * 2 - 1) * 0.8
    for first, second in ((jengine.ChunkResampler, engine.ChunkResampler),
                          (engine.ChunkResampler, jengine.ChunkResampler)):
        a = first(rate, 1)
        c1 = a.process(data[:, : a.samples_needed])
        pos = a.samples_needed
        b = second(rate, 1)
        b.set_state(a.get_state())
        ca = a.process(data[:, pos: pos + a.samples_needed])
        cb = b.process(data[:, pos: pos + b.samples_needed])
        np.testing.assert_array_equal(ca[0], cb[0])
        assert ca[1] == cb[1] and c1[0].dtype == np.float32


@pytest.mark.parametrize("mode", ["none", "linear", "cubic", "sinc"])
def test_chunk_resampler_device_path_matches_host(mode):
    """The device twin on CPU tensors: bit-equal to the JAX package's jitted
    ``_device_chunk_fn`` across chunk boundaries and the EOF chunk, within
    the reference's 2e-3 of the float64 host oracle; the host oracles are
    bit-equal. Short chunks keep the sinc taps' plain FMAs cheap."""
    sig = np.sin(np.arange(44100 * 3) / 11.0)[None, :] * 0.7
    runs = {}
    for name, cls in (("port", engine.ChunkResampler), ("jax", jengine.ChunkResampler)):
        for tensor in (False, True):
            runs[name, tensor] = run_resampler(cls(44100, 1, mode=mode, chunk=9600), sig,
                                               tensor)
    assert_same_chunks(runs["port", True], runs["jax", True])
    assert_same_chunks(runs["port", False], runs["jax", False])
    d = np.concatenate([c for c, _ in runs["port", True]], axis=1)
    h = np.concatenate([c for c, _ in runs["port", False]], axis=1)
    np.testing.assert_allclose(d, h, atol=2e-3)


@pytest.mark.parametrize("mode", ["linear", "cubic", "sinc"])
@pytest.mark.parametrize("variant", ["no_lowpass", "compat_quirks", "clamped_floored"])
def test_device_twin_options_bit_equal_to_jitted(mode, variant):
    """The device twin's options against the jitted JAX twin: the lowpass
    off, quirk Q9's re-seed, and the DFPWM stream's interp clamp with floor,
    on stereo at 22.05 kHz."""
    sig = (RNG.random((2, int(22050 * 1.4))) * 2 - 1) * 0.95
    kw = {"no_lowpass": {"lowpass": False},
          "compat_quirks": {},
          "clamped_floored": {"floor_output": True, "interp_clamp": (-0.5, 0.5)}}[variant]
    with config(compat_quirks=variant == "compat_quirks"):
        got = run_resampler(engine.ChunkResampler(22050, 2, mode=mode, chunk=6000, **kw), sig,
                            True)
        want = run_resampler(jengine.ChunkResampler(22050, 2, mode=mode, chunk=6000, **kw), sig,
                             True)
    assert_same_chunks(got, want)


def test_chunk_resampler_device_state_roundtrip():
    """A device twin's state serialises to numpy and resumes identically, in
    either package."""
    sig = np.sin(np.arange(44100 * 2) / 9.0)[None, :] * 0.5
    dev = engine.ChunkResampler(44100, 1, mode="linear")
    need = dev.samples_needed
    dev.process(torch.from_numpy(sig[:, :need].astype(np.float32)))
    state = dev.get_state()
    assert isinstance(state["carry"], np.ndarray)
    rest = sig[:, need: need + dev.samples_needed].astype(np.float32)
    a = dev.process(torch.from_numpy(rest))
    for cls, arr in ((engine.ChunkResampler, torch.from_numpy), (jengine.ChunkResampler,
                                                                   jnp.asarray)):
        resumed = cls(44100, 1, mode="linear")
        resumed.set_state(state)
        b = resumed.process(arr(rest))
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))
        assert a[1] == b[1]


def test_stream_pcm_tensor_value_source_device_twin():
    """stream.pcm over a torch tensor of values (the JAX package's jax array)
    yields float32 tensors on its device, bit-equal to the JAX package's
    device twin, within the reference's 2e-2 of the host oracle; 3 channels
    with mono mix the rows in XLA's order."""
    sig = np.sin(np.arange(44100 * 2) / 9.0) * 0.6
    vals16 = np.round(sig * 20000).astype(np.int64)
    stereo = np.repeat(vals16, 3) + np.tile([0, 7, -5], len(vals16))
    for depth, dtype, vals, ch, mono in ((32, "float", sig.astype(np.float32), 1, False),
                                         (16, "signed", vals16, 1, False),
                                         (8, "unsigned", vals16 // 256 + 128, 1, False),
                                         (16, "signed", stereo, 3, True)):
        it_t, len_t = tk.stream.pcm(torch.from_numpy(vals), depth, dtype, ch, 44100, False, mono)
        it_j, len_j = ak.stream.pcm(jnp.asarray(vals), depth, dtype, ch, 44100, False, mono)
        it_h, len_h = tk.stream.pcm(vals.tolist(), depth, dtype, ch, 44100, False, mono)
        assert len_t == len_j == len_h
        while True:
            rt, rj, rh = it_t(), it_j(), it_h()
            assert (rt is None) == (rj is None) == (rh is None)
            if rt is None:
                break
            assert isinstance(rt[0], torch.Tensor) and rt[0].dtype == torch.float32
            np.testing.assert_array_equal(rt[0].numpy(), np.asarray(rj[0]))
            np.testing.assert_allclose(rt[0].numpy(), rh[0], atol=2e-2)
            assert rt[1] == rj[1] == rh[1]


def test_stream_iterators_need_a_card_by_default(monkeypatch):
    """Every iterator that decodes blocks defaults to the card and raises
    without one rather than running on the CPU. DFPWM decodes on the host's
    native route, as the JAX package does, and needs a card only for kernel
    (a), its route without the native library."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tk.stream.adpcm(b"\x00" * 256, 256)
    if flacbits.available():
        assert len(collect(tk.stream.dfpwm(b"\x00" * 10)[0])) == 1
    monkeypatch.setattr(flacbits, "available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collect(tk.stream.dfpwm(b"\x00" * 10)[0])
    assert math.isclose(tk.stream.pcm(b"\x00" * 4, 16)[1], 2 / 48000)
