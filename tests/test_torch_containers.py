"""aukit_tpu_torch's container loaders and writer against the JAX package
(twins of tests/test_containers.py): WAV (PCM 8/16/24/32 and float, G.711,
IMA with the mono index mask and the stereo index check, MS ADPCM,
DFPWM-in-WAV read and write, LIST/INFO metadata), AIFF/AIFC, AU, FLAC,
MDFPWM and detect. The same fixture bytes go to the JAX loader and to the
port's on the CPU (``device="cpu"``, where the kernel wrappers run their
plain versions), and both to the loop oracles of tests/ref/codecs.py.

Tolerance 0: samples, rates, metadata, info and bytes written are equal.
"""

import struct

import numpy as np
import pytest
import torch

import aukit_tpu as ak
import aukit_tpu_torch as tk
from aukit_tpu.codecs import dfpwm as jdfpwm
from aukit_tpu_torch.ops import pcmcode
from tests import fixtures
from tests.ref import codecs as refc

RNG = np.random.default_rng(11)


def data(audio) -> np.ndarray:
    return audio.numpy() if isinstance(audio, tk.Audio) else np.asarray(audio.data)


def load(kind: str, raw: bytes, *args):
    """(port Audio on the CPU, JAX Audio) of one file, both loaders' results
    held equal (samples, rate, metadata, info)."""
    got = getattr(tk, kind)(raw, *args, device="cpu")
    want = getattr(ak, kind)(raw, *args)
    np.testing.assert_array_equal(data(got), data(want))
    assert got.sample_rate == want.sample_rate
    assert got.metadata == want.metadata and got.info == want.info
    assert got.device == torch.device("cpu")
    return got


@pytest.mark.parametrize("bits", [8, 16, 24, 32])
def test_wav_pcm16_roundtrip(bits):
    """PCM WAV at every depth (the JAX test reads 16 bits; the others go
    through the same path), and the port's writer at that depth."""
    lo, hi = (0, 256) if bits == 8 else (-(1 << (bits - 1)), 1 << (bits - 1))
    sig = RNG.integers(lo, hi, (2, 500))
    a = load("wav", fixtures.wav_pcm(sig, 44100, bits))
    assert a.sample_rate == 44100 and a.channels == 2
    dtype = "unsigned" if bits == 8 else "signed"
    ref = refc.pcm_ref(sig.T.reshape(-1).tolist(), bits, dtype, 2, True)
    np.testing.assert_array_equal(data(a), ref.astype(np.float32))
    assert a.info == {"dataType": dtype, "bitDepth": bits}
    assert a.wav(bits) == ak.wav(fixtures.wav_pcm(sig, 44100, bits)).wav(bits)


def test_wav_8bit_unsigned():
    sig = RNG.integers(0, 256, (1, 300))
    a = load("wav", fixtures.wav_pcm(sig, 8000, 8))
    ref = refc.pcm_ref(sig.reshape(-1).tolist(), 8, "unsigned", 1, True)
    np.testing.assert_array_equal(data(a), ref.astype(np.float32))


def test_wav_float32():
    sig = (RNG.random((2, 200), dtype=np.float64) * 2 - 1).astype(np.float32)
    a = load("wav", fixtures.wav_pcm(sig, 48000, 32))
    np.testing.assert_array_equal(data(a), sig)
    assert a.info["dataType"] == "float"


def test_wav_g711():
    raw = bytes(RNG.integers(0, 256, 800, dtype=np.uint8))
    for ulaw in (False, True):
        a = load("wav", fixtures.wav_g711(raw, 8000, 2, ulaw))
        np.testing.assert_array_equal(data(a), refc.g711_ref(raw, ulaw, 2).astype(np.float32))


def test_wav_ima_stereo():
    payload = fixtures.ima_wav_blocks(RNG, 3, 128, 2)
    a = load("wav", fixtures.wav_ima(payload, 22050, 2, 128))
    # reference regroup: per block, headers then per-group L bytes 0-3, R 4-7
    exp = [[], []]
    for b in range(3):
        block = payload[b * 128: (b + 1) * 128]
        predl, idxl = struct.unpack_from("<hB", block, 0)
        predr, idxr = struct.unpack_from("<hB", block, 4)
        nl, nr = [], []
        for g in range(8, 128, 8):
            for byte in block[g: g + 4]:
                nl += [byte & 0x0F, byte >> 4]
            for byte in block[g + 4: g + 8]:
                nr += [byte & 0x0F, byte >> 4]
        exp[0] += refc.ima_ref(nl, predl, idxl)
        exp[1] += refc.ima_ref(nr, predr, idxr)
    np.testing.assert_array_equal(data(a), refc.norm16(np.array(exp)).astype(np.float32))


def test_wav_ima_stereo_step_index_validated():
    """An out-of-range stereo step index (>88) raises, like the reference's
    expect.range, in both packages."""
    payload = bytearray(fixtures.ima_wav_blocks(RNG, 1, 128, 2))
    payload[2] = 200  # left-channel step index
    w = fixtures.wav_ima(bytes(payload), 22050, 2, 128)
    with pytest.raises(ValueError):
        tk.wav(w, device="cpu")
    with pytest.raises(ValueError):
        ak.wav(w)


def test_wav_ima_mono_q13_index_mask():
    payload = fixtures.ima_wav_blocks(RNG, 2, 64, 1)
    a = load("wav", fixtures.wav_ima(payload, 8000, 1, 64))
    exp = []
    for b in range(2):
        block = payload[b * 64: (b + 1) * 64]
        pred, idx = struct.unpack_from("<hB", block, 0)
        idx &= 0x0F  # the reference's mask (aukit.lua:1544)
        nibs = refc.nibbles_from_bytes(block[4:], top_first=False)
        exp += refc.ima_ref(nibs, pred, idx)
    np.testing.assert_array_equal(data(a)[0], refc.norm16(np.array(exp)).astype(np.float32))


def test_wav_msadpcm_container():
    sig = np.stack([(np.sin(np.arange(2048) / 20) * 9000).astype(np.int64)] * 2)
    payload = fixtures.ms_encode(sig, 256)
    a = load("wav", fixtures.wav_msadpcm(payload, 22050, 2, 256))
    ref = refc.msadpcm_ref(payload, 256, 2)
    np.testing.assert_array_equal(data(a), refc.norm16(ref).astype(np.float32))


def test_wav_metadata_roundtrip():
    a = tk.tone(440, 0.01, 0.5, device="cpu")
    a.metadata = {"title": "Test Song", "artist": "Tester", "trackNumber": 3}
    w = a.wav(16)
    j = ak.tone(440, 0.01, 0.5)
    j.metadata = dict(a.metadata)
    assert w == j.wav(16) and a.wav(1) == j.wav(1)
    b = load("wav", w)
    assert b.metadata["title"] == "Test Song"
    assert b.metadata["artist"] == "Tester"
    assert b.metadata["trackNumber"] == 3


def test_wav_dfpwm_container_roundtrip():
    a = tk.tone(300, 0.05, 0.4, sample_rate=48000, device="cpu")
    w = a.wav(1)  # DFPWM-in-WAV
    assert w == ak.tone(300, 0.05, 0.4, sample_rate=48000).wav(1)
    b = load("wav", w)
    assert b.info["dataType"] == "dfpwm"
    assert b.sample_rate == 48000
    enc = a.dfpwm(True)
    ref, _ = jdfpwm.decode_dfpwm_bytes(enc)
    np.testing.assert_array_equal(data(b)[0], pcmcode.normalize_pcm(ref, 8, "signed"))


def test_aiff_be_pcm():
    sig = RNG.integers(-32768, 32767, (2, 300))
    payload = sig.T.reshape(-1).astype(">i2").tobytes()
    a = load("aiff", fixtures.aiff_file(payload, 2, 44100, 16))
    assert a.sample_rate == 44100
    ref = refc.pcm_ref(payload, 16, "signed", 2, True, big_endian=True)
    np.testing.assert_array_equal(data(a), ref.astype(np.float32))
    h = load("aiff", fixtures.aiff_file(payload, 2, 44100, 16), True)
    assert h.num_samples == 0


def test_aiff_fractional_rate_kept():
    """An AIFF's 80-bit rate is kept as the float it is (ROADMAP queue 3,
    fault 3.1: the loaders truncated it); ``load`` holds the rate equal."""
    assert load("aiff", fixtures.aiff_file(b"\x00\x00", 1, 8000.5, 16)).sample_rate == 8000.5
    sig = RNG.integers(-32768, 32767, 400)
    a = load("aiff", fixtures.aiff_file(sig.astype(">i2").tobytes(), 1, 22254.545, 16))
    assert a.sample_rate == ak.aiff(fixtures.aiff_file(sig.astype(">i2").tobytes(), 1,
                                                       22254.545, 16)).sample_rate != 22254


def test_aifc_sowt_and_ulaw():
    sig = RNG.integers(-32768, 32767, (1, 200))
    payload = sig.reshape(-1).astype("<i2").tobytes()
    a = load("aiff", fixtures.aiff_file(payload, 1, 22050, 16, aifc=True, compression=b"sowt"))
    ref = refc.pcm_ref(payload, 16, "signed", 1, True, big_endian=False)
    np.testing.assert_array_equal(data(a), ref.astype(np.float32))
    g = bytes(RNG.integers(0, 256, 400, dtype=np.uint8))
    b = load("aiff", fixtures.aiff_file(g, 2, 8000, 16, aifc=True, compression=b"ulaw"))
    np.testing.assert_array_equal(
        data(b), refc.g711_ref(g[: b.num_samples * 2], True, 2).astype(np.float32))
    fl = (RNG.random(64) * 2 - 1).astype(">f4").tobytes()
    load("aiff", fixtures.aiff_file(fl, 2, 48000, 32, aifc=True, compression=b"fl32"))
    with pytest.raises(ValueError):
        tk.aiff(fixtures.aiff_file(g, 2, 8000, 16, aifc=True, compression=b"ima4"),
                device="cpu")


def test_au_encodings():
    sig = RNG.integers(-32768, 32767, 200)
    payload = sig.astype(">i2").tobytes()
    a = load("au", fixtures.au_file(payload, 3, 16000, 2))
    assert a.sample_rate == 16000 and a.channels == 2
    ref = refc.pcm_ref(payload, 16, "signed", 2, True, big_endian=True)
    np.testing.assert_array_equal(data(a), ref.astype(np.float32))
    g = bytes(RNG.integers(0, 256, 300, dtype=np.uint8))
    b = load("au", fixtures.au_file(g, 1, 8000, 1))
    np.testing.assert_array_equal(data(b), refc.g711_ref(g, True, 1).astype(np.float32))
    for enc in (2, 4, 5, 6, 27):
        load("au", fixtures.au_file(bytes(RNG.integers(0, 256, 96, dtype=np.uint8)), enc, 8000,
                                    2))


def test_mdfpwm_roundtrip():
    """One 6000-byte left block and a short right one: both channels decode
    as two lanes over the right's 5800 bytes, the left's last 200 on one
    lane from its carried state; the audio ends with the shorter channel."""
    left = bytes(RNG.integers(0, 256, 6000, dtype=np.uint8))
    right = bytes(RNG.integers(0, 256, 5800, dtype=np.uint8))
    f = fixtures.mdfpwm_file(left, right, length_pairs=11800)
    a = load("mdfpwm", f)
    assert a.channels == 2 and a.sample_rate == 48000 and a.num_samples == 5800 * 8
    assert a.metadata == {"artist": "art", "title": "tit", "album": "alb"}
    refl = refc.dfpwm_decode_ref(left)[: 5800 * 8]
    refr = refc.dfpwm_decode_ref(right)
    np.testing.assert_array_equal(
        data(a), pcmcode.normalize_pcm(np.stack([refl, refr]), 8, "signed"))
    h = load("mdfpwm", f, True)
    assert h.metadata["title"] == "tit" and h.num_samples == 0


def test_detect():
    assert tk.detect(fixtures.wav_pcm(np.zeros((1, 100), int), 48000, 16))[0] == "wav"
    assert tk.detect(fixtures.aiff_file(b"\0" * 100, 1, 48000, 16))[0] == "aiff"
    assert tk.detect(fixtures.au_file(b"\0" * 10, 3, 8000, 1))[0] == "au"
    assert tk.detect(b"fLaC" + b"\0" * 50)[0] == "flac"
    assert tk.detect(b"MDFPWM\x03" + b"\0" * 20)[0] == "mdfpwm"
    assert tk.detect(b"qoaf" + b"\0" * 20)[0] == "qoa"
    assert tk.detect(b"\x55" * 30)[0] == "dfpwm"
    quiet = np.full(64, 5, dtype="<i2").tobytes()
    assert tk.detect(quiet) == ak.detect(quiet) and tk.detect(quiet)[0] == "pcm"
    assert tk.detect(b"") == (None, None, None)


def test_flac_header_and_metadata():
    hdr = fixtures.flac_stream_header(44100, 2, 16, 1000, {"TITLE": "Song", "ARTIST": "Me"})
    a = load("flac", hdr, True)
    assert a.sample_rate == 44100
    assert a.metadata["title"] == "Song"
    assert a.metadata["artist"] == "Me"


def test_flac_constant_and_verbatim():
    vals = RNG.integers(-(1 << 15), 1 << 15, 192).tolist()
    frame = fixtures.flac_frame(
        [{"type": "verbatim", "values": vals}, {"type": "constant", "value": -1234}],
        192, 1, 16,
    )
    a = load("flac", fixtures.flac_stream_header(48000, 2, 16, 192) + frame)
    assert a.num_samples == 192
    want = (np.array(vals, np.int64) / 65536.0).astype(np.float32)
    np.testing.assert_array_equal(data(a)[0], want)
    np.testing.assert_array_equal(data(a)[1], np.full(192, -1234 / 65536.0, np.float32))


def _inverse_fixed(signal, order):
    """Residuals for a fixed predictor so decode reproduces `signal`."""
    coefs = [[], [1], [2, -1], [3, -3, 1], [4, -6, 4, -1]][order]
    res = list(signal[:order])
    for i in range(order, len(signal)):
        res.append(signal[i] - sum(signal[i - 1 - j] * coefs[j] for j in range(order)))
    return res


def test_flac_fixed_prediction_exact():
    sig = np.cumsum(RNG.integers(-50, 50, 576)).astype(np.int64).tolist()
    for order in (1, 2, 3):
        res = _inverse_fixed(sig, order)
        frame = fixtures.flac_frame(
            [{"type": "fixed", "order": order, "warmup": sig[:order],
              "residuals": res[order:], "param": 8, "partition_order": 0}],
            576, 0, 16,
        )
        a = load("flac", fixtures.flac_stream_header(48000, 1, 16, 576) + frame)
        np.testing.assert_array_equal(data(a)[0], (np.array(sig) / 65536.0).astype(np.float32))


def test_flac_lpc_and_stereo_modes():
    """LPC subframes (the restore kernel's rows) in every channel mode."""
    n = 256
    base = (np.sin(np.arange(n) / 9) * 3000).astype(np.int64)
    side = (np.cos(np.arange(n) / 14) * 500).astype(np.int64)
    order, shift = 2, 5
    coefs = [40, -13]

    def residuals(sig):
        res = list(sig[:order])
        for i in range(order, len(sig)):
            res.append(int(sig[i]) - ((sig[i - 1] * coefs[0] + sig[i - 2] * coefs[1]) >> shift))
        return res

    for asgn in (0, 8, 9, 10):
        left, right = base, base - side
        subs_sig = {0: [base], 8: [left, left - right], 9: [left - right, right],
                    10: [(left + right) >> 1, left - right]}[asgn]
        subframes = [{"type": "lpc", "order": order, "warmup": [int(v) for v in sig[:order]],
                      "precision": 7, "shift": shift, "coefs": coefs,
                      "residuals": residuals(sig)[order:], "param": 9, "partition_order": 2}
                     for sig in subs_sig]
        frame = fixtures.flac_frame(subframes, n, asgn, 16)
        channels = 1 if asgn == 0 else 2
        a = load("flac", fixtures.flac_stream_header(48000, channels, 16, n) + frame)
        np.testing.assert_array_equal(data(a)[0], (base / 65536.0).astype(np.float32))
        if asgn:
            np.testing.assert_array_equal(data(a)[1], ((base - side) / 65536.0).astype(np.float32))


def test_flac_escape_partition_and_wasted_bits():
    n = 192
    sig = (RNG.integers(-1000, 1000, n) * 4).astype(np.int64)  # 2 wasted bits
    frame = fixtures.flac_frame([{"type": "verbatim", "values": (sig >> 2).tolist(),
                                  "wasted": 2}], n, 0, 16)
    a = load("flac", fixtures.flac_stream_header(48000, 1, 16, n) + frame)
    np.testing.assert_array_equal(data(a)[0], (sig / 65536.0).astype(np.float32))


def test_loaders_default_to_the_card():
    """Every loader's default ``device="cuda"`` raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    w = fixtures.wav_pcm(np.zeros((1, 8), int), 8000, 16)
    for call in (lambda: tk.wav(w), lambda: tk.aiff(fixtures.aiff_file(b"\0" * 8, 1, 8000, 16)),
                 lambda: tk.au(fixtures.au_file(b"\0" * 8, 3, 8000, 1)),
                 lambda: tk.flac(fixtures.flac_stream_header(48000, 1, 16, 0), True),
                 lambda: tk.qoa(fixtures.qoa_stream(RNG, 1, 8000, [20])),
                 lambda: tk.mdfpwm(fixtures.mdfpwm_file(b"", b"", 0))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
