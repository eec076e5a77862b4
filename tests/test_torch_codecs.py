"""aukit_tpu_torch's whole-file codecs against the JAX package (twins of
tests/test_codecs.py), and the whole-file loaders' kernel launches (the CPU
halves of tests/torch_kernel_cases.py ``whole_file_cases``). The same seeded
inputs go through the JAX decoders (their scans jitted, their Pallas kernels
in interpret mode) and through the port on the CPU (``device="cpu"``), where
every kernel wrapper runs its plain version.

Tolerance: 0 everywhere. Integer decodes, PCM values, float samples and bytes
written are bit-equal; so is every case's output and final state.

Twins of the DFPWM scan, golden and host-byte tests of tests/test_codecs.py
live in tests/test_torch_dfpwm.py and are not repeated here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aukit_tpu as ak
import aukit_tpu_torch as tk
from aukit_tpu.codecs import adpcm as jadpcm
from aukit_tpu.codecs import dfpwm as jdfpwm
from aukit_tpu.codecs import flac as jflac
from aukit_tpu.codecs import qoa as jqoa
from aukit_tpu.codecs import g711 as jg711
from aukit_tpu.ops import pcmcode as jpcm
from aukit_tpu_torch import kernels
from aukit_tpu_torch.codecs import adpcm, dfpwm, flac, qoa
from aukit_tpu_torch.codecs.g711 import decode_g711, g711_expand_lut, g711_float_lut
from aukit_tpu_torch.native import flacbits
from aukit_tpu_torch.ops import pcmcode
from tests import fixtures
from tests import torch_kernel_cases as kernel_cases
from tests.ref import codecs as refc

RNG = np.random.default_rng(42)
CASE_SECONDS = 0.1  # the whole-file cases at a tenth of a second on the CPU
WHOLE_FILE_CASES = [c[0] for c in kernel_cases.whole_file_cases("cpu", CASE_SECONDS)]


def data(audio) -> np.ndarray:
    return audio.numpy() if isinstance(audio, tk.Audio) else np.asarray(audio.data)


def assert_same_audio(got, want):
    np.testing.assert_array_equal(data(got), data(want))
    assert got.sample_rate == want.sample_rate
    assert got.metadata == want.metadata and got.info == want.info


# -- PCM -----------------------------------------------------------------------

@pytest.mark.parametrize("bit_depth", [8, 16, 24, 32])
@pytest.mark.parametrize("data_type", ["signed", "unsigned"])
@pytest.mark.parametrize("big_endian", [False, True])
def test_pcm_bytes_parity(bit_depth, data_type, big_endian):
    raw = RNG.integers(0, 256, 4 * 30, dtype=np.uint8).tobytes()
    got = pcmcode.decode_pcm(raw, bit_depth, data_type, 2, True, big_endian)
    np.testing.assert_array_equal(got, jpcm.decode_pcm(raw, bit_depth, data_type, 2, True,
                                                       big_endian))
    ref = refc.pcm_ref(raw, bit_depth, data_type, 2, True, big_endian)
    np.testing.assert_array_equal(got, ref.astype(np.float32))
    np.testing.assert_array_equal(pcmcode.unpack_pcm(raw, bit_depth, data_type, big_endian),
                                  jpcm.unpack_pcm(raw, bit_depth, data_type, big_endian))


def test_pcm_float_and_planar():
    vals = (RNG.random(64, dtype=np.float64) * 2 - 1).astype("<f4")
    got = pcmcode.decode_pcm(vals.tobytes(), 32, "float", 2, False, False)
    ref = refc.pcm_ref(vals.tobytes(), 32, "float", 2, False, False)
    np.testing.assert_array_equal(got, ref.astype(np.float32))
    np.testing.assert_array_equal(got, jpcm.decode_pcm(vals.tobytes(), 32, "float", 2, False,
                                                       False))


def test_pcm_table_input_and_loader():
    vals = RNG.integers(-32768, 32767, 100).tolist()
    a = tk.pcm(vals, 16, "signed", 2, 44100, device="cpu")
    ref = refc.pcm_ref(vals, 16, "signed", 2, True)
    np.testing.assert_array_equal(data(a), ref.astype(np.float32))
    assert a.sample_rate == 44100
    assert a.info == {"bitDepth": 16, "dataType": "signed"}
    assert_same_audio(a, ak.pcm(vals, 16, "signed", 2, 44100))
    raw = RNG.integers(0, 256, 96, dtype=np.uint8).tobytes()
    assert_same_audio(tk.pcm(raw, 24, "unsigned", 2, 8000, False, True, device="cpu"),
                      ak.pcm(raw, 24, "unsigned", 2, 8000, False, True))
    for bad in ((12, "signed"), (16, "float"), (8, "complex")):
        with pytest.raises(ValueError):
            tk.pcm(raw, *bad, device="cpu")
    with pytest.raises(ValueError):
        tk.pcm(raw[:95], 8, "signed", 2, device="cpu")


def test_pcm_unsigned_quirk_q1():
    # 16-bit unsigned: the reference biases by 128, not 32768
    vals = [0, 127, 128, 129, 40000]
    got = pcmcode.normalize_pcm(np.array(vals), 16, "unsigned")
    expect = [(v - 128) / (32768.0 if v < 128 else 32767.0) for v in vals]
    np.testing.assert_allclose(got, np.array(expect, np.float32))
    np.testing.assert_array_equal(got, jpcm.normalize_pcm(np.array(vals), 16, "unsigned"))


def test_encode_pcm_asymmetric_no_round():
    a = tk.new_audio(np.array([[-1.0, -0.5, 0.0, 0.5, 1.0]]), 48000, device="cpu")
    vals = a.pcm(16, "signed")
    np.testing.assert_array_equal(vals, [-32768.0, -16384.0, 0.0, 16383.5, 32767.0])
    x = (RNG.random((2, 50)) * 2 - 1).astype(np.float32)
    for args in ((8, "unsigned"), (24, "signed"), (32, "float")):
        np.testing.assert_array_equal(pcmcode.encode_pcm_values(x, *args),
                                      jpcm.encode_pcm_values(x, *args))


def test_pack_roundtrip():
    vals = RNG.integers(-(1 << 23), (1 << 23) - 1, 50)
    packed = tk.pack(vals, 24, "signed", big_endian=True)
    assert packed == ak.pack(vals, 24, "signed", big_endian=True)
    np.testing.assert_array_equal(pcmcode.unpack_pcm(packed, 24, "signed", True), vals)


# -- G.711 -----------------------------------------------------------------------

@pytest.mark.parametrize("ulaw", [False, True])
def test_g711_parity(ulaw):
    raw = bytes(range(256)) * 3
    got = decode_g711(raw, ulaw, channels=2)
    np.testing.assert_array_equal(got, refc.g711_ref(raw, ulaw, channels=2).astype(np.float32))
    np.testing.assert_array_equal(got, jg711.decode_g711(raw, ulaw, channels=2))
    # the host table and the engine's elementwise form give one expansion
    dev = tk.codecs.g711.decode_g711_device(torch.tensor(np.frombuffer(raw, np.uint8)), ulaw, 1,
                                            0x2000)
    np.testing.assert_array_equal(dev.numpy()[0] * 0x2000,
                                  g711_expand_lut(ulaw)[np.frombuffer(raw, np.uint8)])
    np.testing.assert_array_equal(g711_float_lut(ulaw, 0x40), jg711.g711_float_lut(ulaw, 0x40))


def test_g711_loader_quirk_q11():
    a = tk.g711(bytes(100), True, 1, 8000, device="cpu")
    assert a.metadata == {"bitDepth": 14, "dataType": "signed"}
    assert a.info == {}
    raw = RNG.integers(0, 256, 301, dtype=np.uint8).tobytes()
    assert_same_audio(tk.g711(raw, False, 3, 8000, device="cpu"), ak.g711(raw, False, 3, 8000))


# -- IMA ADPCM ----------------------------------------------------------------------

def test_ima_parity_interleaved():
    raw = RNG.integers(0, 256, 400, dtype=np.uint8).tobytes()
    got = adpcm.decode_ima_adpcm(raw, channels=2, top_first=True, interleaved=True, device="cpu")
    nibs = refc.nibbles_from_bytes(raw, top_first=True)
    np.testing.assert_array_equal(got[0], refc.ima_ref(nibs[0::2]))
    np.testing.assert_array_equal(got[1], refc.ima_ref(nibs[1::2]))
    np.testing.assert_array_equal(got, jadpcm.decode_ima_adpcm(raw, 2, True, True))
    assert_same_audio(tk.adpcm(raw, 2, 22050, device="cpu"), ak.adpcm(raw, 2, 22050))


def test_ima_parity_planar_with_state():
    raw = RNG.integers(0, 256, 100, dtype=np.uint8).tobytes()
    got = adpcm.decode_ima_adpcm(raw, 2, False, False, predictor=[100, -5000],
                                 step_index=[3, 70], device="cpu")
    nibs = refc.nibbles_from_bytes(raw, top_first=False)
    half = len(nibs) // 2
    np.testing.assert_array_equal(got[0], refc.ima_ref(nibs[:half], 100, 3))
    np.testing.assert_array_equal(got[1], refc.ima_ref(nibs[half:], -5000, 70))
    np.testing.assert_array_equal(
        got, jadpcm.decode_ima_adpcm(raw, 2, False, False, [100, -5000], [3, 70]))
    with pytest.raises(ValueError):
        adpcm.decode_ima_adpcm(raw, 1, step_index=[89], device="cpu")


# -- MS ADPCM -----------------------------------------------------------------------

def test_msadpcm_stereo_parity():
    t = np.arange(4096)
    sig = np.stack([
        (np.sin(t / 30) * 12000).astype(np.int64),
        (np.sin(t / 17 + 1) * 9000).astype(np.int64),
    ])
    raw = fixtures.ms_encode(sig, 256)
    got = adpcm.decode_msadpcm(raw, 256, 2, device="cpu")
    np.testing.assert_array_equal(got, refc.msadpcm_ref(raw, 256, 2))
    np.testing.assert_array_equal(got, jadpcm.decode_msadpcm(raw, 256, 2))
    # a trailing partial block, decoded as far as its bytes go
    np.testing.assert_array_equal(adpcm.decode_msadpcm(raw[:-100], 256, 2, device="cpu"),
                                  jadpcm.decode_msadpcm(raw[:-100], 256, 2))


def test_msadpcm_mono_header_quirk_q4():
    sig = (np.sin(np.arange(4096) / 25) * 11000).astype(np.int64)[None, :]
    raw = fixtures.ms_encode(sig, 128)
    got = adpcm.decode_msadpcm(raw, 128, 1, device="cpu")
    np.testing.assert_array_equal(got, refc.msadpcm_ref(raw, 128, 1,
                                                        mono_header_from_first_block=True))
    got_fixed = adpcm.decode_msadpcm(raw, 128, 1, mono_header_from_first_block=False,
                                     device="cpu")
    np.testing.assert_array_equal(got_fixed, refc.msadpcm_ref(
        raw, 128, 1, mono_header_from_first_block=False))
    assert_same_audio(tk.msadpcm(raw[:-50], 128, 1, 11025, device="cpu"),
                      ak.msadpcm(raw[:-50], 128, 1, 11025))


def test_msadpcm_random_nibbles_stereo():
    raw = RNG.integers(0, 256, 256 * 4, dtype=np.uint8)
    for b in range(4):
        raw[b * 256: b * 256 + 2] = [RNG.integers(0, 7), RNG.integers(0, 7)]
        raw[b * 256 + 2: b * 256 + 4] = np.frombuffer(np.int16(200).tobytes(), np.uint8)
        raw[b * 256 + 4: b * 256 + 6] = np.frombuffer(np.int16(180).tobytes(), np.uint8)
    raw = raw.tobytes()
    got = adpcm.decode_msadpcm(raw, 256, 2, device="cpu")
    np.testing.assert_array_equal(got, refc.msadpcm_ref(raw, 256, 2))
    coefs = ([256, 512, 0, 192, 240, 460, 392, 100], [0, -256, 0, 64, 0, -208, -232, 50])
    np.testing.assert_array_equal(adpcm.decode_msadpcm(raw, 256, 2, coefs, device="cpu"),
                                  jadpcm.decode_msadpcm(raw, 256, 2, coefs))


# -- QOA ---------------------------------------------------------------------------

def test_qoa_parity():
    raw = fixtures.qoa_stream(RNG, 2, 44100, [5120, 5120, 1000])
    got, rate, total = qoa.decode_qoa(raw, device="cpu")
    ref, rrate, rtotal = refc.qoa_ref(raw)
    assert rate == rrate == 44100
    assert total == rtotal
    np.testing.assert_array_equal(got, ref)
    want, _, _ = jqoa.decode_qoa(raw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jqoa.decode_qoa(raw, use_native=False)[0])
    frames, n = qoa.parse_qoa_frames(raw, 8, 2, 44100, total)
    jframes, jn = jqoa.parse_qoa_frames(raw, 8, 2, 44100, total)
    assert n == jn and len(frames) == len(jframes)
    for f, jf in zip(frames, jframes):
        for k in ("history", "weights", "dequant"):
            np.testing.assert_array_equal(f[k], jf[k])


@pytest.mark.parametrize("use_native", [None, False, True])
def test_decode_qoa_takes_the_jax_positional_arguments(use_native):
    """``decode_qoa(data, use_native)`` as in the JAX package, the device
    keyword only (ROADMAP queue 3, fault 3.5): None and False run kernel
    (f) on the device (its plain version here), True the native host LMS;
    every route gives the JAX package's samples."""
    raw = fixtures.qoa_stream(RNG, 2, 44100, [5120, 700])
    kernels.reset_counts()
    got = qoa.decode_qoa(raw, use_native, device="cpu")
    assert kernels.qoa_lms_ref.calls == (0 if use_native else 1)
    want = jqoa.decode_qoa(raw, use_native)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_qoa_loader():
    raw = fixtures.qoa_stream(RNG, 1, 48000, [2000])
    a = tk.qoa(raw, device="cpu")
    ref, _, _ = refc.qoa_ref(raw)
    np.testing.assert_array_equal(data(a), refc.norm16(ref).astype(np.float32))
    assert_same_audio(a, ak.qoa(raw))
    with pytest.raises(ValueError):
        tk.qoa(b"riff" + raw[4:], device="cpu")


# -- DFPWM ---------------------------------------------------------------------------

def test_dfpwm_roundtrip_quality():
    """A soft tone through the port's whole-file encoder and decoder
    (Audio.dfpwm, the dfpwm loader): bounded error, bytes and samples equal
    to the JAX package's."""
    t = np.arange(16000)
    sig = np.floor(np.sin(t / 40) * 60).astype(np.int32)
    a = tk.new_audio(sig[None, :] / 127.0, 48000, device="cpu")
    enc = a.dfpwm(True)
    assert enc == ak.new_audio(sig[None, :] / 127.0, 48000).dfpwm(True)
    dec = tk.dfpwm(enc, 1, 48000, device="cpu")
    assert_same_audio(dec, ak.dfpwm(enc, 1, 48000))
    levels = np.round(data(dec)[0] * np.where(data(dec)[0] < 0, 128, 127))
    err = (levels[2000:] - sig[2000:]).astype(np.float64)
    assert np.sqrt((err ** 2).mean()) < 12.0


def test_dfpwm_audio_encoders():
    a = tk.tone(440, 0.1, 0.5, sample_rate=48000, channels=2, device="cpu")
    j = ak.tone(440, 0.1, 0.5, sample_rate=48000, channels=2)
    inter = a.dfpwm(True)
    planar = a.dfpwm(False)
    assert isinstance(inter, bytes) and len(inter) == 48000 * 2 * 0.1 // 8
    assert isinstance(planar, tuple) and len(planar) == 2
    assert inter == j.dfpwm(True) and planar == j.dfpwm(False)
    # samples beyond [-1, 1] (a resample passes them through unclamped) give
    # the JAX package's bytes: their levels are clamped, which keeps every bit
    loud = tk.new_audio(np.linspace(-1.6, 1.7, 803)[None, :], 48000, device="cpu")
    assert loud.dfpwm(True) == ak.new_audio(np.linspace(-1.6, 1.7, 803)[None, :], 48000).dfpwm(True)
    assert tk.new_audio(np.zeros((2, 7)), 48000, device="cpu").dfpwm(False) == (b"", b"")


def test_ima_parallel_matches_sequential_scan():
    """The port's time-parallel IMA decode against the JAX sequential scan
    and the JAX associative form: bit-exact."""
    nibs = RNG.integers(0, 16, (7, 1009)).astype(np.int32)
    pred0 = RNG.integers(-32768, 32768, 7).astype(np.int32)
    sidx0 = RNG.integers(0, 89, 7).astype(np.int32)
    seq, (sp, si) = jadpcm.ima_adpcm_scan(jnp.asarray(nibs), jnp.asarray(pred0),
                                          jnp.asarray(sidx0))
    par, (pp, pi) = adpcm.ima_adpcm_parallel(torch.tensor(nibs), torch.tensor(pred0),
                                             torch.tensor(sidx0))
    np.testing.assert_array_equal(par.numpy(), np.asarray(seq))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(sp))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(si))
    jpar, _ = jadpcm.ima_adpcm_parallel(jnp.asarray(nibs), jnp.asarray(pred0),
                                        jnp.asarray(sidx0))
    np.testing.assert_array_equal(par.numpy(), np.asarray(jpar))


def test_native_dfpwm_rows_matches_scan():
    """The port's native host DFPWM decode and encode (the routes its
    whole-file times are compared with) against the JAX scans, state carried
    over two chunks, and an empty input."""
    if not flacbits.available():
        pytest.skip("the native library did not build")
    rng = np.random.default_rng(23)
    L = 3
    st_scan = jdfpwm.DfpwmState.zeros(L)
    st_nat = np.zeros((5, L), np.int32)
    for chunk in (rng.integers(0, 256, (L, 613), dtype=np.uint8),
                  rng.integers(0, 256, (L, 200), dtype=np.uint8)):
        exp, st_scan = jdfpwm.dfpwm_decode(jnp.asarray(chunk), st_scan)
        got, st_nat = flacbits.dfpwm_decode_rows(chunk, st_nat)
        np.testing.assert_array_equal(got, np.asarray(exp))
    np.testing.assert_array_equal(st_nat, np.stack([np.asarray(a) for a in (
        st_scan.charge, st_scan.strength, st_scan.previous_bit, st_scan.previous_charge,
        st_scan.lowpass)]))
    got, st2 = flacbits.dfpwm_decode_rows(np.zeros((L, 0), np.uint8), st_nat)
    assert got.shape == (L, 0)
    np.testing.assert_array_equal(st2, st_nat)
    lv = rng.integers(-128, 128, (L, 8 * 77)).astype(np.int32)
    enc_exp, st_scan = jdfpwm.dfpwm_encode(jnp.asarray(lv), jdfpwm.DfpwmState.zeros(L))
    enc_got, st_enc = flacbits.dfpwm_encode_rows(lv, np.zeros((3, L), np.int32))
    np.testing.assert_array_equal(enc_got, np.asarray(enc_exp))
    np.testing.assert_array_equal(st_enc, np.stack([np.asarray(a) for a in (
        st_scan.charge, st_scan.strength, st_scan.previous_bit)]))


# -- the whole-file loaders' kernel launches (CPU halves of the card's cases) -------------

def _dfpwm_state_np(st):
    return [a.numpy() for a in st.leaves()]


@pytest.mark.parametrize("name", WHOLE_FILE_CASES)
def test_whole_file_kernel_cases_match_jax(name):
    """Each launch shape of the whole-file loaders (``whole_file_cases`` at
    0.1 s; the card holds its kernels to the same cases at 180 s): the plain
    version the wrapper takes on the CPU against the JAX package's decoder
    of that codec (the jitted scans the Pallas kernels are held to, and the
    int64 LPC restore), output and final state bit-equal. The one-lane DFPWM
    cases are also held to the port's native host decode and encode, the
    card's reference at full length."""
    _, kern, args = next(c for c in kernel_cases.whole_file_cases("cpu", CASE_SECONDS)
                         if c[0] == name)
    if kern == "dfpwm_decode":
        out, st = kernels.dfpwm_decode_kernel(*args)
        want, want_st = jdfpwm.dfpwm_decode(jnp.asarray(args[0].numpy()),
                                            jdfpwm.DfpwmState.zeros(1))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        nat, nat_st = flacbits.dfpwm_decode_rows(args[0].numpy(), np.zeros((5, 1), np.int32))
        np.testing.assert_array_equal(out.numpy(), nat)
        np.testing.assert_array_equal(np.stack(_dfpwm_state_np(st)), nat_st)
    elif kern == "dfpwm_encode":
        out, st = kernels.dfpwm_encode_kernel(*args)
        want, _ = jdfpwm.dfpwm_encode(jnp.asarray(args[0].numpy().astype(np.int32)),
                                      jdfpwm.DfpwmState.zeros(1))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        nat, nat_st = flacbits.dfpwm_encode_rows(args[0].numpy().astype(np.int32),
                                                 np.zeros((3, 1), np.int32))
        np.testing.assert_array_equal(out.numpy(), nat)
        np.testing.assert_array_equal(np.stack(_dfpwm_state_np(st)[:3]), nat_st)
    elif kern == "ima":
        nibs, pred, sidx = args
        out, st = kernels.ima_decode_kernel(*args)
        want, want_st = jadpcm.ima_adpcm_scan(jnp.asarray(nibs.numpy(), jnp.int32),
                                              jnp.asarray(pred.numpy()), jnp.asarray(sidx.numpy()))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        for g, w in zip(st, want_st):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    elif kern == "msadpcm":
        nibs, s1, s2, delta, c1, c2 = args
        out, st = kernels.msadpcm_decode_kernel(*args)
        want = jadpcm.msadpcm_scan(*(jnp.asarray(a.numpy(), jnp.int32)
                                     for a in (nibs, c1, c2, delta, s1, s2)))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        np.testing.assert_array_equal(st[0].numpy(), np.asarray(want)[:, -1])
    elif kern == "qoa":
        out, st = kernels.qoa_lms_kernel(*args)
        want, want_st = jqoa.qoa_lms_scan(*(jnp.asarray(a.numpy(), jnp.int32) for a in args))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        for g, w in zip(st, want_st):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        vals, orders, shifts, blocks, coefs, K = args
        out = kernels.lpc_restore_kernel(*args)
        want = jflac.restore_lpc_batch(vals.numpy().astype(np.int64), coefs.numpy(),
                                       shifts.numpy(), orders.numpy())
        keep = np.arange(vals.shape[1])[None, :] < blocks.numpy()[:, None]
        np.testing.assert_array_equal(out.numpy()[keep], want[keep])


def test_whole_file_decoders_keep_empty_inputs_from_the_kernels():
    """Empty shapes never reach a kernel wrapper (the JAX package's guard,
    aukit_tpu/codecs/adpcm.py:190, :253): no plain call on the CPU, no launch on
    the card."""
    kernels.reset_counts()
    assert adpcm.ima_adpcm_blocks(np.zeros((0, 1016)), np.zeros(0), np.zeros(0),
                                  device="cpu").shape == (0, 1016)
    assert adpcm.ima_adpcm_blocks(np.zeros((4, 0)), np.zeros(4), np.zeros(4),
                                  device="cpu").shape == (4, 0)
    assert adpcm.decode_msadpcm_blocks(np.zeros((0, 1010)), np.zeros(0, int), np.zeros(0),
                                       np.zeros(0), np.zeros(0), device="cpu").shape == (0, 1010)
    assert adpcm.decode_msadpcm(b"", 1024, 2, device="cpu").shape == (2, 0)
    assert adpcm.decode_ima_adpcm(b"", 2, device="cpu").shape == (2, 0)
    empty_qoa = b"qoaf" + (0).to_bytes(4, "big") + bytes([2]) + (44100).to_bytes(3, "big")
    assert qoa.decode_qoa(empty_qoa, device="cpu")[0].shape == (2, 0)
    assert flac.restore_and_decorrelate(np.zeros((0, 2)), {k: np.zeros(0, np.int64) for k in (
        "order", "shift", "wasted", "block")}, np.zeros((0, 32)), np.zeros(0), 2, 16,
        device="cpu").shape == (2, 0)
    assert tk.dfpwm(b"", device="cpu").num_samples == 0
    assert tk.mdfpwm(fixtures.mdfpwm_file(b"", b"", 0), device="cpu").num_samples == 0
    assert tk.new_audio(np.zeros((1, 5)), 48000, device="cpu").dfpwm(True) == b""
    assert sum(fn.calls for fn in kernels.PLAIN) == 0
    assert sum(fn.launches for fn in kernels.KERNELS) == 0


def test_codec_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    raw = bytes(64)
    for call in (lambda: adpcm.decode_ima_adpcm(raw), lambda: qoa.decode_qoa(raw),
                 lambda: adpcm.decode_msadpcm(b"", 256, 2), lambda: flac.decode_flac(raw, True),
                 lambda: adpcm.ima_adpcm_blocks(np.zeros((1, 8)), [0], [0]),
                 lambda: adpcm.decode_msadpcm_blocks(np.zeros((1, 8)), [0], [16], [0], [0]),
                 lambda: dfpwm.decode_dfpwm_audio(raw), lambda: tk.adpcm(raw),
                 lambda: tk.msadpcm(raw, 32), lambda: tk.g711(raw, True), lambda: tk.dfpwm(raw),
                 lambda: tk.pcm(raw), lambda: flac.restore_and_decorrelate(
                     np.zeros((1, 2)), {"order": np.ones(1)}, None, None, 1, 16)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
