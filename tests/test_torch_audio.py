"""aukit_tpu_torch's ``Audio`` object, resampler and generators against the
JAX package (twins of tests/test_audio.py). The same seeded numpy inputs go
to the JAX function (the resampler jitted, as the package runs it) and to the
port on the CPU (``device="cpu"``).

Tolerances: sample values, lengths and metadata bit-equal, with two stated
exceptions, each a sum whose order the port cannot see:
 - the sinc resampler: the JAX package sums its 61 taps with XLA's dot, the
   port one tap at a time (largest difference seen in these tests 6.0e-8);
 - ``mono()`` over more than 64 channels that are no multiple of 32: XLA's
   reduce order there is not modelled (largest difference seen 6.0e-8); up
   to 64 channels and at multiples of 32 the port adds in XLA's order and
   multiplies by float32(1 / C), bit-equal.
Both are held to 2e-6, the tolerance the JAX package's own tests hold its
sinc resampler to against the loop oracle (tests/test_audio.py).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import aukit_tpu as ak
import aukit_tpu_torch as tk
from aukit_tpu.ops.resample import resample_audio_array as jax_resample
from aukit_tpu_torch.interop import audio_from_numpy, audio_to_numpy
from aukit_tpu_torch.ops.resample import resample_audio_array
from tests.ref.resample import resample_ref

RNG = np.random.default_rng(7)
REDUCTION_ATOL = 2e-6


def data(audio) -> np.ndarray:
    """Samples of either package's Audio as numpy."""
    return audio.numpy() if isinstance(audio, tk.Audio) else np.asarray(audio.data)


def twin(jax_audio) -> tk.Audio:
    return audio_from_numpy(np.asarray(jax_audio.data), jax_audio.sample_rate,
                            jax_audio.metadata, jax_audio.info, device="cpu")


def assert_same_audio(got: tk.Audio, want) -> None:
    np.testing.assert_array_equal(data(got), data(want))
    assert got.sample_rate == want.sample_rate
    assert got.metadata == want.metadata and got.info == want.info


@pytest.mark.parametrize("loader, args", [("pcm", (8, "signed", 1)), ("adpcm", (1,)),
                                          ("g711", (True, 1)), ("dfpwm", (1,))])
def test_loaders_keep_a_fractional_rate(loader, args):
    """The loaders keep a caller's fractional rate as the JAX loaders do
    (ROADMAP queue 3, fault 3.1: ``new_audio``'s ``int()`` truncated it)."""
    raw = RNG.integers(0, 256, 64, dtype=np.uint8).tobytes()
    got = getattr(tk, loader)(raw, *args, 8000.5, device="cpu")
    want = getattr(ak, loader)(raw, *args, 8000.5)
    assert got.sample_rate == want.sample_rate == 8000.5
    np.testing.assert_array_equal(data(got), data(want))


@pytest.mark.parametrize("mode", ["none", "linear", "cubic"])
def test_fractional_rate_duration_and_resample(mode):
    """At 22254.545 Hz (a classic Macintosh rate), 1 channel x 400 samples:
    ``duration`` and ``.resample(48000)`` equal the JAX package's."""
    raw = RNG.integers(-32768, 32767, 400).astype("<i2").tobytes()
    got = tk.pcm(raw, 16, "signed", 1, 22254.545, device="cpu")
    want = ak.pcm(raw, 16, "signed", 1, 22254.545)
    assert got.duration == want.duration
    assert_same_audio(got.resample(48000, mode), want.resample(48000, mode))


@pytest.mark.parametrize("mode", ["none", "linear", "cubic", "sinc"])
@pytest.mark.parametrize("rates", [(24000, 48000), (44100, 48000), (48000, 8000), (32000, 44100)])
def test_resample_parity(mode, rates):
    """Against the jitted JAX resampler: bit-equal for none, linear and cubic
    (the port fuses the multiply-adds XLA fuses), sinc within 2e-6; and
    against the loop oracle at the JAX test's own tolerance."""
    src, dst = rates
    chan = (RNG.random(997) * 2 - 1).astype(np.float32)
    x = np.stack([chan, chan[::-1].copy()])
    got = resample_audio_array(torch.tensor(x), src, dst, mode).numpy()
    want = np.asarray(jax_resample(x, src, dst, mode))
    assert got.shape == want.shape
    if mode == "sinc":
        np.testing.assert_allclose(got, want, rtol=0, atol=REDUCTION_ATOL)
    else:
        np.testing.assert_array_equal(got, want)
    ref = resample_ref(list(chan.astype(np.float64)), src, dst, mode)
    atol = 2e-6 if mode in ("sinc", "cubic") else 3e-7
    np.testing.assert_allclose(got[0], np.array(ref, np.float32), rtol=0, atol=atol)


def test_resample_identity_passthrough():
    a = tk.noise(0.01, 1.0, 1, 48000, seed=1, device="cpu")
    b = a.resample(96000).resample(48000)
    assert b.num_samples == a.num_samples
    j = ak.noise(0.01, 1.0, 1, 48000, seed=1).resample(96000).resample(48000)
    np.testing.assert_array_equal(data(b), data(j))


@pytest.mark.parametrize("channels", [1, 2, 3, 8, 32, 33, 47, 64, 96, 100])
def test_mono_mean(channels):
    """Bit-equal to the JAX mean up to 64 channels and at multiples of 32;
    100 channels within 2e-6 of XLA's reduce."""
    a = tk.new_audio(np.array([[1.0, 0.0], [0.0, 1.0]]), 48000, device="cpu")
    np.testing.assert_allclose(data(a.mono()), [[0.5, 0.5]])
    x = (RNG.random((channels, 3000)) * 2 - 1).astype(np.float32)
    got = tk.new_audio(x, 44100, device="cpu").mono()
    want = ak.new_audio(x, 44100).mono()
    if channels <= 64 or channels % 32 == 0:
        np.testing.assert_array_equal(data(got), data(want))
    else:
        np.testing.assert_allclose(data(got), data(want), rtol=0, atol=REDUCTION_ATOL)


def test_concat_channels_and_resample():
    a = tk.new_audio(np.ones((2, 10)), 48000, device="cpu")
    b = tk.new_audio(np.zeros((1, 5)), 48000, device="cpu")
    c = a.concat(b)
    assert c.channels == 2 and c.num_samples == 15
    np.testing.assert_array_equal(data(c)[1, 10:], np.zeros(5))
    # a later audio at another rate is resampled first
    x = (RNG.random((1, 300)) * 2 - 1).astype(np.float32)
    y = (RNG.random((2, 200)) * 2 - 1).astype(np.float32)
    got = tk.new_audio(x, 48000, device="cpu").concat(tk.new_audio(y, 32000, device="cpu"))
    want = ak.new_audio(x, 48000).concat(ak.new_audio(y, 32000))
    np.testing.assert_array_equal(data(got), data(want))


def test_sub_seconds_conventions():
    a = tk.new_audio(np.arange(10 * 100, dtype=np.float32)[None, :] / 2000, 100, device="cpu")
    s = a.sub(2, 4)
    assert s.num_samples == 201  # inclusive like the reference
    s2 = a.sub(-3, 0)
    assert s2.num_samples == 300
    np.testing.assert_array_equal(data(s2), data(a)[:, 700:1000])
    j = ak.new_audio(np.arange(10 * 100, dtype=np.float32)[None, :] / 2000, 100)
    for args in ((2, 4), (-3, 0), (0, -2), (1.5, 3.7)):
        np.testing.assert_array_equal(data(a.sub(*args)), data(j.sub(*args)))
    with pytest.raises(ValueError):
        a.sub(20, 30)


def test_combine_split_mix_rep_reverse():
    a = tk.new_audio(np.ones((1, 8)) * 0.25, 48000, device="cpu")
    b = tk.new_audio(np.ones((1, 4)) * 0.5, 48000, device="cpu")
    c = a.combine(b)
    assert c.channels == 2
    np.testing.assert_array_equal(data(c)[1], [0.5] * 4 + [0.0] * 4)
    left, right = c.split([1], [2])
    assert left.channels == right.channels == 1
    m = a.mix(2.0, b)
    np.testing.assert_allclose(data(m)[0], [1.0] * 4 + [0.5] * 4)  # clipped
    m2 = a.mix(b)  # audio as amplifier -> amp 1
    np.testing.assert_allclose(data(m2)[0], [0.75] * 4 + [0.25] * 4)
    assert (a * 3).num_samples == 24
    np.testing.assert_array_equal(data(a.reverse()), data(a)[:, ::-1])
    # random audio at two rates through every transform, against JAX
    x = (RNG.random((2, 500)) * 1.6 - 0.8).astype(np.float32)
    y = (RNG.random((3, 301)) * 1.6 - 0.8).astype(np.float32)
    ta, tb = tk.new_audio(x, 48000, device="cpu"), tk.new_audio(y, 44100, device="cpu")
    ja, jb = ak.new_audio(x, 48000), ak.new_audio(y, 44100)
    for got, want in ((ta.combine(tb), ja.combine(jb)), (ta.mix(1.7, tb), ja.mix(1.7, jb)),
                      (ta.mix(tb, ta), ja.mix(jb, ja)), (ta * 2, ja * 2),
                      (tb.split([3, 1]), jb.split([3, 1])), (tb.reverse(), jb.reverse())):
        np.testing.assert_array_equal(data(got), data(want))
    with pytest.raises(ValueError):
        tb.split([4])
    with pytest.raises(ValueError):
        tb.split([])


def test_operators():
    a = tk.new_audio(np.ones((1, 4)), 48000, device="cpu")
    b = tk.new_audio(np.zeros((1, 4)), 48000, device="cpu")
    assert (a + b).channels == 2
    assert (a * 2).num_samples == 8 and (2 * a).num_samples == 8
    assert len(a) == 4 and abs(a.duration - 4 / 48000) < 1e-12
    assert repr(a) == repr(ak.new_audio(np.ones((1, 4)), 48000))


def test_tone_generators_match_formulas():
    """Every wave type, the JAX package's samples bit for bit (both compute
    in float64 numpy), and the closed forms to 1e-6; seeded noise too."""
    for wt in ("sine", "triangle", "square", "sawtooth"):
        a = tk.tone(440, 0.01, 0.8, wt, 0.3, 1, 48000, device="cpu")
        assert a.num_samples == 480
        np.testing.assert_array_equal(data(a), data(ak.tone(440, 0.01, 0.8, wt, 0.3, 1, 48000)))
        x = np.arange(1, 481) / 48000.0
        if wt == "sine":
            ref = np.sin(2 * x * np.pi * 440) * 0.8
        elif wt == "triangle":
            ref = 2 * np.abs(0.8 * np.fmod(2 * x * 440 + 1.5, 2.0) - 0.8) - 0.8
        elif wt == "square":
            ref = np.where((x * 440) % 1 >= 0.3, -0.8, 0.8)
        else:
            ref = 0.8 * np.fmod(2 * x * 440 + 1.0, 2.0) - 0.8
        np.testing.assert_allclose(data(a)[0], ref.astype(np.float32), atol=1e-6)
    np.testing.assert_array_equal(data(tk.noise(0.02, 0.7, 2, 8000, seed=3, device="cpu")),
                                  data(ak.noise(0.02, 0.7, 2, 8000, seed=3)))
    np.testing.assert_array_equal(data(tk.new(0.01, 2, 8000, device="cpu")),
                                  data(ak.new(0.01, 2, 8000)))
    with pytest.raises(ValueError):
        tk.tone(440, 0.1, 1.5, device="cpu")
    with pytest.raises(ValueError):
        tk.tone(440, 0.1, 0.5, "pulse", device="cpu")


def test_audio_stream_chunks():
    a = tk.tone(100, 1.0, 0.5, sample_rate=4800, device="cpu")
    it, length = a.stream(1000, 16, "signed")
    assert abs(length - 1.0) < 1e-9
    chunks = list(it)
    assert len(chunks) == 5
    vals, pos = chunks[1]
    assert pos == 1000 / 4800
    assert vals.shape == (1, 1000)
    jit, jlength = ak.tone(100, 1.0, 0.5, sample_rate=4800).stream(1000, 16, "signed")
    assert jlength == length
    for (g, gp), (w, wp) in zip(chunks, jit, strict=True):
        np.testing.assert_array_equal(g, w)
        assert gp == wp


def test_audio_carries_across_packages():
    """The pytree protocol has no counterpart; an Audio crosses between the
    packages as numpy samples with its rate and dicts (``interop``), and its
    encoders return what the JAX package's return."""
    j = ak.tone(440, 0.01, 0.6, channels=2, sample_rate=22050)
    j.metadata, j.info = {"title": "t"}, {"bitDepth": 16, "dataType": "signed"}
    t = twin(j)
    assert dataclasses.is_dataclass(t) and t.device == torch.device("cpu")
    assert_same_audio(t, j)
    np.testing.assert_array_equal(audio_to_numpy(t), np.asarray(j.data))
    for args in ((8, "signed"), (16, "signed", False), (24, "unsigned"), (32, "float")):
        np.testing.assert_array_equal(t.pcm(*args), j.pcm(*args))
        assert t.to_pcm_bytes(*args) == j.to_pcm_bytes(*args)
    assert t.to_pcm_bytes(16, "signed", True, True) == j.to_pcm_bytes(16, "signed", True, True)
    assert t.wav(16) == j.wav(16) and t.wav(8) == j.wav(8)
    # jax is imported by the JAX package; the port needs none of it
    assert jax.default_backend() == "cpu"


def test_entry_points_default_to_the_card():
    """Without a card the default ``device="cuda"`` raises; nothing falls
    back to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for call in (lambda: tk.new_audio(np.zeros((1, 4)), 48000), lambda: tk.tone(440, 0.01),
                 lambda: tk.noise(0.01), lambda: tk.new(0.01),
                 lambda: audio_from_numpy(np.zeros((1, 4)), 48000)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
