"""auplay's preload chain and bench.py config 5's effects chain through
aukit_tpu_torch on the CPU, against the same chains through the JAX package.

auplay (aukit_tpu/cli/auplay.py:58-70, without the sink): load a file ->
``resample(48000)`` -> ``mono()`` -> ``effects.normalize(0.8)`` ->
``effects.lowpass(rate / 2)`` -> ``stream(48000)``, on short tracks of every
container the loaders read (tests/torch_tracks.py: tones plus noise, stereo
44.1 kHz in WAV PCM16, IMA and MS ADPCM, FLAC, QOA, AIFF, AU µ-law and
DFPWM-in-WAV; raw DFPWM mono and MDFPWM stereo at 48 kHz).

Tolerances: every stage up to the lowpass bit-equal (the decoded samples,
the resample, the two-channel mean, the normalize); the lowpass is the
scan, held as the engine's filter is (within 1.2e-7, at least
``SCAN_EQUAL_FRAC``, 99.8%, bit-equal; 99.96% or more seen at these
poles, 0.056 for auplay's and 0.181 for config 5's), and so the streamed
chunks (the lowpass's output times 127 or 128, within 128 * 1.2e-7).
``test_chain_bit_equal_given_jax_scan`` runs every chain again with the
port's scan swapped for the JAX package's jitted ``_affine_scan`` of the
same (A, B): bit-equal throughout, so the residue lies in the scan alone. Config 5 (bench.py:777-785:
normalize(0.9) -> mono() -> lowpass(12000) -> resample(48000, "cubic") on a
multichannel 44.1 kHz Audio) at 8 channels x 0.5 s: the normalize and the
8-channel mean bit-equal, the lowpass as above, and the cubic resample,
fed the JAX package's own lowpass output so that it is held alone,
bit-equal.
"""

import numpy as np
import pytest
import torch

import aukit_tpu as ak
import aukit_tpu_torch as tk
from aukit_tpu import effects as jfx
from aukit_tpu_torch import effects as fx
from aukit_tpu_torch.codecs.g711 import g711_expand_lut
from aukit_tpu_torch.native import flacbits
from tests import torch_tracks as tracks

SCAN_ATOL = 1.2e-7
SCAN_EQUAL_FRAC = 0.998
# True while the port runs the JAX scan: the lowpass is then bit-equal
STRICT = False
KINDS = ["wav_pcm16", "wav_ima", "wav_msadpcm", "flac", "qoa", "aiff", "au_ulaw", "wav_dfpwm",
         "dfpwm", "mdfpwm"]


def make_file(kind: str):
    """(loader name, file bytes) of a short track in ``kind``."""
    x = tracks.synth_track(1.2, 44100, seed=len(kind))
    if kind == "wav_pcm16":
        return "wav", tracks.pcm16_wav(x, 44100)
    if kind == "wav_ima":
        return "wav", tracks.ima_wav(x, 44100)
    if kind == "wav_msadpcm":
        return "wav", tracks.msadpcm_wav(x, 44100)
    if kind == "flac":
        return "flac", tracks.flac_file(x, 44100, variants=3)[0]
    if kind == "qoa":
        return "qoa", tracks.qoa_file(x, 44100)
    if kind == "aiff":
        return "aiff", tracks.aiff16(x, 44100)
    if kind == "au_ulaw":
        return "au", tracks.ulaw_au(x, 44100, g711_expand_lut(True))
    # the DFPWM files are short: the plain loops take ~80 us a sample on a CPU
    if kind == "wav_dfpwm":
        return "wav", tk.new_audio(x[:, :13230] / 32768.0, 44100, device="cpu").wav(1)
    # raw DFPWM and MDFPWM bytes from the native host encoder (fast on the CPU)
    if kind == "dfpwm":
        x = tracks.synth_track(0.3, 48000, seed=len(kind), channels=1)
        enc, _ = flacbits.dfpwm_encode_rows(x >> 8, np.zeros((3, 1), np.int32))
        return "dfpwm", enc[0].tobytes()
    # MDFPWM decodes whole 6000-byte pairs of blocks: one second, and 0.3 s of
    # a second pair whose right block is missing
    x = tracks.synth_track(1.3, 48000, seed=len(kind))
    left, right = flacbits.dfpwm_encode_rows(x >> 8, np.zeros((3, 2), np.int32))[0]
    return "mdfpwm", tracks.fixtures().mdfpwm_file(left.tobytes(), right[:6000].tobytes(),
                                                   12000)


def assert_scan_close(got: np.ndarray, want: np.ndarray, scale: float = 1.0):
    if STRICT:
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=SCAN_ATOL * scale)
    assert (got == want).mean() >= SCAN_EQUAL_FRAC


@pytest.mark.parametrize("kind", KINDS)
def test_auplay_chain_matches_jax(kind):
    loader, raw = make_file(kind)
    args = (1, 48000) if loader == "dfpwm" else ()
    t = getattr(tk, loader)(raw, *args, device="cpu")
    j = getattr(ak, loader)(raw, *args)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.data))
    rate = t.sample_rate
    t, j = t.resample(48000), j.resample(48000)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.data))
    t, j = t.mono(), j.mono()
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.data))
    fx.normalize(t, 0.8)
    jfx.normalize(j, 0.8)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.data))
    fx.lowpass(t, rate / 2)
    jfx.lowpass(j, rate / 2)
    assert_scan_close(t.numpy(), np.asarray(j.data))
    it, length = t.stream(48000)
    jit, jlength = j.stream(48000)
    assert length == jlength
    chunks = 0
    for (g, gp), (w, wp) in zip(it, jit, strict=True):
        assert gp == wp and g.shape == w.shape
        assert_scan_close(g, w, scale=128)
        chunks += 1
    assert chunks == -(-t.num_samples // 48000)


def test_effects_chain_config5_matches_jax():
    rng = np.random.default_rng(5)
    x = ((rng.random((8, 22050)) * 2 - 1) * 0.5).astype(np.float32)
    t, j = tk.new_audio(x, 44100, device="cpu"), ak.new_audio(x, 44100)
    fx.normalize(t, 0.9)
    jfx.normalize(j, 0.9)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.data))
    t, j = t.mono(), j.mono()
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.data))
    fx.lowpass(t, 12000)
    jfx.lowpass(j, 12000)
    assert_scan_close(t.numpy(), np.asarray(j.data))
    t = tk.new_audio(np.asarray(j.data), 44100, device="cpu")
    t, j = t.resample(48000, "cubic"), j.resample(48000, "cubic")
    assert t.num_samples == j.num_samples == 24000
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.data))


@pytest.mark.parametrize("case", KINDS + ["config5"])
def test_chain_bit_equal_given_jax_scan(case, monkeypatch):
    """The chains with the port's ``linear_scan`` swapped for the jitted
    ``_affine_scan`` of the same (A, B): the lowpass and every streamed
    chunk bit-equal to the JAX chain's."""
    monkeypatch.setattr(fx, "_linear_scan", lambda A, B: torch.from_numpy(
        np.array(jfx._affine_scan(A.numpy(), B.numpy()))))
    monkeypatch.setitem(globals(), "STRICT", True)
    if case == "config5":
        test_effects_chain_config5_matches_jax()
    else:
        test_auplay_chain_matches_jax(case)
