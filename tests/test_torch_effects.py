"""aukit_tpu_torch's effects against the JAX package (twins of
tests/test_effects.py): each effect on the same seeded audio through the JAX
effect (its jitted scans jitted, its eager arithmetic eager, as the package
runs them) and through the port on the CPU, and both against the loop
oracles of tests/ref/effects.py at the JAX tests' own tolerances.

Tolerances against the JAX package:
 - bit-equal: amplify, speed, fade, invert, normalize, trim, delay, echo,
   reverb (the feedback and allpass multiply-adds fused where XLA fuses
   them, the eager arithmetic rounded op by op);
 - ``center``: the one-second means are sums whose order differs (XLA's
   reduce against the port's halving tree): within 2e-6 (largest
   difference seen 3.0e-8);
 - ``lowpass``/``highpass``: the scan's rounding residue (ROADMAP queue 3):
   every output within 1.2e-7 and at least ``SCAN_EQUAL_FRAC`` of them
   bit-equal (99.19% to 99.67% over six seeds at the tests' 2 x 6000 shape,
   poles 0.456 and 0.560, largest difference 6.0e-8), and within 5e-6 of
   the loop oracle, the JAX tests' own bound. The share falls as the pole
   nears 1, because an output one ulp off carries into the outputs after
   it: on one seed at 2 x 6000 the port's scan gives the jitted JAX scan's
   bits on 99.96% of outputs at pole 0.05, 99.65% at 0.456, 95.8% at 0.9
   and 77.6% at 0.99. The lowpasses of auplay and of bench.py config 5
   (poles 0.056 and 0.181) keep 99.96% or more, and
   tests/test_torch_auplay.py holds them to 99.8%.

The residue lies in the scan alone: ``test_scan_bit_equal_given_jax_scan``
runs each filter with the port's ``linear_scan`` swapped for the JAX
package's jitted ``_affine_scan`` on the same full ``A`` and ``B``, and the
output is bit-equal to the JAX effect's; ``test_scan_full_a_equals_broadcast_a``
shows that the full ``A`` gives the engine's scan over a broadcast ``A``
bit for bit.
"""

import numpy as np
import pytest
import torch

import aukit_tpu as ak
import aukit_tpu_torch as tk
from aukit_tpu import effects as jfx
from aukit_tpu_torch import effects as fx
from aukit_tpu_torch.ops.scan import linear_scan
from tests.ref import effects as ref

RNG = np.random.default_rng(31)
SCAN_ATOL = 1.2e-7
SCAN_EQUAL_FRAC = 0.985
REDUCTION_ATOL = 2e-6


def make_audio(channels=2, n=4000, rate=2000, scale=0.6):
    """(port Audio on the CPU, JAX Audio, the oracle's lists) of one seeded
    signal."""
    d = ((RNG.random((channels, n)) * 2 - 1) * scale).astype(np.float32)
    return (tk.new_audio(d.copy(), rate, device="cpu"), ak.new_audio(d.copy(), rate),
            [list(map(float, row)) for row in d])


def assert_close(audio, chans, atol=2e-6):
    exp = np.array(chans, np.float64).astype(np.float32)
    np.testing.assert_allclose(audio.numpy(), exp, rtol=0, atol=atol)


def assert_twin(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.data))


def assert_scan_twin(got, want):
    g, w = got.numpy(), np.asarray(want.data)
    np.testing.assert_allclose(g, w, rtol=0, atol=SCAN_ATOL)
    assert (g.view(np.int32) == w.view(np.int32)).mean() >= SCAN_EQUAL_FRAC


def test_amplify():
    a, j, chans = make_audio()
    assert fx.amplify(a, 1.7) is a
    jfx.amplify(j, 1.7)
    assert_close(a, ref.amplify_ref(chans, 1.7))
    assert_twin(a, j)


def test_amplify_identity_inplace_contract():
    a, _, _ = make_audio()
    before = a.numpy().copy()
    data = a.data
    out = fx.amplify(a, 1)
    assert out is a and a.data is data
    np.testing.assert_array_equal(out.numpy(), before)


def test_fade():
    a, j, chans = make_audio(rate=1000)
    fx.fade(a, 1, 1.0, 3, 0.25)
    jfx.fade(j, 1, 1.0, 3, 0.25)
    assert_close(a, ref.fade_ref(chans, 1000, 1, 1.0, 3, 0.25))
    assert_twin(a, j)
    # a range that clamps into the samples, and one that ends before it starts
    for args in ((0, 0.2, 9, 1.5), (3.5, 0.5, 3.2, 0.1)):
        a, j, _ = make_audio(rate=1000)
        fx.fade(a, *args)
        jfx.fade(j, *args)
        assert_twin(a, j)


def test_invert():
    a, j, chans = make_audio()
    fx.invert(a)
    jfx.invert(j)
    assert_close(a, [[-v for v in ch] for ch in chans])
    assert_twin(a, j)


@pytest.mark.parametrize("independent", [False, True])
def test_normalize(independent):
    a, j, chans = make_audio()
    fx.normalize(a, 0.9, independent)
    jfx.normalize(j, 0.9, independent)
    assert_close(a, ref.normalize_ref(chans, 0.9, independent))
    assert_twin(a, j)


def test_normalize_silence_no_nan():
    a = tk.new(0.01, 1, 48000, device="cpu")
    fx.normalize(a, 1.0)
    assert np.isfinite(a.numpy()).all()
    d = np.zeros((2, 300), np.float32)
    d[1] = np.linspace(-0.3, 0.2, 300)
    a, j = tk.new_audio(d, 8000, device="cpu"), ak.new_audio(d, 8000)
    fx.normalize(a, 0.8, True)
    jfx.normalize(j, 0.8, True)
    assert_twin(a, j)


def test_center():
    """Against the oracle at the JAX test's 2e-6, and against the JAX
    package within 2e-6: the one-second means are sums in another order."""
    a, j, chans = make_audio(n=5500, rate=2000)
    fx.center(a)
    jfx.center(j)
    assert_close(a, ref.center_ref(chans, 2000))
    np.testing.assert_allclose(a.numpy(), np.asarray(j.data), rtol=0, atol=REDUCTION_ATOL)


def test_trim():
    data = np.zeros((1, 1000), np.float32)
    data[0, 100:900] = 0.5
    a, j = tk.new_audio(data, 48000, device="cpu"), ak.new_audio(data, 48000)
    fx.trim(a)
    jfx.trim(j)
    assert a.num_samples == 800
    assert_twin(a, j)
    silent = tk.new(0.01, 2, 8000, device="cpu")
    assert fx.trim(silent).num_samples == 0


def test_delay():
    a, j, chans = make_audio(rate=1000)
    fx.delay(a, 0.5, 0.4)
    jfx.delay(j, 0.5, 0.4)
    assert_close(a, ref.delay_ref(chans, 1000, 0.5, 0.4))
    assert_twin(a, j)


def test_echo():
    """The block feedback: 16 lag-sized blocks, the last one partial."""
    a, j, chans = make_audio(rate=1000)
    fx.echo(a, 0.25, 0.6)
    jfx.echo(j, 0.25, 0.6)
    assert_close(a, ref.echo_ref(chans, 1000, 0.25, 0.6))
    assert_twin(a, j)


def test_lowpass():
    a, j, chans = make_audio(rate=8000, n=6000)
    fx.lowpass(a, 1000)
    jfx.lowpass(j, 1000)
    assert_close(a, ref.lowpass_ref(chans, 8000, 1000), atol=5e-6)
    assert_scan_twin(a, j)


def test_highpass():
    a, j, chans = make_audio(rate=8000, n=6000)
    fx.highpass(a, 1000)
    jfx.highpass(j, 1000)
    assert_close(a, ref.highpass_ref(chans, 8000, 1000), atol=5e-6)
    assert_scan_twin(a, j)


@pytest.mark.parametrize("effect", ["lowpass", "highpass"])
@pytest.mark.parametrize("cutoff", [20, 100, 500])
def test_low_cutoff_within_loop_oracle(effect, cutoff):
    """Low cutoffs put the pole near 1, where the scan's residue (ROADMAP
    queue 3) spreads furthest: both packages' filters on 1 s of stereo 44.1
    kHz are held to the float64 loop oracle at the JAX tests' own 5e-6.
    Measured on two seeds (CPU): |JAX - port| at most 3.0e-8 (lowpass 20
    Hz), 7.5e-9 (100 Hz), 1.5e-8 (500 Hz); highpass 7.8e-7, 3.6e-7, 1.8e-7;
    bit-equal shares 69-70%, 83%, 97% (lowpass) and 37-40%, 66%, 94%
    (highpass); each package within 1.2e-6 of the oracle."""
    rng = np.random.default_rng(cutoff)
    d = ((rng.random((2, 44100)) * 2 - 1) * 0.6).astype(np.float32)
    a, j = tk.new_audio(d.copy(), 44100, device="cpu"), ak.new_audio(d.copy(), 44100)
    getattr(fx, effect)(a, cutoff)
    getattr(jfx, effect)(j, cutoff)
    oracle = getattr(ref, f"{effect}_ref")([list(map(float, row)) for row in d], 44100, cutoff)
    assert_close(a, oracle, atol=5e-6)
    assert_close(tk.new_audio(np.asarray(j.data), 44100, device="cpu"), oracle, atol=5e-6)


def jax_scan(A, B):
    """The JAX package's jitted scan on the port's tensors."""
    return torch.from_numpy(np.array(jfx._affine_scan(A.numpy(), B.numpy())))


@pytest.mark.parametrize("effect", ["lowpass", "highpass"])
def test_scan_bit_equal_given_jax_scan(effect, monkeypatch):
    """The witness for the scan's residue: with the port's ``linear_scan``
    swapped for the jitted ``_affine_scan`` on the same full (A, B), the
    effect is bit-equal to the JAX effect. The coefficients, A, B and the
    first column add no residue."""
    a, j, _ = make_audio(rate=8000, n=6000)
    monkeypatch.setattr(fx, "_linear_scan", jax_scan)
    getattr(fx, effect)(a, 1000)
    getattr(jfx, effect)(j, 1000)
    assert_twin(a, j)


@pytest.mark.parametrize("pole", [0.05, 0.456, 0.99])
def test_scan_full_a_equals_broadcast_a(pole):
    """The effects' scan over a full ``A`` (0 in its first column) gives
    the engine's scan over a broadcast ``A`` bit for bit: no output depends
    on the first column's ``A``."""
    d = torch.from_numpy(((RNG.random((2, 6000)) * 2 - 1) * 0.6).astype(np.float32))
    A = torch.full(d.shape, float(np.float32(pole)))
    A[:, 0] = 0.0
    B = d * float(np.float32(1 - pole))
    assert torch.equal(linear_scan(A, B), linear_scan(A[:, 1:2].expand(d.shape), B))


@pytest.mark.parametrize("rate,n", [(8000, 9000), (48000, 30000)])
def test_reverb(rate, n):
    """The four combs and both allpass passes; at 48 kHz the combs' lags are
    4237-5726 samples and the allpass lag 4284, as on a real track."""
    a, j, chans = make_audio(channels=1, n=n, rate=rate, scale=0.2)
    fx.reverb(a, 100, 0.3, 1.0, 0.0)
    jfx.reverb(j, 100, 0.3, 1.0, 0.0)
    if rate == 8000:
        assert_close(a, ref.reverb_ref(chans, 8000, 100, 0.3, 1.0, 0.0), atol=2e-5)
    assert_twin(a, j)


def test_speed():
    a, j, _ = make_audio(rate=8000, n=8000)
    before = a.num_samples
    fx.speed(a, 2.0)
    jfx.speed(j, 2.0)
    assert abs(a.num_samples - before // 2) <= 1
    assert a.sample_rate == 8000
    assert_twin(a, j)
    a, j, _ = make_audio(rate=8000, n=3000)
    fx.speed(a, 0.77)
    jfx.speed(j, 0.77)
    assert_twin(a, j)


@pytest.mark.parametrize("effect,args", [
    ("amplify", (0.3,)), ("fade", (0.1, 0.0, 0.6, 1.0)), ("invert", ()), ("normalize", (0.5,)),
    ("trim", (0.05,)), ("delay", (0.13, 0.7)), ("echo", (0.07, 0.45)),
    ("reverb", (45, 0.6, 0.7, 0.3)), ("speed", (1.25,))])
def test_effect_equals_its_jax_self_at_44k(effect, args):
    """Each effect with other arguments, on a stereo 44.1 kHz signal with
    silent ends: bit-equal to the JAX package's effect."""
    d = ((RNG.random((2, 44100)) * 2 - 1) * 0.7).astype(np.float32)
    d[:, :300] = 0
    d[:, -200:] = 0
    a, j = tk.new_audio(d, 44100, device="cpu"), ak.new_audio(d, 44100)
    getattr(fx, effect)(a, *args)
    getattr(jfx, effect)(j, *args)
    assert_twin(a, j)
