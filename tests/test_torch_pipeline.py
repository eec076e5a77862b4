"""aukit_tpu_torch resample tables, dsp_chain and decode_pipeline_scan against
the JAX package on the same numpy inputs, with the JAX functions jitted as
the JAX engine's step runs them. XLA compiles each float multiply that feeds
an add into one fused multiply-add, and the port computes those sums with
``fma_kernel``; every other float step is a separate IEEE op in the same
order in both. So float samples, int8 outputs and carried FIR states are
expected bit-equal at every rate and in every interpolation mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aukit_tpu.codecs.dfpwm import DfpwmState as JaxState
from aukit_tpu.config import get_interpolation as jax_get_interpolation
from aukit_tpu.ops import resample as jax_resample
from aukit_tpu.parallel import pipeline as jax_pipeline
from aukit_tpu_torch.codecs.dfpwm import DfpwmState
from aukit_tpu_torch.config import CONFIG, get_interpolation
from aukit_tpu_torch.ops import resample
from aukit_tpu_torch.parallel import pipeline

MODES = ("none", "linear", "cubic", "sinc")


@pytest.mark.parametrize("in_rate", [8000, 11025, 22050, 32000, 44100, 48000])
def test_tables_and_alpha_match(in_rate):
    assert pipeline.fir_alpha(in_rate, 48000) == jax_pipeline.fir_alpha(in_rate, 48000)
    want = jax_pipeline._resample_tables(in_rate // 10, in_rate, 48000)
    got = pipeline._resample_tables(in_rate // 10, in_rate, 48000)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    frac = want[2].astype(np.float64)
    np.testing.assert_array_equal(resample.sinc_weights(frac, CONFIG.sinc_window_size),
                                  jax_resample.sinc_weights(frac, CONFIG.sinc_window_size))


def test_get_interpolation_matches():
    for mode in (None, *MODES):
        assert get_interpolation(mode) == jax_get_interpolation(mode)
    with pytest.raises(ValueError):
        get_interpolation("bogus")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("in_rate", [22050, 32000])
def test_block_interp_device_matches(in_rate, mode):
    rng = np.random.default_rng(in_rate)
    x = rng.uniform(-1, 1, (3, in_rate // 20)).astype(np.float32)
    n_out, ffx, frac = jax_pipeline._resample_tables(x.shape[1], in_rate, 48000)
    w = (jax_resample.sinc_weights(frac.astype(np.float64), CONFIG.sinc_window_size)
         if mode == "sinc" else None)
    want = jax.jit(lambda e: jax_resample.block_interp_device(
        e, x.shape[1], 0, n_out, ffx.astype(np.int64), frac, frac == 0.0, mode, w))(
        jnp.asarray(x))
    got = resample.block_interp_device(torch.tensor(x), x.shape[1], 0, ffx.astype(np.int64),
                                       frac, frac == 0.0, mode, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_gain", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("in_rate", [48000, 22050, 32000])
def test_dsp_chain_matches(in_rate, mode, with_gain):
    """int8 output and the carried FIR state, from decoded-and-normalised
    DFPWM samples, with a non-zero incoming FIR state and a per-lane gain
    ramp. Expected exact: no tolerance."""
    rng = np.random.default_rng(in_rate + len(mode))
    lanes = 4
    raw = rng.integers(-128, 128, (lanes, in_rate // 20)).astype(np.int32)
    f = (raw / np.where(raw < 0, 128.0, 127.0)).astype(np.float32)
    fir = rng.uniform(-1, 1, lanes).astype(np.float32)
    gain = None
    if with_gain:
        gain = (rng.uniform(0.2, 1.8, lanes).astype(np.float32),
                (rng.uniform(-1, 1, lanes) / 2400).astype(np.float32))
    want, want_fir = jax.jit(functools.partial(jax_pipeline.dsp_chain, in_rate=in_rate,
                                               mode=mode))(
        jnp.asarray(f), fir_state=jnp.asarray(fir),
        gain=None if gain is None else tuple(map(jnp.asarray, gain)))
    got, got_fir = pipeline.dsp_chain(
        torch.tensor(f), in_rate, 48000, fir_state=torch.tensor(fir), mode=mode,
        gain=None if gain is None else tuple(map(torch.tensor, gain)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_fir.numpy(), np.asarray(want_fir))


def test_dsp_chain_without_fir_state_matches():
    rng = np.random.default_rng(5)
    f = rng.uniform(-1.2, 1.2, (2, 1600)).astype(np.float32)
    want = jax.jit(functools.partial(jax_pipeline.dsp_chain, in_rate=16000))(jnp.asarray(f))
    got = pipeline.dsp_chain(torch.tensor(f), 16000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        pipeline.dsp_chain(torch.tensor(f), 16000, mode="bogus")


@pytest.mark.parametrize("normalize_peak", [None, 0.9])
@pytest.mark.parametrize("in_rate", [48000, 16000])
def test_decode_pipeline_scan_matches(in_rate, normalize_peak):
    rng = np.random.default_rng(in_rate)
    data = rng.integers(0, 256, (3, 120), dtype=np.uint8)
    want, want_st = jax.jit(jax_pipeline.decode_pipeline_scan, static_argnums=(2, 3))(
        jnp.asarray(data), JaxState.zeros(3), in_rate, normalize_peak)
    got, got_st = pipeline.decode_pipeline_scan(
        torch.tensor(data), DfpwmState.zeros(3), in_rate, normalize_peak)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_st.lowpass.numpy(), np.asarray(want_st.lowpass))


def test_fma_matches_xla_fused_multiply_add():
    """``fma_ref`` (and ``fma_kernel`` on CPU tensors) equals a jitted JAX
    ``z + x * y``, which XLA compiles into one fused multiply-add, over
    broadcasts and a Python-float operand; the separately rounded torch ops
    differ from it."""
    from aukit_tpu_torch.kernels.fma_cuda import fma_kernel, fma_ref

    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (64, 1000)).astype(np.float32)
    y = rng.uniform(-1, 1, 1000).astype(np.float32)
    z = rng.uniform(-1, 1, (64, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: c + a * b)(x, y, z))
    calls = fma_ref.calls
    got = fma_kernel(torch.tensor(x), torch.tensor(y), torch.tensor(z))
    assert fma_ref.calls == calls + 1 and fma_kernel.launches == 0
    np.testing.assert_array_equal(got.numpy(), want)
    assert (torch.tensor(z) + torch.tensor(x) * torch.tensor(y)).numpy().tolist() != want.tolist()
    alpha = 0.7352  # a Python float is a float32 constant, as in JAX
    want = np.asarray(jax.jit(lambda a, c: c + jnp.float32(alpha) * a)(x, z))
    np.testing.assert_array_equal(fma_ref(alpha, torch.tensor(x), torch.tensor(z)).numpy(), want)
    with pytest.raises(ValueError):
        fma_kernel(torch.tensor(x).double(), torch.tensor(y), torch.tensor(z))
