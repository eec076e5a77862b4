"""aukit_tpu_torch QOA LMS loop, dequant lookup and kernel wrapper against
the JAX package: the same numpy inputs go through ``qoa_lms_scan``, the
Pallas kernel (interpret mode) and the port's plain version; outputs and
final states must be bit-equal, int32 wraparound included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aukit_tpu.codecs.qoa import QOA_DEQUANT as JAX_QOA_DEQUANT
from aukit_tpu.codecs.qoa import decode_qoa as jax_decode_qoa
from aukit_tpu.codecs.qoa import qoa_lms_scan
from aukit_tpu.kernels.qoa_pallas import qoa_lms_pallas
from aukit_tpu.stream.batch_codecs import _qoa_dequant_device
from aukit_tpu_torch.codecs.qoa import QOA_DEQUANT, decode_qoa, qoa_dequant
from aukit_tpu_torch.interop import kernel_state_from_numpy, kernel_state_to_numpy
from aukit_tpu_torch.kernels.qoa_cuda import qoa_lms_kernel, qoa_lms_ref
from tests import fixtures
from tests import torch_kernel_cases as kernel_cases

QOA_CASES = [c[0] for c in kernel_cases.qoa_cases("cpu")]


def assert_state_equal(got, *wants):
    got = kernel_state_to_numpy(got)
    for want in wants:
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, np.asarray(w))


def run_all(dq, hist, wts):
    """(port plain, scan, Pallas interpret) on the same inputs."""
    got = qoa_lms_ref(torch.tensor(dq.astype(np.int16)), *kernel_state_from_numpy([hist, wts]))
    ref = qoa_lms_scan(jnp.asarray(dq), jnp.asarray(hist), jnp.asarray(wts))
    pal = qoa_lms_pallas(dq, hist, wts, interpret=True)
    return got, ref, pal


@pytest.mark.parametrize("lanes,T", [(6, 137), (3, 64)])
def test_qoa_plain_matches_scan_and_pallas(lanes, T):
    rng = np.random.default_rng(lanes)
    dq = rng.integers(-14336, 14337, (lanes, T)).astype(np.int32)
    hist = rng.integers(-32768, 32768, (lanes, 4)).astype(np.int32)
    wts = rng.integers(-30000, 30000, (lanes, 4)).astype(np.int32)
    (got, st), (ref, ref_st), (pal, pal_st) = run_all(dq, hist, wts)
    assert got.dtype == torch.int16 and tuple(got.shape) == (lanes, T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))
    assert_state_equal(st, ref_st, pal_st)


def test_qoa_plain_weight_wraparound():
    """The predictor sum and the weights wrap int32 (the reference's bit32
    coercion): the state of tests/test_pallas_kernels.py that overflows."""
    lanes, T = 2, 96
    dq = np.full((lanes, T), 14336, np.int32)
    dq[:, ::2] = -14336
    hist = np.full((lanes, 4), 32767, np.int32)
    wts = np.full((lanes, 4), 2_000_000_00, np.int32)
    (got, st), (ref, ref_st), (pal, pal_st) = run_all(dq, hist, wts)
    # the case does wrap: an unwrapped int64 sum of the first step differs
    assert int((hist[0].astype(np.int64) * wts[0]).sum()) >= 1 << 31
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))
    assert_state_equal(st, ref_st, pal_st)


@pytest.mark.parametrize("name", QOA_CASES)
def test_qoa_kernel_cases_plain_matches_scan_and_pallas(name):
    """The cases that hold the CUDA kernel to its plain version on the card
    (tests/torch_kernel_cases.py) hold the plain version to the JAX scan and
    the Pallas kernel (interpret mode) here: chained calls, samples and
    final state bit-equal."""
    _, calls, st = next(c for c in kernel_cases.qoa_cases("cpu") if c[0] == name)
    ref_st = pal_st = tuple(jnp.asarray(a.numpy()) for a in st)
    wrapped = False
    for dq in calls:
        got, st = qoa_lms_ref(dq, *st)
        x = dq.numpy().astype(np.int32)
        hist, wts = (np.asarray(a, np.int64) for a in ref_st)
        wrapped |= bool((np.abs((hist * wts).sum(1)) >= 1 << 31).any())
        ref, ref_st = qoa_lms_scan(jnp.asarray(x), *ref_st)
        pal, pal_st = qoa_lms_pallas(x, *(np.asarray(a) for a in pal_st), interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got.numpy(), np.asarray(pal))
        assert_state_equal(st, ref_st, pal_st)
    assert wrapped, "the case's state wraps int32"
    assert {int(calls[0].min()), int(calls[0].max())} == {-14336, 14336}


def test_qoa_dequant_lookup_matches_jax_device_dequant():
    """The port's plain table lookup equals, for every (scalefactor,
    residual), JAX's gather-free ``_qoa_dequant_device`` and the table."""
    np.testing.assert_array_equal(QOA_DEQUANT, JAX_QOA_DEQUANT)
    sf, res = np.meshgrid(np.arange(16), np.arange(8), indexing="ij")
    got = qoa_dequant(torch.tensor(sf, dtype=torch.uint8), torch.tensor(res, dtype=torch.uint8))
    assert got.dtype == torch.int16
    want = jax.jit(_qoa_dequant_device)(jnp.asarray(np.arange(16, dtype=np.int32)),
                                        jnp.asarray(res.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), JAX_QOA_DEQUANT)


def test_wrapper_takes_the_plain_version_on_cpu_and_checks_arguments():
    rng = np.random.default_rng(5)
    dq = torch.tensor(rng.integers(-3000, 3000, (3, 50)).astype(np.int16))
    hist, wts = (torch.tensor(rng.integers(-500, 500, (3, 4)).astype(np.int32))
                 for _ in range(2))
    launches, calls = qoa_lms_kernel.launches, qoa_lms_ref.calls
    got, st = qoa_lms_kernel(dq, hist, wts)
    want, want_st = qoa_lms_ref(dq, hist, wts)
    assert (qoa_lms_kernel.launches, qoa_lms_ref.calls) == (launches, calls + 2)
    assert torch.equal(got, want)
    assert_state_equal(st, kernel_state_to_numpy(want_st))
    for call in (lambda: qoa_lms_kernel(dq.to(torch.int32), hist, wts),
                 lambda: qoa_lms_kernel(dq, hist[:, :3].contiguous(), wts),
                 lambda: qoa_lms_kernel(dq, hist, wts.t()),
                 lambda: qoa_lms_kernel(dq, hist.to(torch.int64), wts)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("channels,frames", [(1, [5120, 5120]), (2, [5120, 700]), (3, [333])])
def test_decode_qoa_native_route_is_the_fused_native_decode(channels, frames):
    """``decode_qoa(use_native=True)`` is the JAX package's native route, the
    fused ``flacbits.qoa_decode`` pass, bit for bit, on the fixtures' QOA
    streams (a short final frame included); no kernel runs; and the kernel
    route (kernel (f)'s plain version here) gives the same samples."""
    raw = fixtures.qoa_stream(np.random.default_rng(17 + channels), channels, 44100, frames)
    calls = qoa_lms_ref.calls
    got = decode_qoa(raw, use_native=True, device="cpu")
    assert qoa_lms_ref.calls == calls
    want = jax_decode_qoa(raw, use_native=True)
    assert got[0].dtype == want[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], decode_qoa(raw, use_native=False, device="cpu")[0])
