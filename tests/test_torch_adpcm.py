"""aukit_tpu_torch IMA and MS ADPCM decode loops and kernel wrappers against
the JAX package: the same numpy inputs go through the JAX scans, the Pallas
kernels (interpret mode, as the JAX package's own tests run them on the CPU)
and the port's plain versions; outputs and final states must be bit-equal."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aukit_tpu.codecs.adpcm import IMA_STEP_TABLE as JAX_IMA_STEP_TABLE
from aukit_tpu.codecs.adpcm import MSADPCM_ADAPTION as JAX_MSADPCM_ADAPTION
from aukit_tpu.codecs.adpcm import MSADPCM_DEFAULT_COEFFS as JAX_COEFFS
from aukit_tpu.codecs.adpcm import ima_adpcm_scan, msadpcm_scan
from aukit_tpu.kernels.ima_pallas import ima_decode_pallas
from aukit_tpu.kernels.msadpcm_pallas import msadpcm_decode_pallas
from aukit_tpu_torch.codecs import adpcm
from aukit_tpu_torch.interop import kernel_state_from_numpy, kernel_state_to_numpy
from aukit_tpu_torch.kernels.adpcm_cuda import (ima_decode_kernel, ima_decode_ref,
                                                msadpcm_decode_kernel, msadpcm_decode_ref)
from tests import torch_kernel_cases as kernel_cases

MSADPCM_CASES = [c[0] for c in kernel_cases.msadpcm_cases("cpu")]
IMA_CASES = [c[0] for c in kernel_cases.ima_cases("cpu")]


def t(a, dtype=None):
    return torch.tensor(np.asarray(a) if dtype is None else np.asarray(a, dtype))


def assert_state_equal(got, *wants):
    got = kernel_state_to_numpy(got)
    for want in wants:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_tables_match_jax():
    np.testing.assert_array_equal(adpcm.IMA_STEP_TABLE, JAX_IMA_STEP_TABLE)
    np.testing.assert_array_equal(adpcm.MSADPCM_ADAPTION, JAX_MSADPCM_ADAPTION)
    for a, b in zip(adpcm.MSADPCM_DEFAULT_COEFFS, JAX_COEFFS):
        np.testing.assert_array_equal(a, b)


def test_msadpcm_arithmetic_adaption_equals_table():
    nib = torch.arange(-8, 8, dtype=torch.int32)
    np.testing.assert_array_equal(adpcm._adapt(nib).numpy(), adpcm.MSADPCM_ADAPTION)


@pytest.mark.parametrize("lanes,T", [(7, 77), (3, 130)])
def test_ima_plain_matches_scan_and_pallas(lanes, T):
    """Ragged T (no tile multiple), random valid state: outputs and final
    (predictor, step_index) equal ``ima_adpcm_scan`` and the Pallas kernel."""
    rng = np.random.default_rng(lanes)
    nibs = rng.integers(0, 16, (lanes, T)).astype(np.uint8)
    pred = rng.integers(-30000, 30000, lanes).astype(np.int32)
    sidx = rng.integers(0, 89, lanes).astype(np.int32)
    got, st = ima_decode_ref(t(nibs), *kernel_state_from_numpy([pred, sidx]))
    assert got.dtype == torch.int16 and tuple(got.shape) == (lanes, T)
    ref, ref_st = ima_adpcm_scan(jnp.asarray(nibs, jnp.int32), jnp.asarray(pred),
                                 jnp.asarray(sidx))
    pal, pal_st = ima_decode_pallas(nibs, pred, sidx, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))
    assert_state_equal(st, ref_st, pal_st)


def test_ima_plain_chained_calls_equal_one_call():
    rng = np.random.default_rng(8)
    nibs = t(rng.integers(0, 16, (4, 90)).astype(np.uint8))
    pred, sidx = kernel_state_from_numpy([rng.integers(-900, 900, 4), rng.integers(0, 89, 4)])
    whole, st = ima_decode_ref(nibs, pred, sidx)
    a, mid = ima_decode_ref(nibs[:, :41].contiguous(), pred, sidx)
    b, end = ima_decode_ref(nibs[:, 41:].contiguous(), *mid)
    torch.testing.assert_close(torch.cat([a, b], dim=1), whole, rtol=0, atol=0)
    assert_state_equal(end, kernel_state_to_numpy(st))


def test_ima_out_of_range_step_index_defined():
    """The Pallas kernel clamps its step-table LOOKUP while the raw index
    feeds the index update for one step; the port follows it and the numpy
    replica of tests/test_pallas_kernels.py (not ``jnp.take``'s rule)."""
    rng = np.random.default_rng(29)
    lanes, T = 5, 96
    nib = rng.integers(0, 16, (lanes, T)).astype(np.int32)
    pred0 = np.zeros(lanes, np.int32)
    sidx_bad = np.array([0, 89, 127, 200, -3], np.int32)
    exp = np.empty((lanes, T), np.int32)
    for lane in range(lanes):
        p, s = int(pred0[lane]), int(sidx_bad[lane])
        for i in range(T):
            n = int(nib[lane, i])
            step = int(JAX_IMA_STEP_TABLE[min(max(s, 0), 88)])
            m = n & 7
            s = min(max(s + (-1 if m < 4 else (m - 3) * 2), 0), 88)
            diff = ((m * step) >> 2) + (step >> 3)
            p = min(max(p - diff if n >= 8 else p + diff, -32768), 32767)
            exp[lane, i] = p
    pal, _ = ima_decode_pallas(nib, pred0, sidx_bad, interpret=True)
    got, _ = ima_decode_ref(t(nib, np.uint8), t(pred0), t(sidx_bad))
    np.testing.assert_array_equal(np.asarray(pal), exp)
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("name", IMA_CASES)
def test_ima_kernel_cases_plain_matches_scan_and_pallas(name):
    """The cases that hold the CUDA kernel to its plain version on the card
    (tests/torch_kernel_cases.py) hold the plain version to the JAX scan and
    the Pallas kernel (interpret mode) here: chained calls, samples and
    final state bit-equal; each case has the indices 0 and 88 and the
    predictors -32768 and 32767, and the wider ones the out-of-range
    indices. Lanes that enter a call with such an index, or whose row holds
    bytes above 15, are held to the Pallas kernel alone: the scan looks the
    step and the index delta up by ``jnp.take``'s rule (see
    ``test_ima_out_of_range_step_index_defined``)."""
    _, calls, (pred, sidx) = next(c for c in kernel_cases.ima_cases("cpu") if c[0] == name)
    assert {0, 88} <= set(sidx.tolist()) and {-32768, 32767} <= set(pred.tolist())
    if len(pred) > 35:
        assert set(kernel_cases.IMA_WILD_INDICES) <= set(sidx.tolist())
    if len(pred) > 5:
        assert any(bool((nibs > 15).any()) for nibs in calls)
    st, pal_st = (pred, sidx), (pred.numpy(), sidx.numpy())
    for nibs in calls:
        in_range = (pal_st[1] >= 0) & (pal_st[1] <= 88) & (nibs.numpy() <= 15).all(axis=1)
        got, st = ima_decode_ref(nibs, *st)
        ref, ref_st = ima_adpcm_scan(jnp.asarray(nibs.numpy(), jnp.int32),
                                     jnp.asarray(pal_st[0]), jnp.asarray(pal_st[1]))
        pal, pal_st = ima_decode_pallas(nibs.numpy(), *pal_st, interpret=True)
        pal_st = tuple(np.asarray(a) for a in pal_st)
        np.testing.assert_array_equal(got.numpy()[in_range], np.asarray(ref)[in_range])
        np.testing.assert_array_equal(got.numpy(), np.asarray(pal))
        assert_state_equal(st, pal_st)
        for g, w in zip(kernel_state_to_numpy(st), ref_st):
            np.testing.assert_array_equal(g[in_range], np.asarray(w)[in_range])


@pytest.mark.parametrize("lanes,T", [(9, 70), (4, 131)])
def test_msadpcm_plain_matches_scan_and_pallas(lanes, T):
    """Negative header deltas (used raw for the first sample), every
    predictor-coefficient pair, ragged T; outputs and final (sample1,
    sample2, delta) equal ``msadpcm_scan`` and the Pallas kernel."""
    rng = np.random.default_rng(lanes)
    nibs = rng.integers(-8, 8, (lanes, T)).astype(np.int8)
    s1 = rng.integers(-2000, 2000, lanes).astype(np.int32)
    s2 = rng.integers(-2000, 2000, lanes).astype(np.int32)
    delta = rng.integers(-400, 400, lanes).astype(np.int32)
    pidx = np.arange(lanes) % 7
    c1, c2 = JAX_COEFFS[0][pidx], JAX_COEFFS[1][pidx]
    got, st = msadpcm_decode_ref(t(nibs), *kernel_state_from_numpy([s1, s2, delta]),
                                 t(c1), t(c2))
    assert got.dtype == torch.int16 and tuple(got.shape) == (lanes, T)
    ref = msadpcm_scan(jnp.asarray(nibs, jnp.int32), jnp.asarray(c1), jnp.asarray(c2),
                       jnp.asarray(delta), jnp.asarray(s1), jnp.asarray(s2))
    pal, pal_st = msadpcm_decode_pallas(nibs, s1, s2, delta, c1, c2, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))
    assert_state_equal(st, pal_st)


@pytest.mark.parametrize("name", MSADPCM_CASES)
def test_msadpcm_kernel_cases_plain_matches_scan_and_pallas(name):
    """The cases that hold the CUDA kernel to its plain version on the card
    (tests/torch_kernel_cases.py) hold the plain version to the JAX scan and
    the Pallas kernel (interpret mode) here: chained calls, samples and
    final state bit-equal; each case has deltas negative, at the cap and at
    the floor, and nibble -8."""
    _, calls, st, (c1, c2) = next(c for c in kernel_cases.msadpcm_cases("cpu") if c[0] == name)
    delta0 = st[2].numpy()
    assert (delta0 < 0).any() and (delta0 == 1 << 20).any() and (delta0 == 16).any()
    assert int(calls[0].min()) == -8 and int(calls[0].max()) == 7
    c1, c2 = c1.numpy(), c2.numpy()
    pal_st = tuple(a.numpy() for a in st)
    for nibs in calls:
        got, st = msadpcm_decode_ref(nibs, *st, t(c1), t(c2))
        s1, s2, delta = pal_st
        ref = msadpcm_scan(jnp.asarray(nibs.numpy(), jnp.int32), jnp.asarray(c1), jnp.asarray(c2),
                           jnp.asarray(delta), jnp.asarray(s1), jnp.asarray(s2))
        pal, pal_st = msadpcm_decode_pallas(nibs.numpy(), s1, s2, delta, c1, c2, interpret=True)
        pal_st = tuple(np.asarray(a) for a in pal_st)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got.numpy(), np.asarray(pal))
        assert_state_equal(st, pal_st)


def test_cuda_source_adaption_table_equals_jax_adapt_for_every_nibble():
    """The CUDA kernel looks its adaption factor up by ``nib & 15`` in a
    16-entry table (``MS_ADAPT`` in csrc/adpcm.cu): for every signed nibble
    the entry equals the Pallas kernel's arithmetic ``_adapt``."""
    from aukit_tpu.kernels.msadpcm_pallas import _adapt

    src = Path(adpcm.__file__).parent.parent / "csrc" / "adpcm.cu"
    body = re.search(r"MS_ADAPT\[16\] = \{([^}]*)\}", src.read_text()).group(1)
    table = np.array([int(v) for v in body.split(",")], np.int32)
    assert table.shape == (16,)
    nib = np.arange(-8, 8, dtype=np.int32)
    want = _adapt(jnp.asarray(nib), jnp.abs(jnp.asarray(nib)))
    np.testing.assert_array_equal(table[nib & 15], np.asarray(want))
    np.testing.assert_array_equal(table[nib & 15], adpcm._adapt(torch.tensor(nib)).numpy())


def test_wrappers_take_the_plain_versions_on_cpu():
    rng = np.random.default_rng(3)
    nibs = t(rng.integers(0, 16, (5, 40)).astype(np.uint8))
    pred, sidx = t(rng.integers(-100, 100, 5), np.int32), t(rng.integers(0, 89, 5), np.int32)
    launches, calls = ima_decode_kernel.launches, ima_decode_ref.calls
    got, st = ima_decode_kernel(nibs, pred, sidx)
    want, want_st = ima_decode_ref(nibs, pred, sidx)
    assert (ima_decode_kernel.launches, ima_decode_ref.calls) == (launches, calls + 2)
    assert torch.equal(got, want)
    assert_state_equal(st, kernel_state_to_numpy(want_st))

    snibs = t(rng.integers(-8, 8, (5, 40)).astype(np.int8))
    state = [t(rng.integers(-100, 100, 5), np.int32) for _ in range(3)]
    coefs = [t(np.full(5, 256), np.int32), t(np.zeros(5), np.int32)]
    launches, calls = msadpcm_decode_kernel.launches, msadpcm_decode_ref.calls
    got, st = msadpcm_decode_kernel(snibs, *state, *coefs)
    want, want_st = msadpcm_decode_ref(snibs, *state, *coefs)
    assert (msadpcm_decode_kernel.launches, msadpcm_decode_ref.calls) == (launches, calls + 2)
    assert torch.equal(got, want)
    assert_state_equal(st, kernel_state_to_numpy(want_st))


def test_wrappers_reject_bad_arguments():
    lane = torch.zeros(4, dtype=torch.int32)
    for call in (
        lambda: ima_decode_kernel(torch.zeros((4, 8), dtype=torch.int32), lane, lane),
        lambda: ima_decode_kernel(torch.zeros(8, dtype=torch.uint8), lane, lane),
        lambda: ima_decode_kernel(torch.zeros((4, 8), dtype=torch.uint8), lane[:3], lane),
        lambda: ima_decode_kernel(torch.zeros((4, 8), dtype=torch.uint8), lane,
                                  lane.to(torch.int64)),
        lambda: msadpcm_decode_kernel(torch.zeros((4, 8), dtype=torch.uint8), *[lane] * 5),
        lambda: msadpcm_decode_kernel(torch.zeros((4, 8), dtype=torch.int8), *[lane] * 4,
                                      torch.zeros((4, 2), dtype=torch.int32)),
    ):
        with pytest.raises(ValueError):
            call()
