"""aukit_tpu_torch DFPWM codec and kernel plain versions against the JAX
package: the same numpy inputs go through both, outputs and state must be
bit-equal. The JAX Pallas kernels run in interpret mode, as the JAX
package's own tests run them on the CPU."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aukit_tpu.codecs.dfpwm import DfpwmState as JaxState
from aukit_tpu.codecs.dfpwm import decode_dfpwm_bytes as jax_decode_bytes
from aukit_tpu.codecs.dfpwm import dfpwm_decode as jax_decode
from aukit_tpu.codecs.dfpwm import dfpwm_encode as jax_encode
from aukit_tpu.codecs.dfpwm import encode_dfpwm_bytes as jax_encode_bytes
from aukit_tpu.kernels import dfpwm_pallas as kp
from aukit_tpu_torch.codecs.dfpwm import (DfpwmState, decode_dfpwm_bytes, dfpwm_decode,
                                          dfpwm_encode, encode_dfpwm_bytes)
from tests import torch_kernel_cases as kernel_cases
from aukit_tpu_torch.interop import dfpwm_state_from_numpy, dfpwm_state_to_numpy
from aukit_tpu_torch.kernels.dfpwm_cuda import (dfpwm_decode_dsp_kernel, dfpwm_decode_dsp_ref,
                                                dfpwm_decode_kernel, dfpwm_decode_ref)

GOLDEN = np.load(Path(__file__).parent / "golden" / "golden.npz")
ALPHA_48K = float(1.0 - np.exp(-0.5 * 2.0 * np.pi))


def random_state(rng, lanes):
    """Five int32 leaves of a valid mid-stream decoder state."""
    return [rng.integers(-128, 128, lanes).astype(np.int32),
            rng.integers(8, 1024, lanes).astype(np.int32),
            rng.integers(0, 2, lanes).astype(np.int32),
            rng.integers(-128, 128, lanes).astype(np.int32),
            rng.integers(-128, 128, lanes).astype(np.int32)]


def assert_state_equal(jax_state, port_state):
    for want, got in zip(jax.tree_util.tree_leaves(jax_state), dfpwm_state_to_numpy(port_state)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_decode_matches_jax_scan():
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (6, 150), dtype=np.uint8)
    st = random_state(rng, 6)
    want, want_st = jax_decode(jnp.asarray(data), JaxState(*map(jnp.asarray, st)))
    got, got_st = dfpwm_decode(torch.tensor(data), dfpwm_state_from_numpy(st))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_state_equal(want_st, got_st)


def test_encode_matches_jax_scan():
    rng = np.random.default_rng(12)
    levels = rng.integers(-128, 128, (5, 640)).astype(np.int32)
    st = random_state(rng, 5)
    want, want_st = jax_encode(jnp.asarray(levels), JaxState(*map(jnp.asarray, st)))
    got, got_st = dfpwm_encode(torch.tensor(levels), dfpwm_state_from_numpy(st))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_state_equal(want_st, got_st)


def test_golden_vectors():
    out, _ = decode_dfpwm_bytes(GOLDEN["dfpwm_in"].tobytes(), device="cpu")
    np.testing.assert_array_equal(out, GOLDEN["dfpwm_out"])
    enc, _ = encode_dfpwm_bytes(GOLDEN["dfpwm_enc_in"], device="cpu")
    assert enc == GOLDEN["dfpwm_enc_out"].tobytes()


@pytest.mark.parametrize("split", [1, 37, 199])
def test_decode_chained_chunks_equal_one_call(split):
    rng = np.random.default_rng(13)
    data = torch.tensor(rng.integers(0, 256, (3, 200), dtype=np.uint8))
    whole, whole_st = dfpwm_decode(data, DfpwmState.zeros(3))
    a, st = dfpwm_decode(data[:, :split].contiguous(), DfpwmState.zeros(3))
    b, st = dfpwm_decode(data[:, split:].contiguous(), st)
    assert torch.equal(torch.cat([a, b], dim=1), whole)
    for x, y in zip(st.leaves(), whole_st.leaves()):
        assert torch.equal(x, y)


def test_host_byte_paths_match_jax():
    rng = np.random.default_rng(14)
    data = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    want, want_st = jax_decode_bytes(data)
    got, got_st = decode_dfpwm_bytes(data, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert_state_equal(want_st, got_st)
    levels = rng.integers(-128, 128, 803)  # truncated to whole bytes
    want_b, want_st = jax_encode_bytes(levels)
    got_b, got_st = encode_dfpwm_bytes(levels, device="cpu")
    assert got_b == want_b
    assert_state_equal(want_st, got_st)


def test_decode_ref_matches_pallas_interpret():
    rng = np.random.default_rng(15)
    data = rng.integers(0, 256, (5, 130), dtype=np.uint8)
    st = random_state(rng, 5)
    want, want_st = kp.dfpwm_decode_pallas(data, JaxState(*map(jnp.asarray, st)), interpret=True)
    got, got_st = dfpwm_decode_kernel(torch.tensor(data), dfpwm_state_from_numpy(st))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_state_equal(want_st, got_st)


@pytest.mark.parametrize("with_gain", [False, True])
def test_decode_dsp_ref_matches_pallas_interpret(with_gain):
    """The fused epilogue's plain version against dfpwm_decode_dsp_pallas over
    two chained calls, with a lane mask, a gain ramp and a non-zero incoming
    state: int8 outputs and state bit-equal."""
    rng = np.random.default_rng(16 + with_gain)
    lanes = 6
    st_np = random_state(rng, lanes)
    jst, pst = JaxState(*map(jnp.asarray, st_np)), dfpwm_state_from_numpy(st_np)
    for call in range(2):
        data = rng.integers(0, 256, (lanes, 96), dtype=np.uint8)
        mask = rng.integers(0, 2, lanes).astype(bool)
        gain = None
        if with_gain:
            gain = (rng.uniform(0.2, 1.8, lanes).astype(np.float32),
                    (rng.uniform(-1, 1, lanes) / 768).astype(np.float32))
        want, jst = kp.dfpwm_decode_dsp_pallas(data, jst, ALPHA_48K, mask=mask, gain=gain,
                                               interpret=True)
        got, pst = dfpwm_decode_dsp_kernel(
            torch.tensor(data), pst, ALPHA_48K, mask=torch.tensor(mask),
            gain=None if gain is None else tuple(map(torch.tensor, gain)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"call {call}")
        assert_state_equal(jst, pst)


@pytest.mark.parametrize("case", ["lowpass_outside", "charge_outside", "strength_outside",
                                  "odd_bytes", "one_byte", "ramp_over_the_rails"])
def test_decode_dsp_ref_edges_match_pallas_interpret(case):
    """What the CUDA kernel's branches must equal: the plain version against
    dfpwm_decode_dsp_pallas from states whose words lie outside their ranges
    (the kernel divides there instead of looking up), with odd byte counts
    (its 4-byte stores and ragged tiles) and with a ramp that drives samples
    past both rails (its saturating conversion). int8 outputs and state
    bit-equal."""
    rng = np.random.default_rng(40)
    lanes, nbytes = 6, 40
    st_np = random_state(rng, lanes)
    gain = None
    if case == "lowpass_outside":
        st_np[4] = np.array([-100000, -4000, -129, 128, 300, 90000], np.int32)
    elif case == "charge_outside":
        st_np[0] = np.array([-90000, -129, 128, 300, 4000, 127], np.int32)
        st_np[3] = -st_np[0]
    elif case == "strength_outside":
        st_np[1] = np.array([-3, 0, 1024, 5000, 7, 1023], np.int32)
    elif case == "odd_bytes":
        nbytes = 37
    elif case == "one_byte":
        nbytes = 1
    elif case == "ramp_over_the_rails":
        gain = (np.array([300.0, -300.0, 0.5, -0.5, 2.0, 1.0], np.float32),
                np.array([-2.0, 2.0, 1.5, -1.5, 0.01, -0.01], np.float32))
    data = rng.integers(0, 256, (lanes, nbytes), dtype=np.uint8)
    data[0, :12], data[1, :12] = 0xFF, 0x00  # to the rails
    mask = np.array([True, True, False, True, True, True])
    want, jst = kp.dfpwm_decode_dsp_pallas(data, JaxState(*map(jnp.asarray, st_np)), ALPHA_48K,
                                           mask=mask, gain=gain, interpret=True)
    got, pst = dfpwm_decode_dsp_kernel(
        torch.tensor(data), dfpwm_state_from_numpy(st_np), ALPHA_48K, mask=torch.tensor(mask),
        gain=None if gain is None else tuple(map(torch.tensor, gain)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_state_equal(jst, pst)
    if case == "ramp_over_the_rails":
        assert got.min() == -128 and got.max() == 127


DSP_CASES = {name: rest for name, *rest in kernel_cases.dsp_cases("cpu")}


@pytest.mark.parametrize("name", sorted(DSP_CASES))
def test_kernel_cases_plain_versions_match_pallas_interpret(name):
    """Every case the card holds kernels (a) and (b) to (their plain
    versions there, max |error| 0), on CPU tensors through the plain
    versions and through the JAX package's Pallas kernels in interpret mode:
    int8 outputs and state bit-equal, the gains that overflow to +-inf and
    the NaN gains included (XLA's float -> int8 cast saturates and gives 0
    for NaN, as torch's clamp and cast do on the CPU)."""
    data, st, mask, gain = DSP_CASES[name]
    jst = JaxState(*(jnp.asarray(leaf.numpy()) for leaf in st.leaves()))
    data_np = data.numpy()
    want, want_st = kp.dfpwm_decode_dsp_pallas(
        data_np, jst, ALPHA_48K, mask=None if mask is None else mask.numpy(),
        gain=None if gain is None else tuple(g.numpy() for g in gain), interpret=True)
    got, got_st = dfpwm_decode_dsp_kernel(data, st, ALPHA_48K, mask=mask, gain=gain)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_state_equal(want_st, got_st)
    want, want_st = kp.dfpwm_decode_pallas(data_np, jst, interpret=True)
    got, got_st = dfpwm_decode_kernel(data, st)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_state_equal(want_st, got_st)


DECODE_CASES = [c[0] for c in kernel_cases.decode_cases("cpu")]


def is_tame(st) -> bool:
    """Every lane inside the decoder's tame ranges (csrc/dfpwm.cu tame())."""
    q, s, lb, pq, lp = (a.numpy() for a in st.leaves())
    in8 = [(v >= -128).all() and (v <= 127).all() for v in (q, pq, lp)]
    return all(in8) and (s >= 0).all() and (s <= 1023).all() and np.isin(lb, (0, 1)).all()


@pytest.mark.parametrize("name", DECODE_CASES)
def test_decode_cases_plain_versions_match_pallas_interpret(name):
    """The cases at the bounds of the decoder's tame test, chained calls and
    the mixed fleet's 4000-byte rows, which the card holds kernels (a) and
    (b) to: both plain versions against the Pallas kernels in interpret
    mode, samples and state bit-equal after every call; the first call of
    ``wild_then_tame`` starts outside the ranges and leaves every lane in."""
    _, calls, st = next(c for c in kernel_cases.decode_cases("cpu") if c[0] == name)
    jst = JaxState(*(jnp.asarray(leaf.numpy()) for leaf in st.leaves()))
    raw_st = dsp_st = st
    for call, data in enumerate(calls):
        want, want_st = kp.dfpwm_decode_pallas(data.numpy(), jst, interpret=True)
        got, raw_st = dfpwm_decode_kernel(data, raw_st)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert_state_equal(want_st, raw_st)
        want, _ = kp.dfpwm_decode_dsp_pallas(data.numpy(), jst, ALPHA_48K, interpret=True)
        got, dsp_st = dfpwm_decode_dsp_kernel(data, dsp_st, ALPHA_48K)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert_state_equal(want_st, dsp_st)
        jst = want_st
        if name == "wild_then_tame" and call == 0:
            assert not is_tame(st) and is_tame(raw_st)


def test_cpu_tensors_take_the_plain_versions():
    data = torch.zeros((2, 4), dtype=torch.uint8)
    launches = (dfpwm_decode_kernel.launches, dfpwm_decode_dsp_kernel.launches)
    calls = (dfpwm_decode_ref.calls, dfpwm_decode_dsp_ref.calls)
    dfpwm_decode_kernel(data, DfpwmState.zeros(2))
    dfpwm_decode_dsp_kernel(data, DfpwmState.zeros(2), ALPHA_48K)
    assert (dfpwm_decode_kernel.launches, dfpwm_decode_dsp_kernel.launches) == launches
    assert (dfpwm_decode_ref.calls, dfpwm_decode_dsp_ref.calls) == (calls[0] + 1, calls[1] + 1)


@pytest.mark.parametrize("case", ["dtype", "rank", "state_dtype", "state_lanes", "mask_dtype",
                                  "gain_shape", "device"])
def test_wrappers_reject_what_they_do_not_take(case):
    data = torch.zeros((3, 4), dtype=torch.uint8)
    state = DfpwmState.zeros(3)
    mask, gain = None, None
    if case == "dtype":
        data = data.to(torch.int32)
    elif case == "rank":
        data = data.reshape(-1)
    elif case == "state_dtype":
        state.charge = state.charge.to(torch.int64)
    elif case == "state_lanes":
        state = DfpwmState.zeros(2)
    elif case == "mask_dtype":
        mask = torch.ones(3, dtype=torch.int32)
    elif case == "gain_shape":
        gain = (torch.ones(3), torch.zeros(4))
    elif case == "device":
        data = data.to("meta")
    with pytest.raises(ValueError):
        dfpwm_decode_dsp_kernel(data, state, ALPHA_48K, mask=mask, gain=gain)
