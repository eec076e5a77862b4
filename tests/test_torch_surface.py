"""The last public names of the JAX package in aukit_tpu_torch, each against
its JAX twin on the CPU: ``Config.flac_device_restore_min`` and the default
route of ``codecs.flac.restore_flat(device=None)`` that it sets (and with it
``FlacFleet(device_restore=None)``'s), ``check_bit_depth`` and
``check_data_type`` at the package's top level, and the native binding
``native.flacbits.restore_lpc``.

Inputs are the restore cases of tests/torch_kernel_cases.py that lie in the
native restore's domain (orders 0-32 within each row's block, shifts in
[-3, 31]): ``wide_shifts`` (shifts up to 70), ``orders_beyond_a_tile``
(orders past the 32 coefficients) and ``edge_blocks_and_orders`` (negative
orders, blocks past the row) index or shift out of range in the C code: the
JAX binding passes them through, the port's ``restore_lpc`` refuses them.
Tolerance: every output equal, bit for bit.
"""

import numpy as np
import pytest
import torch

import aukit_tpu as ak
import aukit_tpu_torch as tk
from aukit_tpu import config as jax_config
from aukit_tpu.codecs import flac as jax_flac
from aukit_tpu.native import flacbits as jax_native
from aukit_tpu_torch import config
from aukit_tpu_torch.codecs import flac
from aukit_tpu_torch.kernels import flac_cuda
from aukit_tpu_torch.native import flacbits
from tests import torch_kernel_cases as kernel_cases

OUT_OF_DOMAIN = ("wide_shifts", "orders_beyond_a_tile", "edge_blocks_and_orders")
LPC_CASES = {name: [a.numpy() for a in args] for name, args, _ in kernel_cases.lpc_cases("cpu")
             if name not in OUT_OF_DOMAIN}
no_card = pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")


@pytest.fixture
def restore_min():
    """Sets ``flac_device_restore_min`` in both packages for a test, then
    puts both back."""
    saved = config.CONFIG.flac_device_restore_min, jax_config.CONFIG.flac_device_restore_min

    def put(value):
        config.CONFIG.flac_device_restore_min = jax_config.CONFIG.flac_device_restore_min = value

    yield put
    config.CONFIG.flac_device_restore_min, jax_config.CONFIG.flac_device_restore_min = saved


def flat_batch(name):
    """A case as ``restore_flat``'s flat batch: each row's first ``block``
    values, one span after another, with wasted bits 0-2 a row."""
    vals, orders, shifts, blocks, coefs = LPC_CASES[name]
    wasted = np.random.default_rng(len(vals)).integers(0, 3, len(vals))
    sub = {"order": orders.astype(np.int64), "shift": shifts.astype(np.int64),
           "wasted": wasted.astype(np.int64), "block": blocks.astype(np.int64)}
    flat = np.concatenate([row[:b] for row, b in zip(vals.astype(np.int64), blocks)])
    return sub, coefs.astype(np.int64), flat


def test_flac_device_restore_min_has_the_jax_default():
    assert config.Config().flac_device_restore_min == jax_config.Config().flac_device_restore_min
    assert tk.CONFIG.flac_device_restore_min == 1 << 62 == ak.CONFIG.flac_device_restore_min


@pytest.mark.parametrize("field", ["default", 0])
@pytest.mark.parametrize("name", sorted(LPC_CASES))
def test_restore_flat_default_route_matches_jax(name, field, restore_min):
    """``restore_flat(device=None)`` on the CPU equals the JAX one on its CPU
    backend, at the field's default and at 0: both take the host route (no
    kernel plain version runs in the port)."""
    if field != "default":
        restore_min(field)
    sub, coefs, flat = flat_batch(name)
    calls = flac_cuda.lpc_restore_ref.calls
    got = flac.restore_flat(sub, coefs, flat.copy(), 16, device=None, on="cpu")
    assert flac_cuda.lpc_restore_ref.calls == calls
    want = jax_flac.restore_flat(sub, coefs, flat.copy(), 16, device=None)
    np.testing.assert_array_equal(got, want)


@no_card
def test_restore_field_sends_cuda_batches_to_the_card_or_raises(restore_min):
    """Bound for CUDA, a batch below the field takes the host route (so no
    card is needed at the default); at 0 the route is the card's, and with
    no card present it raises, as ``require_device`` does, rather than
    carry on on the host. ``FlacFleet(device_restore=None)`` on CUDA
    follows the field through its step."""
    sub, coefs, flat = flat_batch("wide_130x600_order13")
    want = flac.restore_flat(sub, coefs, flat.copy(), 16, on="cpu")
    np.testing.assert_array_equal(flac.restore_flat(sub, coefs, flat.copy(), 16, on="cuda"),
                                  want)
    from tests import fixtures
    frame = fixtures.flac_frame([{"type": "fixed", "order": 1, "warmup": [3],
                                  "residuals": [1] * 4095}], 4096, 0, 16)
    data = fixtures.flac_stream_header(48000, 1, 16, 4096) + frame
    fleet = tk.FlacFleet(1)
    fleet.feed(0, data)
    fleet.feed(0, None)
    assert fleet.step() is not None
    restore_min(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flac.restore_flat(sub, coefs, flat.copy(), 16, on="cuda")
    fleet = tk.FlacFleet(1)
    fleet.feed(0, data)
    fleet.feed(0, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.step()
    # an explicit host route needs no card whatever the field
    np.testing.assert_array_equal(
        flac.restore_flat(sub, coefs, flat.copy(), 16, device=False, on="cuda"), want)


@pytest.mark.parametrize("fn,args", [
    ("check_bit_depth", (12,)), ("check_bit_depth", (0,)), ("check_bit_depth", ("16",)),
    ("check_bit_depth", (16,)), ("check_data_type", ("double", 16)),
    ("check_data_type", ("float", 16)), ("check_data_type", (None, 8)),
    ("check_data_type", ("float", 32)), ("check_data_type", ("unsigned", 8)),
])
def test_check_names_at_the_top_level_match_jax(fn, args):
    """``aukit_tpu_torch.check_bit_depth`` and ``.check_data_type`` exist, as
    in the JAX package, and return its values or raise its exception types
    and messages."""
    results = []
    for pkg in (ak, tk):
        try:
            results.append(("value", getattr(pkg, fn)(*args)))
        except Exception as e:  # noqa: BLE001 - the exception is the result
            results.append((type(e), str(e)))
    assert results[0] == results[1]


@pytest.mark.parametrize("name", sorted(LPC_CASES))
def test_native_restore_lpc_matches_jax_binding(name):
    """``native.flacbits.restore_lpc`` over padded int64 rows equals the JAX
    package's binding of the same native function, and restores in place
    as it does."""
    vals, orders, shifts, blocks, coefs = (a.astype(np.int64) for a in LPC_CASES[name])
    want = jax_native.restore_lpc(vals.copy(), blocks, orders, shifts, coefs)
    rows = vals.copy()
    got = flacbits.restore_lpc(rows, blocks, orders, shifts, coefs)
    assert got is rows
    np.testing.assert_array_equal(got, want)
    ref = flac.restore_lpc_batch(vals.copy(), coefs, shifts, orders)
    for row, want_row, b in zip(got, ref, blocks):
        np.testing.assert_array_equal(row[:b], want_row[:b])


@pytest.mark.parametrize("name", OUT_OF_DOMAIN)
def test_native_restore_lpc_refuses_what_the_c_loop_cannot_take(name):
    """The cases outside the native restore's domain (shifts past 63,
    orders past the 32 coefficients, negative orders, blocks past the row)
    raise ValueError before the C loop reads or writes out of range."""
    args = {n: a for n, a, _ in kernel_cases.lpc_cases("cpu")}[name]
    vals, orders, shifts, blocks, coefs = (a.numpy().astype(np.int64) for a in args)
    with pytest.raises(ValueError, match="out of the restore's range"):
        flacbits.restore_lpc(vals, blocks, orders, shifts, coefs)
