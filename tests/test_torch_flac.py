"""The FLAC codec pieces of aukit_tpu_torch against aukit_tpu on the same
inputs, on the CPU: the header and frame parse (native and Python paths),
the LPC restore's plain version against the int64 oracle and the Pallas
kernel in interpret mode, the flat restore routes, and the zero-state
lowpass's plain version against the jitted Pallas kernel in interpret mode.
Every comparison is exact."""

import jax
import numpy as np
import pytest
import torch

from aukit_tpu.codecs import flac as jax_flac
from aukit_tpu.kernels import flac_pallas as fp
from aukit_tpu.kernels.iir_pallas import iir_zero_lanes
from aukit_tpu_torch.codecs import flac
from aukit_tpu_torch.kernels import flac_cuda, iir_cuda
from aukit_tpu_torch.native import flacbits
from tests import fixtures
from tests import torch_kernel_cases as kernel_cases
from tests.test_flac_fleet import make_flac


def i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def lpc_stream(rng, n=512, frames=3, order=8, shift=9, depth=16, wasted=0):
    """A real LPC stream: a random-walk signal, its order-8 residuals."""
    coefs = [120, -60, 30, -15, 8, -4, 2, -1][:order]
    out = []
    for k in range(frames):
        sig = np.cumsum(rng.integers(-60, 60, n)).astype(np.int64)
        res = [int(sig[i]) - (sum(int(sig[i - 1 - j]) * coefs[j] for j in range(order)) >> shift)
               for i in range(order, n)]
        out.append(fixtures.flac_frame(
            [{"type": "lpc", "order": order, "warmup": [int(v) for v in sig[:order]],
              "precision": 8, "shift": shift, "coefs": coefs, "residuals": res, "param": 7,
              "partition_order": 2, "wasted": wasted}], n, 0, depth, frame_number=k))
    return fixtures.flac_stream_header(48000, 1, depth, frames * n) + b"".join(out)


def escape_stream():
    """Fixed and LPC subframes with an escaped (verbatim-bits) Rice
    partition, method-1 (5-bit) parameters, and wasted bits."""
    rng = np.random.default_rng(31)
    n = 256
    sig = rng.integers(-500, 500, n)
    res = [int(sig[i]) - (2 * int(sig[i - 1]) - int(sig[i - 2])) for i in range(2, n)]
    subs = [{"type": "fixed", "order": 2, "warmup": [int(sig[0]), int(sig[1])],
             "residuals": res, "partition_order": 2, "escape_partition": 1, "escape_bits": 13},
            {"type": "lpc", "order": 3, "warmup": [1, 2, 3], "precision": 12, "shift": 4,
             "coefs": [700, -300, 100], "residuals": [int(v) for v in rng.integers(-90, 90, n - 3)],
             "method": 1, "param": 9, "partition_order": 1, "wasted": 2}]
    frame = fixtures.flac_frame(subs, n, 1, 16)
    return fixtures.flac_stream_header(44100, 2, 16, n) + frame * 2


STREAMS = {
    "mono_mixed_types": lambda: make_flac(32000, 4, seed=1),
    "short_final": lambda: make_flac(44100, 3, seed=2, final_short=100),
    "stereo_independent": lambda: make_flac(48000, 3, channels=2, chan_asgn=0, seed=3),
    "left_side": lambda: make_flac(24000, 3, channels=2, chan_asgn=8, seed=4),
    "side_right": lambda: make_flac(22050, 3, channels=2, chan_asgn=9, seed=5),
    "mid_side": lambda: make_flac(48000, 3, channels=2, chan_asgn=10, seed=6),
    "three_channels": lambda: make_flac(44100, 2, channels=3, chan_asgn=2, seed=7),
    "lpc_wasted_bits": lambda: lpc_stream(np.random.default_rng(8), wasted=1),
    "escape_partitions": escape_stream,
    "with_comments": lambda: make_flac(48000, 2, seed=9, comments={"TITLE": "x", "ARTIST": "y"}),
}


def assert_parse_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
                assert g[k].dtype == w[k].dtype
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        else:
            assert g == w


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_parse_matches_jax(name, use_native):
    """Header, then every frame, whole and incrementally cut mid-stream."""
    if use_native:
        assert flacbits.available()
    data = STREAMS[name]()
    hdr = flac.parse_flac_header(data)
    assert hdr == jax_flac.parse_flac_header(data)
    _, channels, depth, _, _, pos = hdr
    assert_parse_equal(flac.parse_all_frames(data, pos, channels, depth, use_native),
                       jax_flac.parse_all_frames(data, pos, channels, depth, use_native))
    cut = data[: len(data) - len(data) // 3]
    assert_parse_equal(
        flac.parse_all_frames(cut, pos, channels, depth, use_native, strict=False,
                              incremental=True),
        jax_flac.parse_all_frames(cut, pos, channels, depth, use_native, strict=False,
                                  incremental=True))


def malformed_cases():
    good = make_flac(48000, 2, seed=10)
    _, _, _, _, _, pos = jax_flac.parse_flac_header(good)
    bad_depth = bytearray(good)
    bad_depth[8 + 10 + 3] = (bad_depth[8 + 10 + 3] & 0x0F) | (11 << 4)  # 12-bit samples
    no_info = b"fLaC" + bytes([0x80 | 4]) + (8).to_bytes(3, "big") + b"\x00" * 8
    return {
        "bad_magic": (b"OggS" + good[4:], None),
        "truncated_header": (good[:20], None),
        "bad_depth": (bytes(bad_depth), None),
        "no_streaminfo": (no_info, None),
        "bad_sync": (good[:pos] + b"\x00\x00" + good[pos + 2:], pos),
        "truncated_frame": (good[: pos + 40], pos),
    }


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("name", ["bad_magic", "truncated_header", "bad_depth",
                                  "no_streaminfo", "bad_sync", "truncated_frame"])
def test_malformed_streams_raise_as_jax(name, use_native):
    """The same exception type and message; the lenient parse keeps what
    the JAX package keeps."""
    data, pos = malformed_cases()[name]

    def outcome(module, fn):
        try:
            return "ok", fn(module)
        except Exception as e:  # the type and message are what is compared
            return type(e).__name__, str(e)

    if pos is None:
        got = outcome(flac, lambda m: m.parse_flac_header(data))
        want = outcome(jax_flac, lambda m: m.parse_flac_header(data))
        assert got == want and got[0] != "ok"
        return
    got = outcome(flac, lambda m: m.parse_all_frames(data, pos, 1, 16, use_native))
    want = outcome(jax_flac, lambda m: m.parse_all_frames(data, pos, 1, 16, use_native))
    assert got[0] == want[0] == "FlacError" and got[1] == want[1]
    assert_parse_equal(flac.parse_all_frames(data, pos, 1, 16, use_native, strict=False),
                       jax_flac.parse_all_frames(data, pos, 1, 16, use_native, strict=False))


def pallas_case(rng, L=11, max_order=32):
    """The cases of test_flac_lpc_pallas_matches_int64: random orders, shifts
    0/15/>15/negative, ragged per-lane blocks."""
    T = fp.TIME_TILE * 2
    orders = rng.integers(0, max_order + 1, L).astype(np.int64)
    orders[0] = max_order
    shifts = np.array([0, 5, 9, 12, 15, 17, 20, 31, -1, -3, 14][:L], np.int64)
    blocks = rng.integers(fp.TIME_TILE // 2, T + 1, L).astype(np.int64)
    coefs = np.zeros((L, 32), np.int64)
    vals = np.zeros((L, T), np.int64)
    for lane in range(L):
        o = orders[lane]
        coefs[lane, :o] = rng.integers(-(1 << 14), (1 << 14) + 1, o)
        vals[lane, : blocks[lane]] = rng.integers(-2000, 2000, blocks[lane])
        vals[lane, :o] = rng.integers(-30000, 30000, o)
    for lane in range(L):
        if shifts[lane] < 0:
            coefs[lane] //= 1 << 12
            vals[lane] = np.clip(vals[lane], -3, 3)
    return vals, orders, shifts, blocks, coefs


@pytest.mark.parametrize("max_order", [3, 8, 13, 32])
def test_lpc_restore_ref_matches_int64_and_pallas(max_order):
    """lpc_restore_ref (through the wrapper, on CPU tensors) equals the
    Pallas kernel in interpret mode on every lane, and the int64 oracle on
    every lane inside the limb kernel's exactness domain; one case per tap
    bucket K."""
    vals, orders, shifts, blocks, coefs = pallas_case(np.random.default_rng(max_order), 11,
                                                      max_order)
    K = flac_cuda.order_bucket(max_order)
    assert K == fp._order_bucket(max_order)
    calls = flac_cuda.lpc_restore_ref.calls
    got = flac_cuda.lpc_restore_kernel(i32(vals), i32(orders), i32(shifts), i32(blocks),
                                       i32(coefs)).numpy()
    assert flac_cuda.lpc_restore_ref.calls == calls + 1
    pallas = np.asarray(fp.lpc_restore_pallas(vals, orders, shifts, blocks, coefs,
                                              interpret=True))
    np.testing.assert_array_equal(got, pallas)
    ref = jax_flac.restore_lpc_batch(vals.copy(), coefs, shifts, orders)
    inside = 0
    for lane in range(len(orders)):
        b = int(blocks[lane])
        if np.abs(ref[lane, :b]).max() < fp.MAX_ABS_SAMPLE:
            np.testing.assert_array_equal(got[lane, :b], ref[lane, :b], err_msg=f"lane {lane}")
            inside += 1
    assert inside >= 3


@pytest.mark.parametrize("T,max_order", [(70, 3), (131, 8), (257, 13), (66, 32)])
def test_lpc_restore_ref_rows_off_the_16_byte_grid(T, max_order):
    """Rows whose length is not a multiple of 4 samples (the CUDA kernel
    then copies 4 bytes at a time) with ragged blocks and shifts of every
    sign: the plain version equals the Pallas kernel in interpret mode on
    every lane, and the int64 oracle inside the limb kernel's domain."""
    rng = np.random.default_rng(T)
    L = 11
    orders = rng.integers(0, max_order + 1, L).astype(np.int64)
    orders[0] = max_order
    shifts = np.array([0, -1, 9, -3, 15, 17, -2, 31, 5, -1, 14], np.int64)
    blocks = rng.integers(T // 2, T + 1, L).astype(np.int64)
    coefs = np.zeros((L, 32), np.int64)
    vals = rng.integers(-2000, 2000, (L, T)).astype(np.int64)
    for lane in range(L):
        o = orders[lane]
        coefs[lane, :o] = rng.integers(-(1 << 14), (1 << 14) + 1, o)
        vals[lane, :o] = rng.integers(-30000, 30000, o)
        if shifts[lane] < 0:
            coefs[lane] //= 1 << 12
            vals[lane] = np.clip(vals[lane], -3, 3)
    got = flac_cuda.lpc_restore_kernel(i32(vals), i32(orders), i32(shifts), i32(blocks),
                                       i32(coefs)).numpy()
    pallas = np.asarray(fp.lpc_restore_pallas(vals, orders, shifts, blocks, coefs,
                                              interpret=True))
    np.testing.assert_array_equal(got, pallas)
    ref = jax_flac.restore_lpc_batch(vals.copy(), coefs, shifts, orders)
    inside = 0
    for lane in range(L):
        b = int(blocks[lane])
        if np.abs(ref[lane, :b]).max() < fp.MAX_ABS_SAMPLE:
            np.testing.assert_array_equal(got[lane, :b], ref[lane, :b], err_msg=f"lane {lane}")
            inside += 1
    assert inside >= 3
    assert (shifts < 0).sum() >= 4 and T % 4


def test_lpc_restore_ref_typical_stream():
    """Order-8 lane set shaped like a real file (uniform blocks)."""
    rng = np.random.default_rng(12)
    L, T = 4, 128
    coefs = np.zeros((L, 32), np.int64)
    coefs[:, :8] = [120, -60, 30, -15, 8, -4, 2, -1]
    vals = rng.integers(-800, 800, (L, T)).astype(np.int64)
    orders, shifts, blocks = np.full(L, 8), np.full(L, 9), np.full(L, T)
    ref = jax_flac.restore_lpc_batch(vals.copy(), coefs, shifts, orders)
    got = flac_cuda.lpc_restore_ref(i32(vals), i32(orders), i32(shifts), i32(blocks),
                                    i32(coefs), K=8)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("depth", [16, 24, 32])
@pytest.mark.parametrize("device", [True, False, None])
def test_restore_flat_routes_match_jax(depth, device):
    """restore_flat on a parsed real LPC stream with wasted bits: the device
    route (the kernel's plain version on CPU tensors) equals the JAX
    package's Pallas route in interpret mode and the C++ int64 restore;
    depth 32 stays on the host in both packages."""
    data = lpc_stream(np.random.default_rng(depth), depth=depth, wasted=1)
    _, ch, d, _, _, pos = flac.parse_flac_header(data)
    fm, sub, coefs, values = flac.parse_all_frames(data, pos, ch, d)
    offs = np.concatenate([[0], np.cumsum(sub["block"])])
    cpp = flacbits.restore_lpc_flat(values.copy(), offs[:-1], sub["block"], sub["order"],
                                    sub["shift"], sub["wasted"], coefs)
    calls = flac_cuda.lpc_restore_ref.calls
    # the host routes restore in place: each call gets its own copy
    got = flac.restore_flat(sub, coefs, values.copy(), d, device=device)
    assert flac_cuda.lpc_restore_ref.calls - calls == (1 if device and depth <= 24 else 0)
    want = jax_flac.restore_flat(sub, coefs, values.copy(), d, device=bool(device),
                                 interpret=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, cpp)
    assert got.dtype == np.int64


def overflowing_flac() -> bytes:
    """ROADMAP queue 3, fault 3.3: a mid/side LPC track (tests/torch_tracks.py)
    with byte 68 set to 0, so its predictor is unstable and restored values
    leave int32 (its warm-up and residuals fit)."""
    from tests import torch_tracks

    raw, _ = torch_tracks.flac_file(torch_tracks.synth_track(0.5, 22050, 6), 22050, 3, 1024)
    return raw[:68] + b"\x00" + raw[69:]


def staged_rows(stream: bytes, dtype=np.int32):
    """A stream's subframes staged as kernel (g)'s rows: -> [vals, orders,
    shifts, blocks, coefs] CPU tensors and K, and the parse."""
    _, ch, d, _, _, pos = flac.parse_flac_header(stream)
    fm, sub, coefs, values = flac.parse_all_frames(stream, pos, ch, d)
    T = int(sub["block"].max())
    vals = np.zeros((len(sub["order"]), T), dtype)
    vals[np.arange(T)[None, :] < sub["block"][:, None]] = values
    K = flac_cuda.order_bucket(int(sub["order"].max()))
    args = [torch.from_numpy(vals)] + [i32(a) for a in (sub["order"], sub["shift"],
                                                        sub["block"], coefs[:, :K])]
    return args + [K], (sub, coefs, values)


def test_restore_leaving_int32_restores_wrapped_rows_wide(monkeypatch):
    """The port decodes the overflowing stream as the JAX package does, on
    all 1502 samples the int32 rows once wrapped (the first at [0, 273],
    36739.324 in JAX), with no restore on the host: kernel (g) reports the
    rows whose int32 store wrapped (exactly those whose int64 restore
    leaves int32; none of a valid stream's), and its int64 rows restore
    them as the int64 host restore does."""
    data = overflowing_flac()

    def host_restore(*args, **kwargs):
        raise AssertionError("a device batch restored on the host")

    monkeypatch.setattr(flacbits, "restore_lpc_flat", host_restore)
    monkeypatch.setattr(flac, "restore_lpc_batch", host_restore)
    got, rate, _, depth = flac.decode_flac(data, device="cpu")
    monkeypatch.undo()
    want = jax_flac.decode_flac(data)[0]
    np.testing.assert_array_equal(got, want)
    assert got[0, 273] == np.float32(36739.324)
    for stream, leaves in ((data, True), (lpc_stream(np.random.default_rng(5)), False)):
        args, (sub, coefs, values) = staged_rows(stream)
        assert flac._fits_int32(values)
        wrapped = torch.full((len(sub["order"]),), 7, dtype=torch.int32)
        flac_cuda.lpc_restore_ref(*args, wrapped=wrapped)
        wide_args, _ = staged_rows(stream, np.int64)
        wide = flac_cuda.lpc_restore_ref(*wide_args)
        assert wide.dtype == torch.int64
        oracle = jax_flac.restore_lpc_batch(wide_args[0].numpy(), coefs, sub["shift"],
                                            sub["order"])
        keep = np.arange(oracle.shape[1])[None, :] < sub["block"][:, None]
        oracle = np.where(keep, oracle, 0)  # the oracle runs on past a short block
        np.testing.assert_array_equal(wide.numpy(), oracle)
        leaving = ((oracle < -(1 << 31)) | (oracle >= 1 << 31)).any(1)
        np.testing.assert_array_equal(wrapped.numpy(), leaving.astype(np.int32))
        assert bool(leaving.any()) is leaves


def test_restore_batch_outside_int32_stays_on_host():
    """Residuals beyond int32 (a malformed stream) never reach kernel (g):
    the host check of the batch's range sends it to the int64 restore."""
    values = np.array([1, 2, (1 << 31) + 5, 7], np.int64)
    sub = {k: np.array([v], np.int64) for k, v in
           (("order", 1), ("shift", 0), ("wasted", 0), ("block", 4))}
    coefs = np.zeros((1, 32), np.int64)
    coefs[0, 0] = 1
    calls = flac_cuda.lpc_restore_ref.calls
    got = flac.restore_flat(sub, coefs, values.copy(), 16, device=True)
    assert flac_cuda.lpc_restore_ref.calls == calls
    np.testing.assert_array_equal(got, jax_flac.restore_flat(sub, coefs, values.copy(), 16,
                                                             device=False))


@pytest.mark.parametrize("use_native", [None, False, True])
def test_decode_flac_takes_the_jax_positional_arguments(use_native):
    """``decode_flac(data, head, use_native)`` as in the JAX package, the
    device keyword only (ROADMAP queue 3, fault 3.5): None and False restore
    on the device (the kernel's plain version here), True natively on the
    host; every route gives the JAX package's samples."""
    data = lpc_stream(np.random.default_rng(6))
    calls = flac_cuda.lpc_restore_ref.calls
    got = flac.decode_flac(data, False, use_native, device="cpu")
    assert flac_cuda.lpc_restore_ref.calls - calls == (0 if use_native else 1)
    want = jax_flac.decode_flac(data, False, use_native)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert flac.decode_flac(data, True, use_native, device="cpu")[0].shape == (1, 0)


def test_lpc_restore_ref_depth32_rows_equal_int64():
    """With int64 products the plain version restores 32-bit rows, which
    the TPU's limb arithmetic cannot: its output equals the int64 oracle."""
    rng = np.random.default_rng(32)
    L, T, order, shift = 5, 300, 8, 14
    c = np.array([9000, -6000, 3000, -1500, 800, -400, 200, -100], np.int64)
    sig = np.clip(np.cumsum(rng.integers(-1 << 24, 1 << 24, (L, T)), axis=1),
                  -(1 << 31), (1 << 31) - 1)
    coefs = np.zeros((L, 32), np.int64)
    coefs[:, :order] = c
    vals = sig.copy()
    for i in range(order, T):
        pred = (sig[:, i - order: i][:, ::-1] * c).sum(1) >> shift
        vals[:, i] = sig[:, i] - pred
    ref = jax_flac.restore_lpc_batch(vals, coefs, np.full(L, shift), np.full(L, order))
    np.testing.assert_array_equal(ref, sig)
    assert np.abs(sig).max() >= fp.MAX_ABS_SAMPLE  # outside the limb kernel's domain
    got = flac_cuda.lpc_restore_ref(i32(vals), i32(np.full(L, order)), i32(np.full(L, shift)),
                                    i32(np.full(L, T)), i32(coefs))
    np.testing.assert_array_equal(got.numpy(), sig)


def test_lpc_restore_checks_arguments():
    v = torch.zeros((3, 8), dtype=torch.int32)
    lane = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="vals"):
        flac_cuda.lpc_restore_kernel(v.to(torch.int16), lane, lane, lane, torch.zeros((3, 32)))
    with pytest.raises(ValueError, match="wrapped is reported for int32 rows only"):
        flac_cuda.lpc_restore_kernel(v.to(torch.int64), lane, lane, lane,
                                     torch.zeros((3, 8), dtype=torch.int32), wrapped=lane)
    with pytest.raises(ValueError, match="wrapped"):
        flac_cuda.lpc_restore_kernel(v, lane, lane, lane, torch.zeros((3, 8), dtype=torch.int32),
                                     wrapped=lane[:2])
    with pytest.raises(ValueError, match="coefs"):
        flac_cuda.lpc_restore_kernel(v, lane, lane, lane, torch.zeros((2, 32), dtype=torch.int32))
    with pytest.raises(ValueError, match="K must be"):
        flac_cuda.lpc_restore_kernel(v, lane, lane, lane, torch.zeros((3, 8), dtype=torch.int32),
                                     K=16)


@pytest.mark.parametrize("alpha", [0.9568, 0.6, 0.12, 0.0123])
def test_iir_zero_ref_matches_jitted_pallas(alpha):
    """iir_zero_ref (through the wrapper) equals the jitted JAX kernel in
    interpret mode bit for bit: the fused multiply-add changes sides at the
    first sample of each group of 8, as XLA compiles the kernel body."""
    rng = np.random.default_rng(int(alpha * 1e4))
    x = (rng.standard_normal((37, 300)) * 0.5).astype(np.float32)  # unaligned
    want = np.asarray(jax.jit(iir_zero_lanes, static_argnums=(1, 2))(x, alpha, True))
    calls = iir_cuda.iir_zero_ref.calls
    got = iir_cuda.iir_zero_kernel(torch.from_numpy(x), alpha).numpy()
    assert iir_cuda.iir_zero_ref.calls == calls + 1
    np.testing.assert_array_equal(got, want)
    # one rounding side everywhere would not do: the pattern is the reference's
    a, c = iir_cuda.coefficients(alpha)
    y, plain = np.float32(0), np.empty_like(x)
    for t in range(x.shape[1]):
        y = np.float32(a) * x[:, t] + np.float32(c) * y
        plain[:, t] = y
    assert not np.array_equal(plain, want)


LPC_CASES = {name: rest for name, *rest in kernel_cases.lpc_cases("cpu")}
IIR_CASES = {name: rest for name, *rest in kernel_cases.iir_cases("cpu")}


@pytest.mark.parametrize("name", sorted(LPC_CASES))
def test_kernel_cases_lpc_plain_version_matches_pallas_interpret(name):
    """Every case the card holds kernel (g) to (its plain version there, max
    |error| 0), on CPU tensors through the plain version and through the
    Pallas kernel in interpret mode, bit for bit. The limb kernel clamps its
    shift amounts to 31, so rows with a shift below -30 lie outside its
    domain (FLAC's field is 5 bits, signed): those are held to the int64
    oracle instead, shifts clamped to 63 as the CUDA kernel does, up to each
    row's block, wrapped to int32."""
    args, K = LPC_CASES[name]
    got = flac_cuda.lpc_restore_kernel(*args, K).numpy()
    vals, orders, shifts, blocks, coefs = (a.numpy() for a in args)
    pallas = np.asarray(fp.lpc_restore_pallas(vals, orders, shifts, blocks, coefs,
                                              interpret=True, K=K))
    inside = shifts >= -30
    np.testing.assert_array_equal(got[inside], pallas[inside])
    if not inside.all():
        assert name == "wide_shifts"
        ref = jax_flac.restore_lpc_batch(vals[~inside], coefs[~inside],
                                         np.clip(shifts[~inside], -63, 63), orders[~inside])
        for row, want, b in zip(got[~inside], ref.astype(np.int32), blocks[~inside]):
            np.testing.assert_array_equal(row[:b], want[:b])


@pytest.mark.parametrize("name", sorted(IIR_CASES))
def test_kernel_cases_iir_plain_version_matches_jitted_pallas(name):
    """Every case the card holds kernel (h) to, on CPU tensors through the
    plain version and through the jitted JAX kernel in interpret mode, bit
    for bit: row lengths on and off the 16-byte grid, alphas near 0 and 1.
    XLA's CPU code flushes denormals to zero, inputs and results; the port
    keeps IEEE's gradual underflow (plain version and CUDA kernel alike), so
    in the two denormal cases the port's outputs below the smallest normal
    float32 are the reference's zeros, and every other output is equal."""
    x, alpha = IIR_CASES[name]
    want = np.asarray(jax.jit(iir_zero_lanes, static_argnums=(1, 2))(x.numpy(), alpha, True))
    got = iir_cuda.iir_zero_kernel(x, alpha).numpy()
    if name in ("denormal_inputs", "decay_into_denormals"):
        denormal = (got != 0) & (np.abs(got) < np.finfo(np.float32).tiny)
        assert denormal.any() and not want[denormal].any()
        got = np.where(denormal, np.float32(0), got)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,data", [
    ("lpc16", lpc_stream(np.random.default_rng(41))),
    ("lpc24_wasted", lpc_stream(np.random.default_rng(42), depth=24, wasted=1)),
    ("mid_side", make_flac(44100, 4, channels=2, chan_asgn=10, seed=43)),
    ("left_side_short", make_flac(22050, 3, channels=2, chan_asgn=8, seed=44, final_short=77)),
    ("depth8", make_flac(16000, 3, seed=45, depth=8)),
])
def test_decode_flac_native_route_is_the_fused_native_decode(name, data):
    """``decode_flac(use_native=True)`` is the JAX package's native route, the
    fused ``flacbits.decode_full`` pass, bit for bit; no kernel runs; and the
    staged route (kernel (g)'s plain version here) gives the same samples."""
    calls = flac_cuda.lpc_restore_ref.calls
    got = flac.decode_flac(data, use_native=True, device="cpu")
    assert flac_cuda.lpc_restore_ref.calls == calls
    want = jax_flac.decode_flac(data, use_native=True)
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], flac.decode_flac(data, use_native=False,
                                                           device="cpu")[0])
