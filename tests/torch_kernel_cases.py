"""Inputs that reach every path of the port's redesigned CUDA kernels: the
DFPWM decode, with and without its fused DSP, and the DFPWM encode
(``csrc/dfpwm.cu``), the FLAC LPC restore (``csrc/flac.cu``) and the
zero-state lowpass (``csrc/iir.cu``), the last three on the pipelined
skeleton ``ring_rows`` of ``csrc/lane_scan.cuh``; the QOA LMS
(``csrc/qoa.cu``) and the IMA and MS ADPCM decodes (``csrc/adpcm.cu``) on its
``window_rows``; the FLAC lanes' float64 DSP (``csrc/flac_dsp.cu``, whose
CPU test holds the plain version to the FLAC fleet's numpy host route); and
``recorded_stream_decodes``, which keeps the block
decodes the stream iterators make so that each replays at its own shape on
another device. One definition for the card tests
(``tests/test_torch_cuda.py``) and for ``chip_smoke.py``, which both load
this file by path and hold each case's kernel output against the plain
version, max |error| 0, and for the CPU tests (``tests/test_torch_dfpwm.py``,
``test_torch_encode.py``, ``test_torch_flac.py``, ``test_torch_qoa.py``,
``test_torch_adpcm.py``), which hold the plain version's output on the same
cases (``device="cpu"``) against the JAX package. Imports numpy and torch
only.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

from aukit_tpu_torch.codecs.adpcm import MSADPCM_DEFAULT_COEFFS
from aukit_tpu_torch.codecs.dfpwm import DfpwmState


def _state(leaves, device) -> DfpwmState:
    return DfpwmState(*(torch.tensor(np.asarray(a, np.int32), device=device) for a in leaves))


def tame_state(rng, lanes: int, device) -> DfpwmState:
    """A valid mid-stream decoder state: every word in its range."""
    return _state((rng.integers(-128, 128, lanes), rng.integers(8, 1024, lanes),
                   rng.integers(0, 2, lanes), rng.integers(-128, 128, lanes),
                   rng.integers(-128, 128, lanes)), device)


def wild_state(rng, lanes: int, device) -> DfpwmState:
    """States a caller may hand over though no stream produces them: every
    fourth lane has a lowpass word outside [-128, 127], the next a charge
    and a previous charge outside it, the next a strength outside [0, 1023];
    the fourth is tame. Magnitudes keep strength * (target - charge) inside
    int32."""
    q, s, lb, pq, lp = (a.copy() for a in (
        rng.integers(-128, 128, lanes), rng.integers(8, 1024, lanes), rng.integers(0, 2, lanes),
        rng.integers(-128, 128, lanes), rng.integers(-128, 128, lanes)))
    kind = np.arange(lanes) % 4
    far = rng.choice([-100000, -4000, -129, 128, 300, 90000], lanes)
    lp[kind == 0] = far[kind == 0]
    q[kind == 1] = far[kind == 1]
    pq[kind == 1] = -far[kind == 1]
    s[kind == 2] = rng.choice([-3, 1024, 5000], lanes)[kind == 2]
    return _state((q, s, lb, pq, lp), device)


def _bytes(rng, lanes: int, nbytes: int, device) -> torch.Tensor:
    return torch.tensor(rng.integers(0, 256, (lanes, nbytes), dtype=np.uint8), device=device)


def _gain(g0, slope, device):
    return (torch.tensor(np.asarray(g0, np.float32), device=device),
            torch.tensor(np.asarray(slope, np.float32), device=device))


def rail_bytes(rng, lanes: int, nbytes: int, device) -> torch.Tensor:
    """Bytes that walk the lowpass word over all of [-128, 127]: 48 bytes of
    ones (even lanes) or zeros (odd lanes) drive it to a rail, random bytes
    bring it back."""
    data = rng.integers(0, 256, (lanes, nbytes), dtype=np.uint8)
    data[0::2, :48] = 0xFF
    data[1::2, :48] = 0x00
    return torch.tensor(data, device=device)


def dsp_cases(device="cuda", nonfinite: bool = True):
    """-> (name, bytes u8[L, B], state, mask or None, gain or None) of the
    fused kernel. ``nonfinite``: also gains that overflow to +-inf and NaN
    gains (what a cast of NaN gives is the platform's: compare on one device
    only)."""
    rng = np.random.default_rng(50)
    for with_gain in (False, True):
        # the 256 lowpass words: one lane per incoming word, and bytes that
        # walk every lane over both rails (the table's 256 entries)
        lanes = 256
        st = tame_state(rng, lanes, device)
        st = DfpwmState(st.charge, st.strength, st.previous_bit, st.previous_charge,
                        torch.arange(-128, 128, dtype=torch.int32, device=device))
        gain = _gain(rng.uniform(0.5, 1.5, lanes), rng.uniform(-1, 1, lanes) / 1000,
                     device) if with_gain else None
        yield f"every_lowpass_word_gain={with_gain}", rail_bytes(rng, lanes, 128, device), st, \
            None, gain
    # incoming words outside their ranges (the division path), lanes not a
    # multiple of the block, an odd byte count with a ragged last tile, a
    # lane mask whose dead lanes' state still advances
    lanes = 300
    mask = torch.tensor(rng.random(lanes) < 0.7, device=device)
    for with_gain in (False, True):
        gain = _gain(rng.uniform(0.2, 1.8, lanes), rng.uniform(-1, 1, lanes) / 600,
                     device) if with_gain else None
        yield (f"wild_state_odd_bytes_gain={with_gain}", _bytes(rng, lanes, 77, device),
               wild_state(rng, lanes, device), mask, gain)
    # row lengths: one byte; 16 (16-byte loads, a ragged tile); 34 (even, not
    # a multiple of 16: byte loads, 16-byte stores); 48, 96 (whole tiles)
    for lanes, nbytes in ((1, 1), (3, 16), (70, 34), (65, 48), (130, 96), (5, 7)):
        yield (f"shape_{lanes}x{nbytes}", _bytes(rng, lanes, nbytes, device),
               tame_state(rng, lanes, device), None, None)
    # a base that is not 16-byte aligned under a row length that is
    lanes, nbytes = 9, 64
    flat = _bytes(rng, 1, lanes * nbytes + 1, device).reshape(-1)
    yield ("misaligned_base", flat[1:].view(lanes, nbytes), tame_state(rng, lanes, device), None,
           None)
    # a gain that drives samples past both rails, at rest and as a ramp
    lanes = 128
    g0 = np.where(np.arange(lanes) % 2 == 0, 1.0, -1.0) * rng.uniform(0.5, 400, lanes)
    yield ("gain_past_the_rails", rail_bytes(rng, lanes, 64, device), tame_state(rng, lanes, device),
           None, _gain(g0, rng.uniform(-2, 2, lanes), device))
    if nonfinite:
        # +-3e38 overflow to +-inf in the ramp or at the int8 scaling, and
        # 0 * inf is NaN there. A gain that is itself infinite is left out:
        # the plain ramp (fma_ref's round-to-odd step) is exact for finite
        # operands only.
        special = np.array([np.nan, 3e38, -3e38, 1e30, -1e30, 1.0, 0.0, -0.0], np.float32)
        g0 = special[np.arange(lanes) % 8]
        slope = special[(np.arange(lanes) // 8) % 8]
        yield ("gain_inf_nan", rail_bytes(rng, lanes, 64, device), tame_state(rng, lanes, device),
               None, _gain(g0, slope, device))


def _with(st: DfpwmState, field: str, lanes, values) -> DfpwmState:
    """``st`` with ``field`` set to ``values`` on ``lanes``."""
    leaves = dict(zip(("charge", "strength", "previous_bit", "previous_charge", "lowpass"),
                      (a.cpu().numpy().copy() for a in st.leaves())))
    leaves[field][lanes] = values
    return _state(leaves.values(), st.charge.device)


# Words just inside and just outside the decoder's tame ranges (csrc/dfpwm.cu
# tame(): charge, previous charge, lowpass in [-128, 127], strength in
# [0, 1023], previous bit 0 or 1), each on lanes whose other words are tame.
TAME_BOUNDS = {"strength": (-1, 0, 7, 8, 1023, 1024), "charge": (-129, -128, 127, 128),
               "previous_charge": (-129, -128, 127, 128), "lowpass": (-129, -128, 127, 128),
               "previous_bit": (0, 1, 2, -1)}


def decode_cases(device="cuda"):
    """-> (name, [bytes u8[L, B] of each chained call], state) of the DFPWM
    decode, raw and fused: for each word of the state its values on both
    sides of each bound of the tame test, those inside on the 32 lanes of a
    first block (a block of tame lanes) and those outside on 4 lanes each of
    a second, on rows of 48 bytes (the 16-byte grid) and of 40; a chained
    pair of calls whose first call starts from states just outside the
    ranges and leaves every lane tame (it opens with 4 bytes of alternating
    bits: the strength falls, the previous bit becomes a bit, the words move
    back into range), so the second runs the tame step from the state the
    first left; rows of 4000 bytes, the mixed fleet's 32 kHz row length."""
    rng = np.random.default_rng(56)
    for field, values in TAME_BOUNDS.items():
        low, high = (0, 1023) if field == "strength" else (0, 1) if field == "previous_bit" \
            else (-128, 127)
        inside = [v for v in values if low <= v <= high]
        outside = [v for v in values if not low <= v <= high]
        lanes = 32 + 4 * len(outside)
        st = _with(tame_state(rng, lanes, "cpu"), field, np.arange(lanes),
                   np.concatenate([np.resize(inside, 32), np.repeat(outside, 4)]))
        for nbytes in (48, 40):
            yield (f"tame_bounds_{field}_{nbytes}", [_bytes(rng, lanes, nbytes, device)],
                   _state((a.numpy() for a in st.leaves()), device))
    outside = [(f, v) for f, vs in TAME_BOUNDS.items() for v in vs
               if v in (-129, 128, -1, 1024, 2)]
    lanes = 3 * len(outside)
    st = tame_state(rng, lanes, "cpu")
    for i, (field, v) in enumerate(outside):
        st = _with(st, field, np.arange(3 * i, 3 * i + 3), v)
    first = _bytes(rng, lanes, 24, device)
    first[:, :4] = 0x55
    yield "wild_then_tame", [first, _bytes(rng, lanes, 40, device)], \
        _state((a.numpy() for a in st.leaves()), device)
    yield "mixed_fleet_rows_4000", [_bytes(rng, 3, 4000, device)], tame_state(rng, 3, device)


def _i32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.int32), device=device)


def lpc_rows(rng, rows: int, T: int, max_order: int, shifts=None):
    """Restore arguments as numpy arrays: random orders up to ``max_order``,
    shifts 0..31 and negative (or the given choice), ragged blocks, warmup
    samples and residuals as test_flac_lpc_pallas_matches_int64 makes them.
    -> (vals, orders, shifts, blocks, coefs[rows, 32])."""
    orders = rng.integers(0, max_order + 1, rows)
    orders[0] = max_order
    shifts = rng.choice([0, 5, 9, 12, 15, 17, 20, 31, -1, -3, 14] if shifts is None else shifts,
                        rows)
    blocks = rng.integers(max(1, T // 2), T + 1, rows)
    taps = np.minimum(orders, 32)
    coefs = np.where(np.arange(32)[None, :] < taps[:, None],
                     rng.integers(-(1 << 14), (1 << 14) + 1, (rows, 32)), 0)
    vals = rng.integers(-2000, 2000, (rows, T))
    vals = np.where(np.arange(T)[None, :] < orders[:, None],
                    rng.integers(-30000, 30000, (rows, T)), vals)
    neg = shifts < 0
    coefs[neg] //= 1 << 12
    vals[neg] = np.clip(vals[neg], -3, 3)
    return vals, orders, shifts, blocks, coefs


def lpc_cases(device="cuda"):
    """-> (name, (vals, orders, shifts, blocks, coefs), K or None) of the
    restore kernel: rows that are and are not on 16-byte boundaries, ragged
    last tiles, fewer rows than a block, every tap count, negative and wide
    shifts, blocks shorter than the row, orders beyond the taps and beyond a
    tile."""
    rng = np.random.default_rng(51)

    def case(rows, T, max_order, **kw):
        return tuple(_i32(a, device) for a in lpc_rows(rng, rows, T, max_order, **kw))

    # 16-byte rows (T % 4 == 0): K = 4, 8, 16, 32; whole and ragged tiles
    for rows, T, order in ((40, 192, 4), (33, 64, 7), (130, 600, 13), (70, 300, 32), (5, 4, 2)):
        yield f"wide_{rows}x{T}_order{order}", case(rows, T, order), None
    # rows off the 16-byte grid (T % 4 != 0): 4-byte copies
    for rows, T, order in ((1, 1, 1), (65, 70, 3), (300, 257, 8), (31, 131, 32)):
        yield f"narrow_{rows}x{T}_order{order}", case(rows, T, order), None
    # T % 4 == 0 under a base that is not 16-byte aligned
    vals, *rest = case(20, 128, 8)
    flat = torch.cat([vals.reshape(-1)[:1], vals.reshape(-1)])
    yield "misaligned_base", (flat[1:].view(20, 128), *rest), None
    # shifts of 32 and more, either way, and beyond the clamp
    yield "wide_shifts", case(64, 256, 8, shifts=[32, 33, 40, 63, 70, -31, -33, -40, -70, 3]), None
    # fewer taps than the largest order, and orders beyond one tile (the
    # warmup then spans tiles; both versions use the K newest samples)
    args = list(lpc_rows(rng, 48, 320, 8))
    yield "orders_beyond_taps", tuple(_i32(a, device) for a in args), 4
    args = list(lpc_rows(rng, 48, 320, 32))
    args[1][:6] = [100, 64, 65, 130, 319, 320]
    yield "orders_beyond_a_tile", tuple(_i32(a, device) for a in args), 32
    # blocks of 0 and 1, negative orders, blocks beyond the row
    args = list(lpc_rows(rng, 40, 200, 8))
    args[3][:6] = [0, 1, 7, 8, 9, 500]
    args[1][6:9] = [-1, -7, 0]
    yield "edge_blocks_and_orders", tuple(_i32(a, device) for a in args), 8


def _levels(rng, lanes: int, n: int) -> np.ndarray:
    """Random int8 levels with rows pinned at the rails, so the charge
    reaches 127 and -128 and ``level == charge == 127`` decides bits: every
    fifth lane sits at 127, the next at -128, the next goes to 127 halfway."""
    levels = rng.integers(-128, 128, (lanes, n)).astype(np.int8)
    levels[0::5] = 127
    levels[1::5] = -128
    levels[2::5, n // 2:] = 127
    return levels


def encoder_wild_state(rng, lanes: int, device) -> DfpwmState:
    """As ``wild_state`` for the encoder's three words: of every four lanes
    one has a charge outside [-128, 127], one a strength outside [0, 1023],
    one a previous bit that is neither 0 nor 1, one is tame."""
    st = [a.cpu().numpy().copy() for a in tame_state(rng, lanes, "cpu").leaves()]
    kind = np.arange(lanes) % 4
    st[0][kind == 0] = rng.choice([-100000, -4000, -129, 128, 300, 90000], lanes)[kind == 0]
    st[1][kind == 1] = rng.choice([-3, 1024, 5000], lanes)[kind == 1]
    st[2][kind == 2] = rng.choice([-1, 2, 7], lanes)[kind == 2]
    return _state(st, device)


def encode_cases(device="cuda"):
    """-> (name, [levels i8[L, N] of each chained call], state) of the encode
    kernel: tame and wild states, levels on both rails, lanes that are not a
    multiple of the block, byte counts with whole and ragged tiles and every
    store width, rows on and off the 16-byte grid."""
    rng = np.random.default_rng(52)

    def lv(lanes, nbytes):
        return torch.tensor(_levels(rng, lanes, 8 * nbytes), device=device)

    # byte counts: 1 and 7 (byte stores, 4-byte copies), 16 and 48 and 96
    # (16-byte stores; whole tiles and a ragged one), 34 (even: 16-byte
    # copies, byte stores), 36 (4-byte stores), 33 (odd: rows off the grid)
    for lanes, nbytes in ((1, 1), (5, 7), (3, 16), (70, 34), (65, 48), (130, 96), (33, 36),
                          (40, 33)):
        yield f"shape_{lanes}x{nbytes}", [lv(lanes, nbytes)], tame_state(rng, lanes, device)
    # states no stream produces: the general predictor, lane by lane
    yield "wild_state", [lv(300, 40), lv(300, 25)], encoder_wild_state(rng, 300, device)
    # the state chained over two calls, from the rails: charge 127 under
    # levels of 127, charge -128 under levels of -128
    lanes = 67
    st = tame_state(rng, lanes, "cpu")
    q = st.charge.numpy().copy()
    q[0::5], q[1::5] = 127, -128
    st = _state((q, *(a.numpy() for a in st.leaves()[1:])), device)
    yield "chained_from_the_rails", [lv(lanes, 64), lv(lanes, 32), lv(lanes, 3)], st
    # strengths at both ends of their range, and below the floor
    st = tame_state(rng, lanes, "cpu")
    s = st.strength.numpy().copy()
    s[:8] = [0, 1, 7, 8, 9, 1022, 1023, 512]
    st = _state((st.charge.numpy(), s, *(a.numpy() for a in st.leaves()[2:])), device)
    yield "strength_ends", [lv(lanes, 32)], st
    # a base aligned to 4 but not to 16 bytes under rows that would be wide
    lanes, nbytes = 9, 32
    flat = torch.tensor(_levels(rng, 1, lanes * nbytes * 8 + 8), device=device).reshape(-1)
    yield "misaligned_base", [flat[4: 4 + lanes * nbytes * 8].view(lanes, nbytes * 8)], \
        tame_state(rng, lanes, device)


def iir_cases(device="cuda"):
    """-> (name, x f32[R, T], alpha) of the zero-state lowpass: row lengths
    of one sample, within one group of 8, one tile, ragged tiles, 4096 and
    a 44.1 kHz block's 4458 (off the 16-byte grid); rows fewer than a block
    and not a multiple of it; a misaligned base; alphas near 0 and 1;
    denormal inputs and an output that decays into the denormals. Finite
    values only: the plain version's fused multiply-add (``fma_ref``) takes
    the exact error of a float64 sum, which is NaN once the sum is infinite,
    so it is exact for finite operands only."""
    rng = np.random.default_rng(53)

    def rows(R, T, scale=0.5):
        return torch.tensor((rng.standard_normal((R, T)) * scale).astype(np.float32),
                            device=device)

    for R, T in ((3, 1), (33, 4), (5, 7), (64, 64), (65, 70), (37, 257), (40, 4096), (35, 4458)):
        yield f"shape_{R}x{T}", rows(R, T), 0.9568
    for alpha in (1e-6, 0.0123, 0.5, 1.0 - 1e-6, 1.0):
        yield f"alpha_{alpha}", rows(34, 200), alpha
    # T % 4 == 0 under a base that is not 16-byte aligned
    flat = rows(1, 20 * 128 + 1).reshape(-1)
    yield "misaligned_base", flat[1:].view(20, 128), 0.6
    # denormal inputs, and large ones that decay to denormals under c ~ 1e-3
    x = rows(36, 130, 1e-41)
    x[::2, :] *= 1e-3
    yield "denormal_inputs", x, 0.12
    x = rows(36, 130, 1e30)
    x[:, 3:] = 0.0
    yield "decay_into_denormals", x, 0.999


# Row shapes of the kernels on ``window_rows`` (128-sample tiles on the
# 16-byte grid of device memory, 32 lanes a block), as (lanes, [samples of each
# chained call]): rows on the grid with whole tiles; on the grid with a ragged
# last tile; an odd length (every row its own lead into its first tile); below
# one 16-byte word; one sample; exactly one tile; lanes that are not a multiple
# of the block; rows long enough to take the ring round three times.
WINDOW_SHAPES = ((40, [256, 128]), (33, [208]), (37, [77, 75]), (5, [7]), (3, [1, 1]), (32, [128]),
                 (65, [130]), (34, [1300]))


def _off_base(x: torch.Tensor, skip: int) -> torch.Tensor:
    """The rows of ``x``, contiguous, ``skip`` elements into a new tensor."""
    flat = x.reshape(-1)
    return torch.cat([flat[:skip], flat])[skip:].view(x.shape)


def _qoa_dq(rng, lanes: int, T: int) -> np.ndarray:
    """Residuals over the dequant table's range, both of its ends pinned:
    every fifth lane alternates -+14336, the next +-14336."""
    dq = rng.integers(-14336, 14337, (lanes, T)).astype(np.int16)
    dq[0::5], dq[1::5] = 14336, -14336
    dq[0::5, ::2], dq[1::5, ::2] = -14336, 14336
    return dq


def _qoa_state(rng, lanes: int, device):
    """(history, weights) int32[L, 4]: random mid-stream words, every other
    lane in the state whose products and weights wrap int32."""
    hist = rng.integers(-32768, 32768, (lanes, 4))
    wts = rng.integers(-30000, 30000, (lanes, 4))
    hist[::2], wts[::2] = 32767, 2 * 10**8
    hist[2::4] = -32768
    return _i32(hist, device), _i32(wts, device)


def qoa_cases(device="cuda"):
    """-> (name, [dq i16[L, T] of each chained call], (history, weights)) of
    the QOA LMS kernel: ``WINDOW_SHAPES`` (rows of an even length that is no
    multiple of 8 start on 4- and 8-byte boundaries), the fleet's row length
    off the grid, bases 2 and 16 bytes into a tensor (the first moves the
    output off the input's grid: element stores, here of whole tiles too and
    in a second block, the rows' leads alternating), states that wrap int32
    and residuals at both ends of the dequant range in every case."""
    rng = np.random.default_rng(54)

    def dq(lanes, T):
        return torch.tensor(_qoa_dq(rng, lanes, T), device=device)

    for lanes, calls in (*WINDOW_SHAPES, (70, [300, 150])):
        yield (f"shape_{lanes}x{'+'.join(map(str, calls))}", [dq(lanes, T) for T in calls],
               _qoa_state(rng, lanes, device))
    for skip in (1, 8):
        lanes, T = 41, 404
        yield (f"base_plus_{skip}", [_off_base(dq(lanes, T), skip)],
               _qoa_state(rng, lanes, device))


def msadpcm_cases(device="cuda"):
    """-> (name, [nibbles i8[L, T] of each chained call], (sample1, sample2,
    delta), (c1, c2)) of the MS ADPCM decode kernel: ``WINDOW_SHAPES``, the
    engine's 1010-sample rows (every row on a 2-byte boundary), bases 1, 8
    and 16 bytes into a tensor (1: element stores, of whole tiles too and in
    a second block; 8: rows off the grid whose output is on it; 404-sample
    rows, so the leads differ from row to row); in every case negative header deltas, deltas at the
    ``1 << 20`` cap and at the floor of 16, every coefficient pair, every
    nibble (-8 and 7 pinned on a lane of every seven)."""
    rng = np.random.default_rng(55)

    def nibs(lanes, T):
        x = rng.integers(-8, 8, (lanes, T)).astype(np.int8)
        x[0::7] = -8
        x[1::7, ::3] = 7
        return torch.tensor(x, device=device)

    def state(lanes):
        delta = rng.integers(-400, 400, lanes)
        delta[0::5], delta[1::5], delta[3::5] = 1 << 20, 16, (1 << 20) - 1
        delta[2::5] = -1 - np.abs(delta[2::5])
        pidx = np.arange(lanes) % 7
        return ((_i32(rng.integers(-32768, 32768, lanes), device),
                 _i32(rng.integers(-32768, 32768, lanes), device), _i32(delta, device)),
                (_i32(MSADPCM_DEFAULT_COEFFS[0][pidx], device),
                 _i32(MSADPCM_DEFAULT_COEFFS[1][pidx], device)))

    for lanes, calls in (*WINDOW_SHAPES, (35, [1010])):
        yield (f"shape_{lanes}x{'+'.join(map(str, calls))}", [nibs(lanes, T) for T in calls],
               *state(lanes))
    for skip in (1, 8, 16):
        lanes, T = 41, 404
        yield f"base_plus_{skip}", [_off_base(nibs(lanes, T), skip)], *state(lanes)


# Incoming IMA step indices that a malformed header may carry: the lookup
# clamps them, the raw index feeds one update.
IMA_WILD_INDICES = (-1, 89, 255, -(1 << 31))


def ima_cases(device="cuda"):
    """-> (name, [nibbles u8[L, T] of each chained call], (predictor,
    step_index)) of the IMA decode kernel: ``WINDOW_SHAPES``, the engine's
    504-sample rows (every other row off the 16-byte grid), bases 1, 8 and 16
    bytes into a tensor at 41 x 404. In every case: step indices 0 and 88 and
    predictors -32768 and 32767 on the first lanes; on lanes 32 and beyond
    (a second warp, so the first keeps the in-range path) the out-of-range
    indices -1, 89, 255 and -2^31; every nibble 0..15; rows whose runs of
    nibble 7 (15) then 0 (8) drive the index to 88 and back to 0 and the
    predictor to a rail; rows whose second half holds bytes 16..255, outside
    the codec's nibbles, which the plain version reads as sign (byte >= 8)
    and magnitude (byte & 7)."""
    rng = np.random.default_rng(57)

    def nibs(lanes, T):
        x = rng.integers(0, 16, (lanes, T)).astype(np.uint8)
        x[2::7, : T // 2], x[2::7, T // 2:] = 7, 0
        x[3::7, : T // 2], x[3::7, T // 2:] = 15, 8
        x[4::7, :16] = np.arange(16)[: min(T, 16)]
        x[5::7, T // 2:] = rng.integers(16, 256, x[5::7, T // 2:].shape)
        return torch.tensor(x, device=device)

    def state(lanes):
        pred = rng.integers(-32768, 32768, lanes)
        sidx = rng.integers(0, 89, lanes)
        pred[:2], sidx[:2] = (-32768, 32767), (0, 88)
        wild = np.arange(32, lanes)
        sidx[wild] = np.resize(IMA_WILD_INDICES, len(wild))
        return _i32(pred, device), _i32(sidx, device)

    for lanes, calls in (*WINDOW_SHAPES, (35, [504])):
        yield (f"shape_{lanes}x{'+'.join(map(str, calls))}", [nibs(lanes, T) for T in calls],
               state(lanes))
    for skip in (1, 8, 16):
        lanes, T = 41, 404
        yield f"base_plus_{skip}", [_off_base(nibs(lanes, T), skip)], state(lanes)


# -- the engine's DSP stages over a mixed fleet (card test and chip_smoke.py) --------

ENGINE_DSP_SPECS = (("dfpwm", 48000, 1, 0), ("dfpwm", 32000, 1, 0), ("ima", 22050, 1, 256),
                    ("msadpcm", 22050, 1, 256), ("qoa", 44100, 2, 0), ("pcm16", 22050, 1, 0))


def _bytes_per_second(codec: str, rate: int, channels: int, block_align: int) -> int:
    if codec == "dfpwm":
        return rate // 8
    if codec == "ima":
        return -(-rate // ((block_align - 4 * channels) * 2 // channels + 1)) * block_align
    if codec == "msadpcm":
        return -(-rate // ((block_align - 7 * channels) * 2 // channels + 2)) * block_align
    if codec == "qoa":
        return -(-rate // 5120) * (8 + channels * (16 + 256 * 8))
    return rate * 2 * channels


def engine_dsp_fleet(rng, per_spec: int, seconds: float = 2.0):
    """``per_spec`` lanes of each ``ENGINE_DSP_SPECS`` entry with random bytes
    (every codec decodes any bytes), ragged lengths around ``seconds``:
    -> (spec tuples (codec, rate, channels, block_align), byte feeds)."""
    specs = [s for s in ENGINE_DSP_SPECS for _ in range(per_spec)]
    feeds = [rng.integers(0, 256, int(_bytes_per_second(*s) * seconds * (0.75 + 0.5 * rng.random())),
                          dtype=np.uint8).tobytes() for s in specs]
    return specs, feeds


def drive_engine_dsp(eng, specs, feeds):
    """The auplay chain on a ``mono=False`` engine over ``engine_dsp_fleet``:
    a lowpass on every third lane, a highpass on the next, the mono toggle
    on every other QOA lane, ``normalize(0.8)``; after the first window a
    lowpass is reconfigured, after the second a filtered 48 kHz DFPWM lane
    is checkpointed and restored. -> (steps [(windows, mask, positions)],
    the last checkpoint of every lane)."""
    for lane, (codec, rate, _c, _b) in enumerate(specs):
        if lane % 3 == 0:
            eng.set_filter(lane, "lowpass", rate / 4)
        elif lane % 3 == 1:
            eng.set_filter(lane, "highpass", 200.0)
        if codec == "qoa" and lane % 2 == 0:
            eng.set_mono(lane, True)
        eng.feed(lane, feeds[lane])
        eng.feed(lane, None)
    eng.normalize(0.8)
    steps = []
    while (r := eng.step()) is not None:
        steps.append((r[0].cpu().numpy(), r[1].copy(), r[2].copy()))
        if len(steps) == 1:
            eng.set_filter(0, "lowpass", specs[0][1] / 8)
        elif len(steps) == 2:
            eng.restore(0, eng.checkpoint(0))  # lane 0: a filtered 48 kHz DFPWM lane
    return steps, [eng.checkpoint(lane) for lane in range(len(specs))]


# -- the whole-file loaders' launch shapes (card tests, chip_smoke.py, CPU tests) ----

# A 3-minute track: the loaders launch one kernel call a file, at these shapes
# (stereo 44.1 kHz for the block codecs, QOA and FLAC; one 48 kHz lane for
# DFPWM). The CPU tests build the same cases at a fraction of a second.
WHOLE_FILE_SECONDS = 180.0


def whole_file_cases(device="cuda", seconds: float = WHOLE_FILE_SECONDS):
    """-> (name, kernel, args) at the shapes the whole-file loaders launch:
    ``kernel`` names the wrapper ("dfpwm_decode", "dfpwm_encode", "ima",
    "msadpcm", "qoa", "lpc") and ``args`` are its positional arguments.
     - raw DFPWM (``dfpwm()``): one lane of the whole file, 6000 bytes a
       second; ``Audio.dfpwm()`` of a mono 48 kHz track: one lane of 48000
       levels a second (a tone with rails);
     - IMA and MS ADPCM in WAV at ``block_align`` 1024: lanes = blocks x
       channels, rows of 1016 (IMA stereo), 2040 (IMA mono), 1010 (MS
       stereo) and 2034 (MS mono) nibbles, off the 16-byte grid but 2040,
       with the states a valid header gives (mono IMA's index masked to
       0..15);
     - QOA: F x C frame lanes of 5120 residuals, the last frame short (its
       tail zero, as the loader pads it);
     - FLAC: F x C subframe rows of 4096, order 8 (the fixtures' LPC-8),
       the last frame short.
    The names do not depend on ``seconds``."""
    rng = np.random.default_rng(58)
    rate = 44100
    n = int(seconds * rate)
    nbytes = int(seconds * 6000)
    yield ("dfpwm_decode_one_lane", "dfpwm_decode",
           (torch.tensor(rng.integers(0, 256, (1, nbytes), dtype=np.uint8), device=device),
            DfpwmState.zeros(1, device)))
    t = np.arange(nbytes * 8) / 48000
    levels = np.trunc(127.5 * np.sin(2 * np.pi * 440 * t) + rng.normal(0, 8, t.size))
    yield ("dfpwm_encode_one_lane", "dfpwm_encode",
           (torch.tensor(np.clip(levels, -128, 127).astype(np.int8)[None, :], device=device),
            DfpwmState.zeros(1, device)))
    for channels, T in ((2, 1016), (1, 2040)):
        lanes = channels * -(-n // T)
        sidx = rng.integers(0, 89 if channels == 2 else 16, lanes)
        yield (f"ima_wav_{channels}ch", "ima",
               (torch.tensor(rng.integers(0, 16, (lanes, T), dtype=np.uint8), device=device),
                _i32(rng.integers(-32768, 32768, lanes), device), _i32(sidx, device)))
    for channels, T in ((2, 1010), (1, 2034)):
        lanes = channels * -(-n // (T + 2))
        pidx = rng.integers(0, 7, lanes)
        yield (f"msadpcm_wav_{channels}ch", "msadpcm",
               (torch.tensor(rng.integers(-8, 8, (lanes, T), dtype=np.int8), device=device),
                _i32(rng.integers(-32768, 32768, lanes), device),
                _i32(rng.integers(-32768, 32768, lanes), device),
                _i32(rng.integers(16, 2048, lanes), device),
                _i32(MSADPCM_DEFAULT_COEFFS[0][pidx], device),
                _i32(MSADPCM_DEFAULT_COEFFS[1][pidx], device)))
    frames, last = -(-n // 5120), n - (-(-n // 5120) - 1) * 5120
    dq = _qoa_dq(rng, 2 * frames, 5120)
    dq[-2:, last:] = 0
    hist = rng.integers(-32768, 32768, (2 * frames, 4))
    wts = rng.integers(-32768, 32768, (2 * frames, 4))
    yield ("qoa_file", "qoa",
           (torch.tensor(dq, device=device), _i32(hist, device), _i32(wts, device)))
    frames, last = -(-n // 4096), n - (-(-n // 4096) - 1) * 4096
    rows = 2 * frames
    shifts = rng.choice([9, 10, 12], rows)
    # stable order-8 predictors (positive taps summing to 0.9), as a fitted
    # stream has: the samples stay far inside the Pallas kernel's exact range
    w = rng.random((rows, 8))
    coefs = np.zeros((rows, 32), np.int64)
    coefs[:, :8] = np.floor(0.9 * w / w.sum(1, keepdims=True) * (1 << shifts)[:, None])
    vals = rng.integers(-2000, 2000, (rows, 4096))
    vals[:, :8] = rng.integers(-30000, 30000, (rows, 8))
    blocks = np.full(rows, 4096)
    blocks[-2:] = last
    yield ("lpc_file", "lpc", tuple(_i32(a, device) for a in (
        vals, np.full(rows, 8), shifts, blocks, coefs)) + (8,))


# (name, channels, block, assignment, depth, rate, linear, out_mode, lanes)
FLAC_DSP_SPECS = (
    ("mono_identity", 1, 4096, 0, 16, 48000, True, "first", 7),
    ("mono_none_44k1", 1, 1024, 0, 16, 44100, False, "first", 5),
    ("left_side_44k1_mix", 2, 1024, 8, 16, 44100, True, "mix", 6),
    ("side_right_32k_mix", 2, 1152, 9, 24, 32000, True, "mix", 5),
    ("mid_side_odd_block_multi", 2, 520, 10, 24, 32000, True, "multi", 5),
    ("independent_48k_multi", 2, 4096, 1, 16, 48000, True, "multi", 4),
    ("three_channels_8bit_mix", 3, 576, 2, 8, 22050, True, "mix", 4),
    ("three_channels_multi", 3, 1024, 2, 16, 44100, True, "multi", 3),
)


# lanes whose blocks mix the stereo assignments of ``flac -m`` (independent,
# left/side, side/right, mid/side), lane 0 changing it on every block:
# (name, block, depth, rate, linear, out_mode, lanes)
FLAC_DSP_MIXED_SPECS = (
    ("mixed_asgn_44k1_mix", 4096, 16, 44100, True, "mix", 6),
    ("mixed_asgn_44k1_multi", 1024, 16, 44100, True, "multi", 5),
    ("mixed_asgn_32k_mix", 1152, 24, 32000, True, "mix", 5),
    ("mixed_asgn_32k_odd_block_multi", 520, 24, 32000, False, "multi", 4),
)
STEREO_ASSIGNMENTS = (1, 8, 9, 10)


def _flac_dsp_case(rng, C, n, depth, rate, out_mode, m, asgn_of):
    """One case's (restored int64[N], lanes int64[L, 6], asgn int32, fin
    float64[L, 2 + C], out's length) for lanes of ``m`` blocks, lane j's
    assignments ``asgn_of(j, m[j])``."""
    L = len(m)
    out_len = n * 48000 // rate
    width = C if out_mode == "multi" else 1
    in_off = np.cumsum(rng.integers(0, 8, L) + np.concatenate([[0], m[:-1] * C * n]))
    out_off = np.cumsum(rng.integers(0, 8, L) + np.concatenate([[0], m[:-1] * width * out_len]))
    N = int(in_off[-1] + m[-1] * C * n)
    restored = rng.integers(-(1 << depth), 1 << depth, N)
    ramp_len = np.where(np.arange(L) % 2 == 1, 48000, 0)
    ramp_pos = np.where(ramp_len > 0, 48000 - rng.integers(1, 3 * out_len, L), 0)
    gain = rng.uniform(0.0, 2.0, L)
    gain[0] = 1.0
    gain0 = np.where(ramp_len > 0, rng.uniform(0.0, 2.0, L), gain)
    if L > 3:
        gain0[3] = gain[3]  # ramping between equal gains: the scalar
    a_off = np.concatenate([[0], np.cumsum(m[:-1])])
    lanes = np.stack([in_off, m, out_off, ramp_pos, ramp_len, a_off], axis=1).astype(np.int64)
    asgn = np.concatenate([asgn_of(j, int(m[j])) for j in range(L)]).astype(np.int32)
    fin = np.concatenate([gain0[:, None], gain[:, None], rng.standard_normal((L, C)) * 0.3],
                         axis=1)
    return (torch.tensor(restored, dtype=torch.int64), torch.from_numpy(lanes),
            torch.from_numpy(asgn), torch.from_numpy(fin),
            int(out_off[-1] + m[-1] * width * out_len))


def flac_dsp_cases(device="cuda"):
    """-> (name, restored int64[N] on ``device``, lanes int64[L, 6], asgn
    int32 and fin float64[L, 2 + C] on the CPU, out's length, DspGeometry)
    of the FLAC lanes' float64 DSP kernel: every channel assignment, mono,
    stereo and 3 channels in each out mode, depths 8-24, identity, linear
    and none, an odd block size; 1-4 blocks a lane, gaps between the lanes'
    samples and outputs, restored values over the whole two's-complement
    range of the depth (the sign wrap), lowpass states, constant gains (1.0
    among them), ramps that end inside a lane's output, a ramp whose two
    gains are equal, ramps to 0.3 that end blocks before a lane's last, and
    stereo lanes of 2-10 blocks whose assignments change from block to block
    (``FLAC_DSP_MIXED_SPECS``)."""
    from aukit_tpu_torch.kernels.flac_dsp_cuda import DspGeometry
    from aukit_tpu_torch.parallel.pipeline import fir_alpha

    def on(case):
        return (case[0].to(device), *case[1:])

    rng = np.random.default_rng(61)
    for name, C, n, asgn, depth, rate, linear, out_mode, L in FLAC_DSP_SPECS:
        case = _flac_dsp_case(rng, C, n, depth, rate, out_mode, rng.integers(1, 5, L),
                              lambda _j, k, a=asgn: np.full(k, a))
        geo = DspGeometry(C, n, depth, rate, 48000, n * 48000 // rate, linear, out_mode,
                          float(fir_alpha(rate, 48000)))
        yield (name, *on(case), geo)
    # ramps to 0.3 over a second that end inside block 10 of a lane's 12
    # blocks of 44.1 kHz (4458 samples each at 48 kHz): samples after the
    # end in that block take g0 + (g1 - g0) * 1.0, which is not 0.3 in
    # float64 (from 1.0: 0.30000000000000004; from 1e20: 0.0), and the
    # blocks after it the gain itself (FlacFleet._host_dsp decides the line
    # block by block, from the ramp's position at the block)
    L, n, rate, m = 3, 4096, 44100, 12
    out_len = n * 48000 // rate
    restored = rng.integers(-(1 << 16), 1 << 16, L * m * n)
    lanes = np.stack([np.arange(L) * m * n, np.full(L, m), np.arange(L) * m * out_len,
                      [0, 0, 1000], np.full(L, 48000), np.arange(L) * m], axis=1).astype(np.int64)
    fin = np.concatenate([np.array([[1.0], [1e20], [1.0]]), np.full((L, 1), 0.3),
                          rng.standard_normal((L, 1)) * 0.3], axis=1)
    geo = DspGeometry(1, n, 16, rate, 48000, out_len, True, "first",
                      float(fir_alpha(rate, 48000)))
    yield ("ramps_to_0.3_end_before_last_block",
           torch.tensor(restored, dtype=torch.int64, device=device), torch.from_numpy(lanes),
           torch.zeros(L * m, dtype=torch.int32), torch.from_numpy(fin), L * m * out_len, geo)

    def mixed(j, k):
        if j == 0:  # a new assignment on every block
            return np.resize(rng.permutation(STEREO_ASSIGNMENTS), k)
        return rng.choice(STEREO_ASSIGNMENTS, k)

    rng = np.random.default_rng(62)
    for name, n, depth, rate, linear, out_mode, L in FLAC_DSP_MIXED_SPECS:
        case = _flac_dsp_case(rng, 2, n, depth, rate, out_mode,
                              np.concatenate([[4 + L], rng.integers(2, 10, L - 1)]), mixed)
        geo = DspGeometry(2, n, depth, rate, 48000, n * 48000 // rate, linear, out_mode,
                          float(fir_alpha(rate, 48000)))
        yield (name, *on(case), geo)


# the block decodes the stream iterators make, by the kernel each one
# launches: the ADPCM and QOA helpers (numpy in and out, ``device`` by
# keyword), and kernel (g)'s wrapper itself, which ``restore_flat`` looks up
# at call time (its staged rows on the device in, the rows it reports
# wrapped, and the wide int64 call for those rows where there are any)
STREAM_DECODES = {"ima": ("aukit_tpu_torch.codecs.adpcm", "ima_adpcm_blocks"),
                  "msadpcm": ("aukit_tpu_torch.codecs.adpcm", "decode_msadpcm_blocks"),
                  "qoa": ("aukit_tpu_torch.codecs.qoa", "qoa_lms_batched"),
                  "lpc": ("aukit_tpu_torch.kernels.flac_cuda", "lpc_restore_kernel")}


def lpc_rows_result(out: torch.Tensor, wrapped) -> np.ndarray:
    """A kernel (g) call's result as numpy: its restored rows in int64, and
    where the call reported wrapped rows, their flags as a last column."""
    rows = out.cpu().numpy().astype(np.int64)
    if wrapped is None:
        return rows
    return np.concatenate([rows, wrapped.cpu().numpy().astype(np.int64)[:, None]], axis=1)


@contextlib.contextmanager
def recorded_stream_decodes():
    """Within the block, every call of a ``STREAM_DECODES`` entry (the
    stream iterators and ``restore_flat`` import them at call time) is
    recorded: yields {kind: [(args, kwargs, result)]}, each result numpy
    (``lpc_rows_result`` for kernel (g)), replayed on another device by
    ``replay``."""
    calls = {kind: [] for kind in STREAM_DECODES}
    saved = []
    for kind, (module_name, name) in STREAM_DECODES.items():
        module = importlib.import_module(module_name)
        fn = getattr(module, name)

        def recording(*args, _fn=fn, _kind=kind, **kwargs):
            out = _fn(*args, **kwargs)
            result = lpc_rows_result(out, kwargs.get("wrapped")) if _kind == "lpc" else out
            calls[_kind].append((args, kwargs, result))
            return out

        # kernel (g)'s wrapper counts its launches on its module's name, the
        # recorder while it stands there: they go back to the wrapper at the end
        recording.launches = recording.wide_launches = 0
        saved.append((module, name, fn))
        setattr(module, name, recording)
    try:
        yield calls
    finally:
        for module, name, fn in saved:
            recording = getattr(module, name)
            for count in ("launches", "wide_launches"):
                if hasattr(fn, count):
                    setattr(fn, count, getattr(fn, count) + getattr(recording, count))
            setattr(module, name, fn)


def replay(kind: str, call, device):
    """A recorded block decode again on ``device`` (the kernel on a card,
    its plain version on the CPU): -> its result, numpy like the first.
    Kernel (g)'s staged rows move to ``device``, with a new ``wrapped``."""
    module_name, name = STREAM_DECODES[kind]
    args, kwargs, _ = call
    fn = getattr(importlib.import_module(module_name), name)
    if kind != "lpc":
        return fn(*args, **{**kwargs, "device": device})
    moved = [a.to(device) if torch.is_tensor(a) else a for a in args]
    wrapped = kwargs.get("wrapped")
    if wrapped is not None:
        wrapped = torch.empty_like(wrapped, device=device)
    return lpc_rows_result(fn(*moved, wrapped=wrapped), wrapped)
