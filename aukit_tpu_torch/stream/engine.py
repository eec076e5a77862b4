"""Host block resample and recursive lowpass of the FLAC fleet's host route —
the parts of ``aukit_tpu.stream.engine`` the fleet calls, copied. numpy in
float64, bit-equal to the JAX package's host route (the native twins in
``native/flacbits.cpp`` replay the numpy operation order)."""

from __future__ import annotations

import functools

import numpy as np

from ..config import CONFIG
from ..ops.resample import sinc_weights


def iir_lowpass_scan(x: np.ndarray, alpha: float, state: np.ndarray):
    """First-order IIR y_i = y_{i-1} + alpha*(x_i - y_{i-1}) over the last axis
    with initial state, evaluated by recursive doubling (O(n log n) vector ops,
    no per-sample Python loop). Returns (y, final_state). The reference's
    FLAC lowpass is truly recursive (aukit.lua:3178). ``state`` must be shaped
    like ``x[..., 0]``. The native twin (flacbits.cpp::iir_scan_rows) replays
    the identical doubling pass order — bit-equal, in place."""
    from ..native import flacbits as _nb

    if _nb.available() and np.ndim(x) >= 1 and x.shape[-1] > 0 \
            and np.shape(state) == np.shape(x)[:-1]:
        return _nb.iir_scan_rows(np.asarray(x, np.float64), alpha, state)
    c = 1.0 - alpha
    b = x * alpha
    b[..., 0] += c * state
    y = b
    ck = c
    shift = 1
    n = y.shape[-1]
    while shift < n:
        if ck == 0.0:  # f64 underflow: every further doubling pass adds
            break  # exactly +0.0 — skipping is bit-identical
        y[..., shift:] += ck * y[..., :-shift]
        ck = ck * ck
        shift *= 2
    return y, y[..., -1].copy()


@functools.lru_cache(maxsize=512)
def block_resample_plan(n_in: int, in_rate: int, out_rate: int, mode: str, window: int,
                        out_len: int | None = None):
    """Tables for resampling ONE block of n_in samples the Lua way:
    out i (0-based) at x = i*in/out + 1 (Lua 1-based), out_len =
    floor(n_in*out/in) unless given. Returns (out_len, ffx0, frac, exact,
    sinc weights) with ffx0 0-based relative to the block start."""
    if out_len is None:
        out_len = (n_in * out_rate) // in_rate
    i = np.arange(out_len, dtype=np.int64)
    num = i * in_rate
    ffx0 = num // out_rate
    rem = num - ffx0 * out_rate
    frac = rem.astype(np.float64) / out_rate
    exact = rem == 0
    w = sinc_weights(frac, window).astype(np.float64) if mode == "sinc" else None
    return out_len, ffx0, frac, exact, w


def lua_block_resample(
    ext: np.ndarray,
    hist_valid: int,
    n_in: int,
    in_rate: int,
    out_rate: int,
    mode: str,
    interp_clamp: tuple | None = None,
    out_len: int | None = None,
    hist: int | None = None,
) -> np.ndarray:
    """Resample one block with Lua edge-fallback semantics (aukit.lua:253-284):
    ``ext[..., H + n_in]`` where the last ``n_in`` columns are the block
    (Lua d[1..n]) and the preceding H columns are history (Lua d[<=0], of which
    only the trailing ``hist_valid`` are real). Missing p0 falls back to p1,
    missing p2 to p1, missing p3 to p2->p1; sinc skips missing taps.
    Vectorized over arbitrary leading dims. Returns float64 [..., out_len]."""
    H = ext.shape[-1] - n_in if hist is None else hist
    window = CONFIG.sinc_window_size
    out_len, ffx0, frac, exact, w = block_resample_plan(n_in, in_rate, out_rate, mode, window,
                                                        out_len)
    if out_len == 0:
        return np.zeros(ext.shape[:-1] + (0,), np.float64)
    ffx = ffx0 + H  # position of Lua d[floor(x)] within ext
    lo = H - hist_valid
    hi = ext.shape[-1] - 1

    if mode in ("none", "linear"):
        from ..native import flacbits as _nb

        if _nb.available():
            # fused native gather+lerp over rows (bit-identical f64 order)
            return _nb.block_resample_rows(
                np.asarray(ext, np.float64), ffx, frac, exact, out_len, mode,
                interp_clamp)

    def take(idx):
        return np.take(ext, np.clip(idx, 0, hi), axis=-1)

    def clip(v):
        if interp_clamp is None:
            return v
        return np.clip(v, interp_clamp[0], interp_clamp[1])

    if mode == "none":
        return take(ffx).astype(np.float64)
    if mode == "linear":
        p1 = take(ffx)
        p2 = take(np.where(ffx + 1 <= hi, ffx + 1, ffx))
        return np.where(exact, p1, clip(p1 + (p2 - p1) * frac))
    if mode == "cubic":
        p1 = take(ffx)
        p0 = take(np.where(ffx - 1 >= lo, ffx - 1, ffx))
        i2 = np.where(ffx + 1 <= hi, ffx + 1, ffx)
        p2 = take(i2)
        p3 = take(np.where(ffx + 2 <= hi, ffx + 2, i2))
        val = (
            (-0.5 * p0 + 1.5 * p1 - 1.5 * p2 + 0.5 * p3) * frac**3
            + (p0 - 2.5 * p1 + 2.0 * p2 - 0.5 * p3) * frac**2
            + (-0.5 * p0 + 0.5 * p2) * frac
            + p1
        )
        return np.where(exact, p1, clip(val))
    # sinc
    acc = np.zeros(ext.shape[:-1] + (out_len,), np.float64)
    for t in range(2 * window + 1):
        idx = ffx + (t - window)
        valid = (idx >= lo) & (idx <= hi)
        acc += take(idx) * (w[:, t] * valid)
    return np.where(exact, take(ffx), clip(acc))
