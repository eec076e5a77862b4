"""Resampling as static gather + weight tables — counterpart of
``aukit_tpu.ops.resample``: the whole-file resampler behind
``Audio.resample`` and ``effects.speed``, and the block interpolator the
batched engine runs (reference interpolators aukit.lua:253-284,
Audio:resample aukit.lua:653-673).

The output->input mapping is a static function of (n_in, src_rate, dst_rate,
mode), so index and weight tables are built once in numpy on the host (exact
rational math) and the device work is a handful of ``torch.index_select``
gathers and multiply-adds over the whole ``[L, n_out]`` block. Operations are
written in the order of the JAX package's jitted code, and every multiply
that XLA fuses into the add it feeds is one ``fma_kernel`` call here, so
float32 results agree bit for bit with the JAX engine's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import CONFIG
from ..kernels.fma_cuda import fma_kernel as fma

INTERP_MODES = ("none", "linear", "cubic", "sinc")

# Warm-up sample counts per mode (reference interpolation_start/_end,
# aukit.lua:284), used by the streaming engine.
INTERPOLATION_START = {"none": 1, "linear": 1, "cubic": 0, "sinc": 0}
INTERPOLATION_END = {"none": 1, "linear": 2, "cubic": 3, "sinc": 0}


@functools.lru_cache(maxsize=256)
def resample_plan(n_in: int, src_rate: int, dst_rate: int):
    """Static output->input mapping: (n_out, ffx[int32 n_out], frac[f64 n_out]).

    0-based: out sample i sits at input position t = i*src/dst;
    ffx = floor(t), frac = t - ffx, exact-rational. Output length is
    floor(n_in * dst / src), the Lua numeric-for bound."""
    n_out = (n_in * dst_rate) // src_rate
    i = np.arange(n_out, dtype=np.int64)
    num = i * src_rate
    ffx = num // dst_rate
    rem = num - ffx * dst_rate
    frac = rem.astype(np.float64) / dst_rate
    return n_out, ffx.astype(np.int32), frac


def sinc_weights(frac: np.ndarray, window: int) -> np.ndarray:
    """[n_out, 2W+1] float32 weights: w[i, k] = sinc(pi*(frac[i] - n_k)),
    n_k = k - W (reference aukit.lua:274-283; the n == frac case yields 1)."""
    n = np.arange(-window, window + 1, dtype=np.float64)[None, :]
    px = np.pi * (frac[:, None] - n)
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.where(px == 0.0, 1.0, np.sin(px) / px)
    return w.astype(np.float32)


def block_interp_device(ext: torch.Tensor, n: int, H: int, ffx0, frac, exact,
                        mode: str, w):
    """Interpolate along the last axis of ``ext[..., H + n]`` (H history
    columns; H == 0 is the engine's chunk-local form) with
    ``lua_block_resample``'s edge-fallback semantics, all four modes: missing
    taps fall back toward p1 (the Lua ``or``-chain); sinc taps outside the
    block drop. ``ffx0``/``frac``/``exact`` are the numpy plan, one entry per output,
    and ``w`` the sinc weight rows (sinc mode only)."""
    hi = H + n - 1
    ffx = np.asarray(ffx0, np.int64) + H
    dev = ext.device
    fracj = torch.from_numpy(np.asarray(frac, np.float32)).to(dev)
    exactj = torch.from_numpy(np.asarray(exact, bool)).to(dev)

    def take(idx):
        return torch.index_select(ext, -1, torch.from_numpy(np.clip(idx, 0, hi)).to(dev))

    if mode == "none":
        return take(ffx)
    p1 = take(ffx)
    if mode == "linear":
        p2 = take(np.where(ffx + 1 <= hi, ffx + 1, ffx))
        return torch.where(exactj, p1, fma(p2 - p1, fracj, p1))
    if mode == "cubic":
        p0 = take(np.where(ffx - 1 >= 0, ffx - 1, ffx))
        i2 = np.where(ffx + 1 <= hi, ffx + 1, ffx)
        p2 = take(i2)
        p3 = take(np.where(ffx + 2 <= hi, ffx + 2, i2))
        # the JAX expression as XLA compiles it: each multiply with one use
        # fuses into the add or subtract it feeds (halves and doubles are
        # exact, so their adds round the same either way); f**2 and f**3
        # are folded in float32 at compile time
        fr = np.asarray(frac, np.float32)
        f2 = torch.from_numpy(fr * fr).to(dev)
        f3 = torch.from_numpy(fr * fr * fr).to(dev)
        a1 = fma(p1, 1.5, -0.5 * p0)
        a1 = fma(p2, -1.5, a1) + 0.5 * p3
        a2 = fma(p1, -2.5, p0) + 2.0 * p2 - 0.5 * p3
        a3 = -0.5 * p0 + 0.5 * p2
        val = fma(a3, fracj, fma(a1, f3, a2 * f2)) + p1
        return torch.where(exactj, p1, val)
    if mode != "sinc":
        raise ValueError(f"invalid interpolation mode {mode!r}")
    # taps outside [0, hi] drop through the static valid mask; a tap whose
    # weight column is all zero is skipped, as in the JAX package's loop. As
    # XLA compiles the sum: the first product fuses into the add of the
    # second, every later one into the running sum
    W = (w.shape[1] - 1) // 2
    terms = []
    for t in range(2 * W + 1):
        idx = ffx + (t - W)
        valid = (idx >= 0) & (idx <= hi)
        wt = np.asarray(w[:, t] * valid, np.float32)
        if wt.any():
            terms.append((idx, torch.from_numpy(wt).to(dev)))
    if len(terms) == 1:
        acc = take(terms[0][0]) * terms[0][1]
    else:
        (i0, w0), (i1, w1) = terms[:2]
        acc = fma(take(i0), w0, take(i1) * w1)
        for idx, wt in terms[2:]:
            acc = fma(take(idx), wt, acc)
    return torch.where(exactj, p1, acc)


def resample_audio_array(data: torch.Tensor, src_rate: int, dst_rate: int,
                         mode: str) -> torch.Tensor:
    """Resample float32 ``data[C, N]`` from src_rate to dst_rate using
    ``mode``, on ``data``'s device (Audio:resample, aukit.lua:653): integer
    positions pass the raw sample through; fractional ones are interpolated
    and clamped to [-1, 1]. Linear and cubic are the JAX package's jitted
    arithmetic (``block_interp_device``: the edge fallbacks of
    ``aukit_tpu.ops.resample.resample_audio_array`` are the block form's with
    no history), bit for bit. Sinc adds the 2W+1 weighted taps one by one
    with one rounding each; the JAX package sums them with XLA's dot, whose
    order differs (the JAX tests hold sinc to 2e-6 of the loop oracle)."""
    n_in = data.shape[1]
    n_out, ffx, frac = resample_plan(n_in, src_rate, dst_rate)
    if n_out == 0:
        return data[:, :0]
    if mode not in INTERP_MODES:
        raise ValueError(f"invalid interpolation mode {mode!r}")
    w = sinc_weights(frac, CONFIG.sinc_window_size) if mode == "sinc" else None
    exact = frac == 0.0
    val = block_interp_device(data, n_in, 0, ffx, frac, exact, mode, w)
    return torch.where(torch.from_numpy(exact).to(data.device), val, val.clamp(-1.0, 1.0))
