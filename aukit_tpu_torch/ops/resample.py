"""Resampling as static gather + weight tables — counterpart of the parts of
``aukit_tpu.ops.resample`` that the batched engine runs (reference
interpolators aukit.lua:253-284).

The output->input mapping is a static function of (n_in, src_rate, dst_rate,
mode), so index and weight tables are built once in numpy on the host (exact
rational math) and the device work is a handful of ``torch.index_select``
gathers and multiply-adds over the whole ``[L, n_out]`` block. Operations are
written in the order of the JAX package's jitted code, and every multiply
that XLA fuses into the add it feeds is one ``fma_kernel`` call here, so
float32 results agree bit for bit with the JAX engine's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.fma_cuda import fma_kernel as fma


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
