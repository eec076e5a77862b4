"""Plain 48 kHz DSP of a decoded lane, as the system states it: normalise,
per-lane one-pole filter, chunk-local resample, two-tap smoothing, int8.

Every function takes ``dtype``: float32 is the precision the system states,
with each multiply that feeds an add rounded once (a fused multiply-add, as
the system's jitted reference computes it); the benchmark's control passes
bfloat16, the precision below, where a multiply and an add round apart.
"""

from __future__ import annotations

import numpy as np
import torch


def norm8(v: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Decoded 8-bit samples -> [-1, 1]: negatives divide by 128, the rest by
    127 (a true division)."""
    return v.to(dtype) / torch.where(v < 0, 128.0, 127.0).to(dtype)


def norm16(v: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """16-bit samples -> [-1, 1]: negatives divide by 32768, the rest by 32767."""
    return v.to(dtype) / torch.where(v < 0, 32768.0, 32767.0).to(dtype)


def _fma32(x, y, z) -> torch.Tensor:
    """float32 ``x * y + z`` rounded once: the product is exact in float64,
    the sum is rounded to odd there (TwoSum gives its error), and rounding
    that to float32 is then correct."""
    x, y, z = (torch.as_tensor(a, dtype=torch.float64) for a in (x, y, z))
    p = x * y
    s = p + z
    bp = s - p
    err = (p - (s - bp)) + (z - bp)
    bits = s.view(torch.int64)
    to_odd = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return (bits + to_odd * step).view(torch.float64).to(torch.float32)


def fma(x, y, z, dtype=torch.float32) -> torch.Tensor:
    """``x * y + z`` in ``dtype``: one rounding in float32, two below it."""
    if dtype == torch.float32:
        return _fma32(*torch.broadcast_tensors(*(_on(a, x, y, z) for a in (x, y, z))))
    x, y, z = (_on(a, x, y, z).to(dtype) for a in (x, y, z))
    return x * y + z


def _on(a, *others) -> torch.Tensor:
    """``a`` as a tensor on the device of the first tensor among ``others``;
    a Python number becomes a float32 constant."""
    dev = next(o.device for o in others if isinstance(o, torch.Tensor))
    if isinstance(a, torch.Tensor):
        return a
    return torch.tensor(float(np.float32(a)), dtype=torch.float32, device=dev)


def smoothing_alpha(in_rate: int, out_rate: int = 48000) -> float:
    """The two-tap smoothing constant of a lane at ``in_rate``: a one-pole
    coefficient at a cutoff of half the input rate, taken at the output rate,
    rounded to float32."""
    return float(np.float32(1.0 - np.exp(-(in_rate / (out_rate * 2)) * 2.0 * np.pi)))


def resample_linear(x: torch.Tensor, in_rate: int, out_rate: int = 48000,
                    dtype=torch.float32) -> torch.Tensor:
    """[N, n] at ``in_rate`` -> [N, n * out_rate // in_rate]: output sample i
    sits at input position i * in_rate / out_rate; a whole position takes its
    sample, else the two neighbours are interpolated, the right one clamped
    to the chunk's last sample (the chunk-local resample)."""
    n = x.shape[-1]
    if in_rate == out_rate:
        return x
    n_out = n * out_rate // in_rate
    num = np.arange(n_out, dtype=np.int64) * in_rate
    ffx = num // out_rate
    frac = (num - ffx * out_rate).astype(np.float32) / np.float32(out_rate)
    dev = x.device
    p1 = x[:, torch.from_numpy(ffx).to(dev)]
    p2 = x[:, torch.from_numpy(np.minimum(ffx + 1, n - 1)).to(dev)]
    fr = torch.from_numpy(frac).to(dev)
    return torch.where(fr == 0, p1, fma(p2 - p1, fr, p1, dtype).to(x.dtype))


def smooth_int8(s: torch.Tensor, prev0: torch.Tensor, alpha: float,
                dtype=torch.float32) -> torch.Tensor:
    """The output stage: ``prev + alpha * (s - prev)`` with prev the previous
    sample (``prev0`` before the first), scaled by 128 below zero and 127
    above, clipped and truncated to int8."""
    s = s.to(dtype)
    prev = torch.cat([prev0.to(dtype)[:, None], s[:, :-1]], dim=1)
    out = fma(alpha, s - prev, prev, dtype).to(dtype)
    out = out * torch.where(out < 0, 128.0, 127.0).to(dtype)
    return out.clamp(-128.0, 127.0).to(torch.int8)


def onepole_lowpass(x: torch.Tensor, a: float, y_prev: torch.Tensor, started: torch.Tensor,
                    dtype=torch.float64, block: int = 4096):
    """``y[t] = (1 - a) * y[t-1] + a * x[t]`` along the last axis of ``x``
    [N, T], one step a sample in ``dtype``, from ``y_prev``; a stream whose
    filter has not started takes ``y[0] = x[0]``. Returns (y as float32
    [N, T], the last y in ``dtype``)."""
    n, T = x.shape
    dev = x.device
    c = torch.tensor(1.0 - a, dtype=torch.float64).to(dtype).to(dev)
    av = torch.tensor(a, dtype=torch.float64).to(dtype).to(dev)
    out = torch.empty((T, n), dtype=torch.float32, device=dev)
    cur = y_prev.to(dtype)
    for t0 in range(0, T, block):
        ax = x[:, t0:t0 + block].to(dtype).t().contiguous() * av
        for j in range(ax.shape[0]):
            if t0 + j == 0:
                cur = torch.where(started, cur * c + ax[0], x[:, 0].to(dtype))
            else:
                cur = cur * c + ax[j]
            out[t0 + j] = cur
    return out.t(), cur
