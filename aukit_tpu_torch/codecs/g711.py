"""G.711 µ-law / A-law decode — counterpart of ``aukit_tpu.codecs.g711``:
the whole-file loader's 256-entry lookup table on the host (copied), and the
engine's elementwise torch ops (``decode_g711_device``).

Expansion rules (aukit.lua:1371-1382), for byte ``raw``:
  b = raw XOR (ulaw ? 0xFF : 0x55)
  m = b & 0x0F ; e = (b >> 4) & 0x07
  A-law, e == 0 : m = m*4 + 2        else : m = (m*2 + 33) << e
  µ-law         : m = ((m*2 + 33) << e) - 33
  sign          : negative iff (bit7 of b) == ulaw
The loader's table divides by ``denom`` in float64 and rounds once; the
device form multiplies by float32(1 / denom), as in the JAX package: a
division would round differently for a scale that is not a power of two.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def g711_expand_lut(ulaw: bool) -> np.ndarray:
    """int32[256]: signed linear magnitude*sign per raw input byte, before the
    final scale divide."""
    raw = np.arange(256, dtype=np.int64)
    b = raw ^ (0xFF if ulaw else 0x55)
    m = b & 0x0F
    e = (b >> 4) & 0x07
    if ulaw:
        m = ((m * 2 + 33) << e) - 33
    else:
        m = np.where(e == 0, m * 4 + 2, (m * 2 + 33) << np.minimum(e, 62))
    negative = ((b & 0x80) != 0) == ulaw
    return np.where(negative, -m, m).astype(np.int32)


@functools.lru_cache(maxsize=8)
def g711_float_lut(ulaw: bool, denom: int) -> np.ndarray:
    """float32[256]: final float sample per raw byte at the given scale
    (0x2000 for the loader, 0x40 for the int8 stream path)."""
    return (g711_expand_lut(ulaw).astype(np.float64) / denom).astype(np.float32)


def decode_g711(data: bytes, ulaw: bool, channels: int = 1, denom: int = 0x2000) -> np.ndarray:
    """bytes -> [channels, N] float32 on the host (reference aukit.g711,
    aukit.lua:1361). Channel c receives bytes at positions ``i % channels == c``."""
    lut = g711_float_lut(bool(ulaw), denom)
    raw = np.frombuffer(data, dtype=np.uint8)
    vals = lut[raw]
    n = len(vals) // channels
    vals = vals[: n * channels]
    if channels > 1:
        return np.ascontiguousarray(vals.reshape(n, channels).T)
    return vals.reshape(1, -1)


def decode_g711_device(raw_u8: torch.Tensor, ulaw: bool, channels: int,
                       denom: int) -> torch.Tensor:
    """uint8[..., N] -> float32[..., C, N//C] (channel c takes the bytes at
    positions ``i % channels == c``)."""
    b = raw_u8.to(torch.int32) ^ (0xFF if ulaw else 0x55)
    m = b & 0x0F
    e = (b >> 4) & 0x7
    if ulaw:
        mag = ((m * 2 + 33) << e) - 33
    else:
        mag = torch.where(e == 0, m * 4 + 2, (m * 2 + 33) << e)
    negative = ((b & 0x80) != 0) == bool(ulaw)
    vals = torch.where(negative, -mag, mag).to(torch.float32) * float(np.float32(1.0 / denom))
    if channels > 1:
        n = vals.shape[-1] // channels
        vals = vals[..., : n * channels]
        return vals.reshape(*vals.shape[:-1], n, channels).transpose(-1, -2)
    return vals[..., None, :]
