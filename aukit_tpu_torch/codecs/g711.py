"""G.711 µ-law / A-law decode as elementwise torch ops — counterpart of
``aukit_tpu.codecs.g711.decode_g711_device``.

Expansion rules (aukit.lua:1371-1382), for byte ``raw``:
  b = raw XOR (ulaw ? 0xFF : 0x55)
  m = b & 0x0F ; e = (b >> 4) & 0x07
  A-law, e == 0 : m = m*4 + 2        else : m = (m*2 + 33) << e
  µ-law         : m = ((m*2 + 33) << e) - 33
  sign          : negative iff (bit7 of b) == ulaw
then a multiply by float32(1 / denom), as in the JAX package: a division
would round differently for a scale that is not a power of two.
"""

from __future__ import annotations

import numpy as np
import torch


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
