"""AIFF ``COMM`` sample-rate decode — copied from ``aukit_tpu.containers.aiff``.

The reference reads the 80-bit extended rate as exponent u16 +
top-7-bytes-of-mantissa u56 and reconstructs it as
``ldexp(sign * m / 2^56, ((e & 0x7FFF) - 0x3FFE) % 0x800)``
(aukit.lua:1603-1605)."""

from __future__ import annotations

import math


def parse_comm_rate(e: int, m: int) -> float:
    s = (e & 0x8000) != 0
    e2 = ((e & 0x7FFF) - 0x3FFE) % 0x800
    return math.ldexp((-m if s else m) / float(1 << 56), e2)
