"""Sun AU header parser — copied from ``aukit_tpu.containers.au``
(reference aukit.au, aukit.lua:1639-1651). Big-endian ``.snd`` header:
offset, size, encoding, sample rate, channels."""

from __future__ import annotations

import struct


def parse_au_header(data: bytes):
    try:
        magic, offset, size, encoding, sample_rate, channels = struct.unpack_from(">4sIIIII", data, 0)
    except struct.error as e:
        raise ValueError("invalid AU file (truncated header)") from e
    if magic != b".snd":
        raise ValueError("invalid AU file")
    return offset, size, encoding, sample_rate, channels
