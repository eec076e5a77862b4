"""MDFPWMv3 header parser — copied from ``aukit_tpu.containers.mdfpwm``
(reference aukit.mdfpwm, aukit.lua:1420-1448). Layout: ``"MDFPWM\\x03"``
magic, <I sample-pair length, three 1-byte length-prefixed strings (artist,
title, album), then alternating 6000-byte L/R DFPWM blocks."""

from __future__ import annotations

import struct

MAGIC = b"MDFPWM\x03"


def parse_mdfpwm_header(data: bytes):
    """-> (length, artist, title, album, payload offset)."""
    if data[:7] != MAGIC:
        raise ValueError("not a MDFPWM file")
    (length,) = struct.unpack_from("<I", data, 7)
    pos = 11
    strs = []
    for _ in range(3):
        slen = data[pos]
        strs.append(data[pos + 1 : pos + 1 + slen].decode("latin-1"))
        pos += 1 + slen
    artist, title, album = strs
    return length, artist, title, album, pos
