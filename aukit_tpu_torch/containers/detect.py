"""Format auto-detection (reference aukit.detect, aukit.lua:2136-2195) —
copied from ``aukit_tpu.containers.detect``.

Magic-string checks first, then the headerless-PCM heuristic: try 9 sample
formats at the head and near the tail and accept if all 8 unpacked values sit
within a near-silence band around the format's midpoint without being all
exactly the midpoint. Finally, runs of 12 0x55/0xAA bytes indicate DFPWM.
"""

from __future__ import annotations

import re
import struct

# (struct format for 8 samples, bit depth, data type) — aukit.lua:2136-2146
_DATA_FMTS = [
    ("<8b", 8, "signed"),
    ("<8B", 8, "unsigned"),
    ("<8h", 16, "signed"),
    ("<8i", 32, "signed"),
    ("<8f", 32, "float"),
    (None, 24, "signed"),  # i3 handled manually
    ("<8I", 32, "unsigned"),
    (None, 24, "unsigned"),  # I3 handled manually
    ("<8H", 16, "unsigned"),
]


def _unpack8(fmt, bits, dtype, data: bytes, pos: int):
    """Unpack 8 samples at 0-based pos; None on short data (like pcall)."""
    if pos < 0:
        return None
    if fmt is None:  # 24-bit
        need = 24
        if pos + need > len(data):
            return None
        out = []
        for k in range(8):
            b = data[pos + 3 * k : pos + 3 * k + 3]
            v = b[0] | (b[1] << 8) | (b[2] << 16)
            if dtype == "signed" and v >= 1 << 23:
                v -= 1 << 24
            out.append(v)
        return out
    need = struct.calcsize(fmt)
    if pos + need > len(data):
        return None
    return list(struct.unpack_from(fmt, data, pos))


def detect_format(data: bytes):
    """Returns (type, bit_depth, data_type); bit_depth/data_type only for pcm."""
    if re.match(rb"^RIFF....WAVE", data, re.DOTALL):
        return ("wav", None, None)
    if re.match(rb"^FORM....AIF[FC]", data, re.DOTALL):
        return ("aiff", None, None)
    if data[:4] == b".snd":
        return ("au", None, None)
    if data[:4] == b"fLaC":
        return ("flac", None, None)
    if data[:7] == b"MDFPWM\x03":
        return ("mdfpwm", None, None)
    if data[:4] == b"qoaf":
        return ("qoa", None, None)
    for fmt, bits, dtype in _DATA_FMTS:
        mid = float(1 << (bits - 1)) if dtype == "unsigned" else 0.0
        gap = 0.001 if dtype == "float" else 8.0 * (1 << (bits - 8))
        # head, then tail at Lua position (#data - bits) 1-based = len-bits-1 0-based
        for pos in (0, len(data) - bits - 1):
            nums = _unpack8(fmt, bits, dtype, data, pos)
            if nums is None:
                continue
            allzero = all(v == mid for v in nums)
            ok = all(mid - gap <= v <= mid + gap for v in nums)
            if ok and not allzero:
                return ("pcm", bits, dtype)
    if re.search(b"\x55" * 12, data) or re.search(b"\xaa" * 12, data):
        return ("dfpwm", None, None)
    return (None, None, None)
