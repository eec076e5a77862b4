"""AIFF / AIFC container (reference aukit.aiff, aukit.lua:1580-1634) —
counterpart of ``aukit_tpu.containers.aiff`` (host parse and PCM / G.711
decode copied; the Audio lands on the caller's device).

COMM chunk layout (big-endian): channels i16, numSampleFrames u32,
bitDepth i16, then the 80-bit extended sample rate which the reference reads
as exponent u16 + top-7-bytes-of-mantissa u56 + 1 pad byte and reconstructs as
``ldexp(sign * m / 2^56, ((e & 0x7FFF) - 0x3FFE) % 0x800)`` (aukit.lua:1603-1605).
AIFC adds a compression c4 + even-padded pascal string.
Compressions: NONE (BE PCM), sowt (LE PCM), fl32/FL32 (float), alaw/ulaw (G.711).
Metadata chunks (NAME/AUTH/"(c) "/ANNO) are only honored before SSND, because
the reference returns from inside the SSND branch.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ..audio import Audio, loaded_audio
from ..config import require_device
from ..ops import pcmcode


def parse_comm_rate(e: int, m: int) -> float:
    s = (e & 0x8000) != 0
    e2 = ((e & 0x7FFF) - 0x3FFE) % 0x800
    return math.ldexp((-m if s else m) / float(1 << 56), e2)


def decode_aiff(data: bytes, head: bool = False, device="cuda") -> Audio:
    """AIFF/AIFC bytes -> Audio on ``device`` (reference aukit.aiff, aukit.lua:1580)."""
    device = require_device(device, "decode_aiff")
    try:
        return _decode_aiff(data, head, device)
    except struct.error as e:
        raise ValueError("invalid AIFF file (truncated)") from e


def _decode_aiff(data: bytes, head: bool, device) -> Audio:
    if data[:4] != b"FORM":
        raise ValueError("not an AIFF file")
    form_type = data[8:12]
    if form_type == b"AIFC":
        is_aifc = True
    elif form_type == b"AIFF":
        is_aifc = False
    else:
        raise ValueError("not an AIFF file")
    pos = 12
    meta: dict = {}
    channels = sample_rate = bit_depth = length = None
    compression = None
    n = len(data)
    while pos + 8 <= n:
        cid = data[pos: pos + 4]
        (size,) = struct.unpack_from(">I", data, pos + 4)
        pos += 8
        if cid == b"COMM":
            channels, frames, bit_depth, e = struct.unpack_from(">hIhH", data, pos)
            m = int.from_bytes(data[pos + 10: pos + 17], "big")
            cpos = pos + 18
            if is_aifc:
                compression = data[cpos: cpos + 4].decode("latin-1")
                slen = data[cpos + 4]
                cpos += 5 + slen
                if slen % 2 == 0:
                    cpos += 1
            length = frames * channels * (bit_depth // 8)
            sample_rate = parse_comm_rate(e, m)
            pos = cpos
        elif cid == b"SSND":
            offset, _block_align = struct.unpack_from(">II", data, pos)
            start = pos + 8 + offset
            payload = data[start: start + length]
            sr = int(sample_rate) if sample_rate == int(sample_rate) else sample_rate
            info: dict = {}
            if head:
                arr = np.zeros((channels, 0), np.float32)
            elif compression is None or compression == "NONE":
                arr = pcmcode.decode_pcm(payload, bit_depth, "signed", channels, True, True)
                info = {"bitDepth": bit_depth, "dataType": "signed"}
            elif compression == "sowt":
                arr = pcmcode.decode_pcm(payload, bit_depth, "signed", channels, True, False)
                info = {"bitDepth": bit_depth, "dataType": "signed"}
            elif compression in ("fl32", "FL32"):
                arr = pcmcode.decode_pcm(payload, 32, "float", channels, True, True)
                info = {"bitDepth": 32, "dataType": "float"}
            elif compression in ("alaw", "ulaw", "ALAW", "ULAW"):
                from ..codecs.g711 import decode_g711

                arr = decode_g711(payload, compression in ("ulaw", "ULAW"), channels, denom=0x2000)
            else:
                raise ValueError(f"Unsupported compression scheme {compression}")
            return loaded_audio(arr, sr, meta, info, device)
        elif cid == b"NAME":
            meta["title"] = data[pos: pos + size].decode("latin-1")
            pos += size
        elif cid == b"AUTH":
            meta["artist"] = data[pos: pos + size].decode("latin-1")
            pos += size
        elif cid == b"(c) ":
            meta["copyright"] = data[pos: pos + size].decode("latin-1")
            pos += size
        elif cid == b"ANNO":
            meta["comment"] = data[pos: pos + size].decode("latin-1")
            pos += size
        else:
            pos += size
    raise ValueError("invalid AIFF file")
