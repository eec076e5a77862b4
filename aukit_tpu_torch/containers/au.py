"""Sun AU container (reference aukit.au, aukit.lua:1639-1651) — counterpart of
``aukit_tpu.containers.au`` (host parse and decode copied; the Audio lands
on the caller's device).

Big-endian ``.snd`` header: offset, size, encoding, sample rate, channels.
Encodings: 1 µ-law, 2-5 signed PCM 8/16/24/32, 6 float32, 27 A-law.
size == 0xFFFFFFFF means "to end of data".
"""

from __future__ import annotations

import struct

from ..audio import Audio, new_audio
from ..config import require_device
from ..ops import pcmcode

_PCM_DEPTH = {2: 8, 3: 16, 4: 24, 5: 32}


def parse_au_header(data: bytes):
    try:
        magic, offset, size, encoding, sample_rate, channels = struct.unpack_from(">4sIIIII", data, 0)
    except struct.error as e:
        raise ValueError("invalid AU file (truncated header)") from e
    if magic != b".snd":
        raise ValueError("invalid AU file")
    return offset, size, encoding, sample_rate, channels


def decode_au(data: bytes, device="cuda") -> Audio:
    """AU bytes -> Audio on ``device`` (reference aukit.au, aukit.lua:1639)."""
    device = require_device(device, "decode_au")
    offset, size, encoding, sample_rate, channels = parse_au_header(data)
    # The reference uses the header's 0-based byte offset directly as a Lua
    # 1-based string index (aukit.lua:1643), so the payload starts one byte
    # early; replicated, as in the JAX package.
    start = offset - 1
    payload = data[start:] if size == 0xFFFFFFFF else data[start: start + size]
    if encoding == 1 or encoding == 27:
        from ..codecs.g711 import decode_g711

        arr = decode_g711(payload, encoding == 1, channels, denom=0x2000)
        return new_audio(arr, sample_rate,
                         {"bitDepth": 14 if encoding == 1 else 13, "dataType": "signed"}, {},
                         device)
    if encoding in _PCM_DEPTH:
        depth = _PCM_DEPTH[encoding]
        arr = pcmcode.decode_pcm(payload, depth, "signed", channels, True, True)
        return new_audio(arr, sample_rate, {}, {"bitDepth": depth, "dataType": "signed"}, device)
    if encoding == 6:
        arr = pcmcode.decode_pcm(payload, 32, "float", channels, True, True)
        return new_audio(arr, sample_rate, {}, {"bitDepth": 32, "dataType": "float"}, device)
    raise ValueError(f"unsupported encoding type {encoding}")
