"""WAV ``fmt `` chunk parser and PCM header writer — copied from
``aukit_tpu.containers.wav`` (reference aukit.wav, aukit.lua:1472-1505;
Audio:wav, aukit.lua:942). fmt codes: 1 PCM, 2 MS-ADPCM
(+coefficient table), 3 float, 6 A-law, 7 µ-law, 0x11 IMA ADPCM, 0xFFFE
extensible with UUID dispatch including the DFPWM UUID (aukit.lua:126-140)."""

from __future__ import annotations

import struct

_UUID_TAIL = bytes.fromhex("00001000800000aa00389b71")
WAV_EXTENSIBLE = {
    "dfpwm": bytes.fromhex("3ac1fa38811d4361a40dce53ca607cd1"),
    "pcm": bytes.fromhex("01000000") + _UUID_TAIL,
    "msadpcm": bytes.fromhex("02000000") + _UUID_TAIL,
    "pcm_float": bytes.fromhex("03000000") + _UUID_TAIL,
    "alaw": bytes.fromhex("06000000") + _UUID_TAIL,
    "ulaw": bytes.fromhex("07000000") + _UUID_TAIL,
    "adpcm": bytes.fromhex("11000000") + _UUID_TAIL,
}
_UUID_TO_TYPE = {v: {"pcm": None, "pcm_float": "float"}.get(k, k)
                 for k, v in WAV_EXTENSIBLE.items()}


def parse_fmt(chunk: bytes):
    """fmt chunk -> (data_type, channels, sample_rate, block_align, bit_depth,
    coefficients)."""
    fmt, channels, sample_rate, block_align, bit_depth = struct.unpack_from("<HHI4xHH", chunk, 0)
    coefficients = None
    if fmt == 1:
        data_type = "unsigned" if bit_depth == 8 else "signed"
    elif fmt == 2:
        data_type = "msadpcm"
        (numcoeff,) = struct.unpack_from("<H", chunk, 20)
        if numcoeff > 0:
            c1, c2 = [], []
            for i in range(1, numcoeff + 1):
                a, b = struct.unpack_from("<hh", chunk, i * 4 + 18)
                c1.append(a)
                c2.append(b)
            coefficients = (c1, c2)
    elif fmt == 3:
        data_type = "float"
    elif fmt == 6:
        data_type = "alaw"
    elif fmt == 7:
        data_type = "ulaw"
    elif fmt == 0x11:
        data_type = "adpcm"
    elif fmt == 0xFFFE:
        (bit_depth,) = struct.unpack_from("<H", chunk, 18)
        uuid = chunk[24:40]
        if uuid not in _UUID_TO_TYPE:
            raise ValueError("unsupported WAV file")
        data_type = _UUID_TO_TYPE[uuid]
        if data_type is None:
            data_type = "unsigned" if bit_depth == 8 else "signed"
    else:
        raise ValueError("unsupported WAV file")
    return data_type, channels, sample_rate, block_align, bit_depth, coefficients


def pcm_wav_header(channels: int, sample_rate: int, bit_depth: int, payload_len: int) -> bytes:
    """The PCM WAV header of the reference's Audio:wav (aukit.lua:942, no
    metadata) for a known payload size: wraps a transcoded body so that
    ``header + body`` equals the solo writer's file, RIFF size ``#data + 36``
    included."""
    if bit_depth not in (8, 16, 24, 32):
        raise ValueError("invalid bit depth")
    fmt = struct.pack("<HHIIHH", 1, channels, sample_rate,
                      sample_rate * channels * bit_depth // 8,
                      channels * bit_depth // 8, bit_depth)
    return b"".join([b"RIFF", struct.pack("<I", payload_len + 36), b"WAVE",
                     b"fmt ", struct.pack("<I", 16), fmt,
                     b"data", struct.pack("<I", payload_len)])
