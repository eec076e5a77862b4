"""WAV container: parser (reference aukit.wav, aukit.lua:1456-1574) and writer
(reference Audio:wav, aukit.lua:942-997) — counterpart of
``aukit_tpu.containers.wav``.

Host-side parsing (copied) produces numpy views and a codec dispatch; the
codecs decode on the caller's device: IMA ADPCM blocks through kernel (d),
MS ADPCM blocks through kernel (e), DFPWM through kernel (a) (read) and (c)
(write, ``bit_depth == 1``); PCM, float and G.711 decode on the host.

Parity notes:
 - fmt codes: 1 PCM, 2 MS-ADPCM (+coefficient table), 3 float, 6 a-law,
   7 µ-law, 0x11 IMA ADPCM, 0xFFFE extensible with UUID dispatch including the
   DFPWM UUID (aukit.lua:126, wavExtensible table at 131-140).
 - IMA blocks: stereo 8-byte header (<hBx per channel), nibble groups of
   4 bytes per channel alternating, low nibble first (aukit.lua:1511-1541);
   mono 4-byte header with the step index masked to 0x0F, a reference loader
   quirk (aukit.lua:1544) replicated here; a stereo step index above 88
   raises, as the reference's range check does.
 - LIST/INFO metadata round-trip with the wavMetadata key map (aukit.lua:193).
 - Writer quirks kept: RIFF size field excludes the LIST chunk length
   (aukit.lua:989); 8-bit data is unsigned, higher depths signed.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ..audio import Audio, new_audio
from ..config import require_device
from ..ops import pcmcode

WAV_METADATA = {
    "IPRD": "album", "INAM": "title", "IART": "artist", "IWRI": "author",
    "IMUS": "composer", "IPRO": "producer", "IPRT": "trackNumber",
    "ITRK": "trackNumber", "IFRM": "trackCount", "PRT1": "partNumber",
    "PRT2": "partCount", "TLEN": "length", "IRTD": "rating", "ICRD": "date",
    "ITCH": "encodedBy", "ISFT": "encoder", "ISRF": "media", "IGNR": "genre",
    "ICMT": "comment", "ICOP": "copyright", "ILNG": "language",
}

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

# channel masks for WAVE_FORMAT_EXTENSIBLE, indexed by channel count
# (aukit.lua:142-155)
WAV_EXTENSIBLE_CHANNELS = [
    0x04, 0x03, 0x07, 0x33, 0x37, 0x3F, 0x637, 0x63F, 0x50F7, 0x50FF, 0x56F7, 0x56FF,
]


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


def parse_list_info(payload: bytes, meta: dict):
    """LIST/INFO chunk walk (aukit.lua:1563-1572): c4 key + s4 value + 2-align."""
    pos = 0
    while pos + 8 <= len(payload):
        key = payload[pos: pos + 4].decode("latin-1")
        (size,) = struct.unpack_from("<I", payload, pos + 4)
        val = payload[pos + 8: pos + 8 + size].decode("latin-1").rstrip("\x00")
        pos += 8 + size + (size % 2)
        if key in WAV_METADATA:
            try:
                meta[WAV_METADATA[key]] = int(val)
            except ValueError:
                try:
                    meta[WAV_METADATA[key]] = float(val)
                except ValueError:
                    meta[WAV_METADATA[key]] = val


def regroup_ima_stereo(body: np.ndarray) -> np.ndarray:
    """Stereo IMA nibble regrouping (aukit.lua:1511-1541): data bytes arrive in
    alternating 4-byte channel groups; each byte holds (low, high) nibbles in
    decode order. ``body``: uint8[..., ngroups*8], the data regions of one or
    more blocks -> int32[..., 2, ngroups*8] nibble lanes (channel, then time)."""
    g = body.reshape(*body.shape[:-1], -1, 2, 4)  # [..., ngroups, channel, 4 bytes]
    lo = (g & 0x0F).astype(np.int32)
    hi = (g >> 4).astype(np.int32)
    nib = np.stack([lo, hi], axis=-1).reshape(*g.shape[:-1], 8)  # lo/hi interleave
    return np.moveaxis(nib, -2, -3).reshape(*body.shape[:-1], 2, -1)


def decode_wav(data: bytes, head: bool = False, device="cuda") -> Audio:
    """WAV bytes -> Audio on ``device`` (reference aukit.wav, aukit.lua:1456)."""
    device = require_device(device, "decode_wav")
    try:
        return _decode_wav(data, head, device)
    except struct.error as e:
        raise ValueError("invalid WAV file (truncated)") from e


def _decode_wav(data: bytes, head: bool, device) -> Audio:
    if data[:4] != b"RIFF":
        raise ValueError("not a WAV file")
    if data[8:12] != b"WAVE":
        raise ValueError("not a WAV file")
    pos = 12
    meta: dict = {}
    obj: Audio | None = None
    channels = sample_rate = bit_depth = block_align = None
    data_type = None
    coefficients = None
    n = len(data)
    while pos + 8 <= n:
        cid = data[pos: pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        pos += 8
        if cid == b"fmt ":
            chunk = data[pos: pos + size]
            (data_type, channels, sample_rate, block_align, bit_depth,
             coefficients) = parse_fmt(chunk)
            pos += size
        elif cid == b"data":
            payload = data[pos: pos + size]
            if len(payload) < size:
                raise ValueError("invalid WAV file")
            if head:
                arr = np.zeros((channels, 0), np.float32)
            elif data_type == "adpcm":
                arr = _decode_ima_wav_data(payload, block_align, channels, device)
            elif data_type == "msadpcm":
                from ..codecs.adpcm import decode_msadpcm

                preds = decode_msadpcm(payload, block_align, channels, coefficients,
                                       device=device)
                arr = pcmcode.normalize_pcm(preds, 16, "signed")
            elif data_type in ("alaw", "ulaw"):
                from ..codecs.g711 import decode_g711

                arr = decode_g711(payload, data_type == "ulaw", channels, denom=0x2000)
            elif data_type == "dfpwm":
                from ..codecs.dfpwm import decode_dfpwm_audio

                arr = decode_dfpwm_audio(payload, channels, device=device)
            else:
                arr = pcmcode.decode_pcm(payload, bit_depth, data_type, channels, True, False)
            obj = new_audio(arr, sample_rate, device=device)
            obj.metadata = meta
            obj.info = {"dataType": data_type, "bitDepth": bit_depth}
            pos += size
        elif cid == b"LIST":
            if data[pos: pos + 4] == b"INFO":
                parse_list_info(data[pos + 4: pos + size], meta)
            pos += size
        else:  # fact and unknown chunks skipped (aukit.lua:1558)
            pos += size
    if obj is None:
        raise ValueError("invalid WAV file")
    return obj


def _decode_ima_wav_data(payload: bytes, block_align: int, channels: int,
                         device) -> np.ndarray:
    """IMA ADPCM data region -> float32[C, N] (numpy): block-parallel decode
    by kernel (d), lanes = blocks*channels (the reference decodes block by
    block then concatenates, aukit.lua:1508)."""
    from ..codecs.adpcm import ima_adpcm_blocks

    raw = np.frombuffer(payload, dtype=np.uint8)
    nblocks = len(raw) // block_align
    raw = raw[: nblocks * block_align].reshape(nblocks, block_align)
    if channels == 2:
        hdr = raw[:, :8]
        pred16 = np.stack(
            [hdr[:, 0:2].copy().view("<i2")[:, 0], hdr[:, 4:6].copy().view("<i2")[:, 0]], axis=1
        ).astype(np.int32)
        sidx = np.stack([hdr[:, 2], hdr[:, 6]], axis=1).astype(np.int32)
        if sidx.size and sidx.max() > 88:
            # the reference errors via expect.range(step_index, 0, 88)
            raise ValueError("invalid WAV file: IMA step index out of range")
        ngroups = (block_align - 8) // 8
        body = raw[:, 8: 8 + ngroups * 8]
        lanes = regroup_ima_stereo(body).reshape(nblocks * 2, -1)  # [B*2, T]
        preds = ima_adpcm_blocks(lanes, pred16.reshape(-1), sidx.reshape(-1), device)
        chan = preds.reshape(nblocks, 2, -1).transpose(1, 0, 2).reshape(2, -1)
        return pcmcode.normalize_pcm(chan, 16, "signed")
    pred16 = raw[:, 0:2].copy().view("<i2")[:, 0].astype(np.int32)
    sidx = (raw[:, 2] & 0x0F).astype(np.int32)  # the reference's mask (aukit.lua:1544)
    body = raw[:, 4:]
    lo = (body & 0x0F).astype(np.int32)
    hi = (body >> 4).astype(np.int32)
    nibs = np.stack([lo, hi], axis=-1).reshape(nblocks, -1)  # low nibble first
    preds = ima_adpcm_blocks(nibs, pred16, sidx, device)
    return pcmcode.normalize_pcm(preds.reshape(1, -1), 16, "signed")


# -- writer ---------------------------------------------------------------------

def _info_list(metadata: dict) -> bytes | None:
    """Reverse-map metadata to an INFO LIST payload (aukit.lua:948-957)."""
    if not metadata:
        return None
    parts = [b"INFO"]
    for key, value in metadata.items():
        for tag, name in WAV_METADATA.items():
            if name == key:
                s = str(value).encode("latin-1")
                parts.append(tag.encode("latin-1") + struct.pack("<I", len(s)) + s)
                if len(s) % 2:
                    parts.append(b"\x00")
                break
    return b"".join(parts)


def encode_wav(audio: Audio, bit_depth: int = 16) -> bytes:
    """Audio -> WAV bytes (reference Audio:wav, aukit.lua:942). ``bit_depth=1``
    writes DFPWM (kernel (c) on the audio's device) in a
    WAVE_FORMAT_EXTENSIBLE container with a fact chunk."""
    channels = audio.channels
    sr = audio.sample_rate
    if bit_depth == 1:
        payload = audio.dfpwm(True)
        mask = WAV_EXTENSIBLE_CHANNELS[channels - 1] if channels <= 12 else 0
        fmt = struct.pack(
            "<HHIIHHHHI16s",
            0xFFFE, channels, sr, sr * channels // 8, math.ceil(channels / 8), 1,
            22, 1, mask, WAV_EXTENSIBLE["dfpwm"],
        )
        fact = struct.pack("<I", audio.num_samples)
        info = _info_list(audio.metadata)
        out = [b"RIFF", struct.pack("<I", len(payload) + 72), b"WAVE"]
        out += [b"fmt ", struct.pack("<I", 40), fmt]
        out += [b"fact", struct.pack("<I", 4), fact]
        if info:
            out += [b"LIST", struct.pack("<I", len(info)), info]
        out += [b"data", struct.pack("<I", len(payload)), payload]
        return b"".join(out)
    if bit_depth not in (8, 16, 24, 32):
        raise ValueError("invalid bit depth")
    data_type = "unsigned" if bit_depth == 8 else "signed"
    payload = audio.to_pcm_bytes(bit_depth, data_type, interleaved=True, big_endian=False)
    fmt = struct.pack(
        "<HHIIHH", 1, channels, sr, sr * channels * bit_depth // 8,
        channels * bit_depth // 8, bit_depth,
    )
    info = _info_list(audio.metadata)
    # reference quirk: the RIFF size field is #data + 36 regardless of LIST
    out = [b"RIFF", struct.pack("<I", len(payload) + 36), b"WAVE"]
    out += [b"fmt ", struct.pack("<I", 16), fmt]
    if info:
        out += [b"LIST", struct.pack("<I", len(info)), info]
    out += [b"data", struct.pack("<I", len(payload)), payload]
    return b"".join(out)
