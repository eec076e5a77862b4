"""MDFPWMv3 container (reference aukit.mdfpwm, aukit.lua:1420-1448) —
counterpart of ``aukit_tpu.containers.mdfpwm``.

Layout: ``"MDFPWM\\x03"`` magic, <I sample-pair length, three 1-byte
length-prefixed strings (artist, title, album), then alternating 6000-byte
L/R DFPWM blocks. Stereo 48 kHz by definition. Decoded with two independent
DFPWM decoders on the caller's device: kernel (a) on two lanes over the
channels' common prefix, which is all the file keeps (the JAX package also
decodes the left channel's remainder, then drops it).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..audio import Audio, new_audio
from ..config import require_device
from ..ops import pcmcode

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


def decode_mdfpwm(data: bytes, head: bool = False, device="cuda") -> Audio:
    """MDFPWMv3 bytes -> stereo 48 kHz Audio on ``device``."""
    from ..codecs.dfpwm import DfpwmState
    from ..kernels.dfpwm_cuda import dfpwm_decode_kernel

    device = require_device(device, "decode_mdfpwm")
    length, artist, title, album, pos = parse_mdfpwm_header(data)
    meta = {"artist": artist, "title": title, "album": album}
    if head:
        return new_audio(np.zeros((2, 0), np.float32), 48000, meta, {}, device)
    body = np.frombuffer(data, dtype=np.uint8)[pos:]
    npairs = len(body) // 12000
    tail = body[npairs * 12000:]
    # the reference stops at the first short/absent L or R block
    # (aukit.lua:1434-1439): a trailing partial pair decodes only as much as
    # both channels have
    extra = max(len(tail) - 6000, 0)
    blocks = body[: npairs * 12000].reshape(npairs, 2, 6000).transpose(1, 0, 2).reshape(2, -1)
    lanes = np.concatenate([blocks, np.stack([tail[:extra], tail[6000:]])], axis=1)
    left = right = torch.zeros(0, dtype=torch.int8, device=device)
    if lanes.shape[1]:  # empty input never reaches the kernel
        out, _ = dfpwm_decode_kernel(torch.from_numpy(lanes).to(device),
                                     DfpwmState.zeros(2, device))
        left, right = out[0], out[1]
    # interleave L/R like the reference's audio table, truncated to length*8
    # samples per the header (aukit.lua:1441)
    inter = torch.stack([left, right], dim=1).reshape(-1)[: length * 8]
    inter = inter.to(torch.int32).cpu().numpy()
    # through the PCM normalise, like aukit.pcm(audio, 8, "signed", 2, ...)
    m = len(inter) // 2
    arr = pcmcode.normalize_pcm(inter[: m * 2], 8, "signed").reshape(m, 2).T
    return new_audio(arr, 48000, meta, {"bitDepth": 8, "dataType": "signed"}, device)
