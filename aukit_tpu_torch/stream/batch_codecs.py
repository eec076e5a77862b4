"""Lane specs, geometry and the device decode paths for the batched engine —
counterpart of ``aukit_tpu.stream.batch_codecs``.

Each codec gets one function ``uint8[L, in_bytes] -> float32[L, in_samples]``
(mono, loader-normalised; per-channel ``[L, C, in_samples]`` with
``mono=False``, the batched form of the reference's per-channel chunk
contract, aukit.lua:2223-2227) made of torch ops on the bytes' device. Block
codecs (IMA/MS ADPCM in WAV block layout, aukit.lua:1511/1543; QOA frames,
aukit.lua:1713) carry their state in-band, so a chunk of K blocks decodes as
K extra kernel lanes with no codec state carried across steps; only DFPWM
threads decoder state from step to step (aukit.lua:2446-2468). The three
block-codec recurrences and DFPWM run through the kernel wrappers (the CUDA
kernel on a CUDA tensor, the plain loop on the CPU); the elementwise codecs
(PCM, f32, G.711) are plain torch ops.

Geometry: every group consumes a fixed byte count per step chosen so the
decoded sample count is ~1 second of input (the reference's per-second stream
batching, aukit.lua:2617-2619).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from ..codecs.adpcm import MSADPCM_DEFAULT_COEFFS
from ..codecs.dfpwm import DfpwmState, norm8
from ..codecs.g711 import decode_g711_device
from ..codecs.qoa import qoa_dequant
from ..kernels.adpcm_cuda import ima_decode_kernel, msadpcm_decode_kernel
from ..kernels.dfpwm_cuda import dfpwm_decode_kernel
from ..kernels.qoa_cuda import qoa_lms_kernel

CODECS = ("dfpwm", "pcm8", "pcm8u", "pcm16", "pcm16be", "pcm24", "pcm24be",
          "pcm32", "pcm32be", "f32", "f32be", "ulaw", "alaw", "ima", "msadpcm", "qoa")

_BYTES_PER_SAMPLE = {"pcm8": 1, "pcm8u": 1, "ulaw": 1, "alaw": 1,
                     "pcm16": 2, "pcm16be": 2, "pcm24": 3, "pcm24be": 3,
                     "pcm32": 4, "pcm32be": 4, "f32": 4, "f32be": 4}

QOA_SLICES_PER_FRAME = 256
QOA_SAMPLES_PER_FRAME = QOA_SLICES_PER_FRAME * 20  # 5120


@dataclasses.dataclass(frozen=True)
class LaneSpec:
    """One stream's decode parameters. Lanes with equal specs share a group
    (one dispatch, one resample plan)."""

    codec: str
    sample_rate: int = 48000
    channels: int = 1
    block_align: int = 0  # ima / msadpcm block size in bytes
    chunk_bytes: int = 0  # override input bytes/step (0 = ~1 s of input)

    def __post_init__(self):
        if self.codec not in CODECS:
            raise ValueError(f"unsupported batch codec {self.codec!r}")
        if self.codec in ("ima", "msadpcm"):
            hdr = (4 if self.codec == "ima" else 7) * self.channels
            if self.block_align <= hdr:
                raise ValueError(f"{self.codec} needs block_align > {hdr}")
        if self.codec == "dfpwm" and self.channels != 1:
            raise ValueError("dfpwm batch lanes are mono; use one lane per channel")
        if self.channels not in (1, 2) and self.codec in ("ima", "msadpcm", "qoa"):
            raise ValueError(f"{self.codec} batch lanes support 1-2 channels")


class NoState:
    """The codec state of a group whose codec carries none across steps
    (every codec but DFPWM): no leaves, so a lane's checkpoint holds
    ``codec_state == []``, as the JAX engine's does."""

    def leaves(self) -> tuple:
        return ()

    def where(self, mask: torch.Tensor, other: "NoState") -> "NoState":
        return self


# -- container -> lane bridges (host code) ---------------------------------------------

def lane_spec_for_wav(data: bytes) -> tuple[LaneSpec, int, int]:
    """Map a WAV header to an engine lane: (spec, data_offset, data_size).

    Feed ``data[data_offset : data_offset + data_size]`` to the lane, so a
    fleet of WAV files (PCM 8/16/24/32, float, G.711, IMA/MS ADPCM,
    DFPWM-in-WAV) batches without manual specs (aukit.lua:2992-2996)."""
    from ..containers.wav import parse_fmt

    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("invalid WAV file")
    pos = 12
    fmt = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        pos += 8
        if cid == b"fmt ":
            fmt = parse_fmt(data[pos : pos + size])
        elif cid == b"data":
            if fmt is None:
                raise ValueError("invalid WAV file")
            data_type, channels, rate, block_align, bit_depth, _co = fmt
            codec = {
                "signed": {16: "pcm16", 24: "pcm24", 32: "pcm32"}.get(bit_depth),
                "unsigned": "pcm8u" if bit_depth == 8 else None,
                "float": "f32" if bit_depth == 32 else None,
                "alaw": "alaw", "ulaw": "ulaw",
                "adpcm": "ima", "msadpcm": "msadpcm", "dfpwm": "dfpwm",
            }.get(data_type)
            if codec is None:
                raise ValueError(f"no engine lane mapping for WAV {data_type}/{bit_depth}")
            spec = LaneSpec(codec, rate, 1 if codec == "dfpwm" else channels,
                            block_align=block_align if codec in ("ima", "msadpcm") else 0)
            return spec, pos, size
        pos += size + (size % 2)
    raise ValueError("invalid WAV file")


def lane_spec_for_aiff(data: bytes) -> tuple[LaneSpec, int, int]:
    """AIFF/AIFC header -> (spec, data_offset, data_size). Compressions:
    NONE (BE PCM), sowt (LE), fl32 (BE float), alaw/ulaw (aukit.lua:1576-1634)."""
    from ..containers.aiff import parse_comm_rate

    if data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError("not an AIFF file")
    is_aifc = data[8:12] == b"AIFC"
    pos = 12
    meta = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from(">I", data, pos + 4)
        pos += 8
        if cid == b"COMM":
            channels, _frames, depth, e = struct.unpack_from(">hIhH", data, pos)
            m = int.from_bytes(data[pos + 10 : pos + 17], "big")
            comp = data[pos + 18 : pos + 22].decode("latin-1") if is_aifc else "NONE"
            rate = int(parse_comm_rate(e, m))
            meta = (channels, depth, rate, comp)
        elif cid == b"SSND":
            if meta is None:
                raise ValueError("invalid AIFF file")
            channels, depth, rate, comp = meta
            offset, _align = struct.unpack_from(">II", data, pos)
            codec = {"NONE": {16: "pcm16be", 24: "pcm24be", 32: "pcm32be"}.get(depth),
                     "sowt": {16: "pcm16", 24: "pcm24", 32: "pcm32"}.get(depth),
                     "fl32": "f32be", "FL32": "f32be",
                     "alaw": "alaw", "ALAW": "alaw",
                     "ulaw": "ulaw", "ULAW": "ulaw"}.get(comp)
            if codec is None:
                raise ValueError(f"no engine lane mapping for AIFF {comp}/{depth}")
            return (LaneSpec(codec, rate, channels), pos + 8 + offset, size - 8 - offset)
        pos += size + (size % 2)
    raise ValueError("invalid AIFF file")


def lane_spec_for_au(data: bytes) -> tuple[LaneSpec, int, int]:
    """AU header -> (spec, data_offset, data_size); encodings 1 µ-law,
    2-5 BE PCM 8/16/24/32, 6 f32 BE, 27 A-law (aukit.lua:1636-1651, incl.
    the 1-based offset quirk Q20)."""
    from ..containers.au import parse_au_header

    offset, size, encoding, rate, channels = parse_au_header(bytes(data))
    codec = {1: "ulaw", 2: "pcm8", 3: "pcm16be", 4: "pcm24be", 5: "pcm32be",
             6: "f32be", 27: "alaw"}.get(encoding)
    if codec is None:
        raise ValueError(f"no engine lane mapping for AU encoding {encoding}")
    start = offset - 1  # reference 1-based offset quirk
    if size == 0xFFFFFFFF:
        size = len(data) - start
    return LaneSpec(codec, rate, channels), start, size


def lane_spec_for_qoa(data: bytes) -> tuple[LaneSpec, int, int]:
    """QOA file header -> (spec, data_offset, data_size): strips the 8-byte
    ``qoaf`` header (aukit.lua:1713-1717) so raw QOA files feed engine lanes
    directly; a trailing short frame is handled by the decoder's
    header-count masking."""
    if data[:4] != b"qoaf":
        raise ValueError("Not a QOA file")
    channels = data[8]
    rate = int.from_bytes(bytes(data[9:12]), "big")
    return LaneSpec("qoa", rate, channels), 8, len(data) - 8


def mdfpwm_to_lanes(data: bytes):
    """MDFPWMv3 -> two mono DFPWM engine lanes (aukit.lua:1416-1448): parse
    the header, de-interleave the alternating 6000-byte L/R blocks, and trim
    each lane to length//2 bytes (the loader's length*8-sample trim split
    across the two channels). Returns (LaneSpec, left_bytes, right_bytes)."""
    from ..containers.mdfpwm import parse_mdfpwm_header

    length, _artist, _title, _album, hdr = parse_mdfpwm_header(bytes(data))
    arr = np.frombuffer(bytes(data), np.uint8, count=len(data) - hdr, offset=hdr)
    nb = len(arr) // 12000
    pairs = arr[: nb * 12000].reshape(nb, 2, 6000)
    left = bytearray(pairs[:, 0].reshape(-1).tobytes())
    right = bytearray(pairs[:, 1].reshape(-1).tobytes())
    tail = arr[nb * 12000 :]
    left += tail[:6000].tobytes()
    right += tail[6000:].tobytes()
    per = length // 2
    return LaneSpec("dfpwm", 48000, 1), bytes(left[:per]), bytes(right[:per])


def geometry(spec: LaneSpec) -> tuple[int, int]:
    """(in_bytes, in_samples) consumed/decoded per lane per step."""
    r, ch, ba = spec.sample_rate, spec.channels, spec.block_align
    if spec.codec == "dfpwm":
        n = spec.chunk_bytes or r // 8
        return n, n * 8
    bps = _BYTES_PER_SAMPLE.get(spec.codec)
    if bps is not None:
        n = spec.chunk_bytes or bps * r * ch
        return n, n // (bps * ch)
    if spec.codec == "ima":
        spb = (ba - 4 * ch) * 2 // ch
        k = max(1, -(-spec.chunk_bytes // ba)) if spec.chunk_bytes else -(-r // spb)
        return k * ba, k * spb
    if spec.codec == "msadpcm":
        spb = (ba - 7 * ch) * 2 // ch + 2
        k = max(1, -(-spec.chunk_bytes // ba)) if spec.chunk_bytes else -(-r // spb)
        return k * ba, k * spb
    # qoa
    fb = 8 + ch * (16 + QOA_SLICES_PER_FRAME * 8)
    k = max(1, -(-spec.chunk_bytes // fb)) if spec.chunk_bytes else -(-r // QOA_SAMPLES_PER_FRAME)
    return k * fb, k * QOA_SAMPLES_PER_FRAME


# -- byte and sample helpers -------------------------------------------------------------

def _norm16(v: torch.Tensor) -> torch.Tensor:
    """Asymmetric 16-bit normalise (aukit.lua:1255/1765), a true division."""
    return v.to(torch.float32) / torch.where(v < 0, 32768.0, 32767.0)


def _mono(f: torch.Tensor) -> torch.Tensor:
    """[..., C, T] -> [..., T] mean mixdown (aukit.lua:685-687), computed
    as the JAX package's compiled ``jnp.mean`` computes it: the channels
    summed in order in float32, then one multiply by float32(1/C)."""
    if f.dim() == 2:
        return f
    f = f.to(torch.float32)
    acc = f[..., 0, :]
    for c in range(1, f.shape[-2]):
        acc = acc + f[..., c, :]
    return acc * float(np.float32(1.0 / f.shape[-2]))


def _le16(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    v = lo.to(torch.int32) | (hi.to(torch.int32) << 8)
    return torch.where(v >= 32768, v - 65536, v)


def _be16(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    v = (hi.to(torch.int32) << 8) | lo.to(torch.int32)
    return torch.where(v >= 32768, v - 65536, v)


def _u32_words(b: torch.Tensor, big_endian: bool) -> torch.Tensor:
    """uint8[L, 4N] -> int32[L, N]: the little- or big-endian 32-bit words,
    bit for bit (built in int64, then wrapped to int32)."""
    u = b.to(torch.int64)
    if big_endian:
        w = (u[:, 0::4] << 24) | (u[:, 1::4] << 16) | (u[:, 2::4] << 8) | u[:, 3::4]
    else:
        w = (u[:, 3::4] << 24) | (u[:, 2::4] << 16) | (u[:, 1::4] << 8) | u[:, 0::4]
    return w.to(torch.int32)


def _frames(spec: LaneSpec, f: torch.Tensor, mono: bool) -> torch.Tensor:
    """Interleaved samples [L, C*T] -> mono [L, T] (mean mixdown) or, with
    ``mono=False``, per-channel [L, C, T]."""
    x = f.reshape(f.shape[0], -1, spec.channels).transpose(-1, -2)
    return _mono(x) if mono else x


# -- per-codec decoders: uint8[L, in_bytes] -> float32 mono [L, in_samples] or
# per-channel [L, C, in_samples] ---------------------------------------------------------

def _decode_pcm8(spec: LaneSpec, b: torch.Tensor, mono: bool) -> torch.Tensor:
    v = b.to(torch.int32)
    return _frames(spec, norm8(torch.where(v >= 128, v - 256, v)), mono)


def _decode_pcm8u(spec: LaneSpec, b: torch.Tensor, mono: bool) -> torch.Tensor:
    """Unsigned 8-bit (WAV): bias 128 then asymmetric normalise (Q1 path,
    aukit.lua:1088/1152)."""
    return _frames(spec, norm8(b.to(torch.int32) - 128), mono)


def _decode_pcm16(spec: LaneSpec, b: torch.Tensor, mono: bool) -> torch.Tensor:
    if spec.codec == "pcm16be":
        v = _be16(b[:, 0::2], b[:, 1::2])
    else:
        v = _le16(b[:, 0::2], b[:, 1::2])
    return _frames(spec, _norm16(v), mono)


def _decode_pcm24(spec: LaneSpec, b: torch.Tensor, mono: bool) -> torch.Tensor:
    x = b.to(torch.int32)
    if spec.codec.endswith("be"):
        v = (x[:, 0::3] << 16) | (x[:, 1::3] << 8) | x[:, 2::3]
    else:
        v = (x[:, 2::3] << 16) | (x[:, 1::3] << 8) | x[:, 0::3]
    v = torch.where(v >= 1 << 23, v - (1 << 24), v)
    return _frames(spec, v.to(torch.float32) / torch.where(v < 0, 8388608.0, 8388607.0), mono)


def _decode_pcm32(spec: LaneSpec, b: torch.Tensor, mono: bool) -> torch.Tensor:
    v = _u32_words(b, spec.codec.endswith("be"))
    return _frames(spec, v.to(torch.float32) / torch.where(v < 0, 2147483648.0, 2147483647.0),
                   mono)


def _decode_f32(spec: LaneSpec, b: torch.Tensor, mono: bool) -> torch.Tensor:
    """Raw IEEE f32 samples, used directly like the reference's float loader
    (aukit.lua:1102: no normalisation)."""
    return _frames(spec, _u32_words(b, spec.codec.endswith("be")).view(torch.float32), mono)


def _decode_g711(spec: LaneSpec, b: torch.Tensor, mono: bool) -> torch.Tensor:
    f = decode_g711_device(b, spec.codec == "ulaw", spec.channels, 0x2000)
    return _mono(f) if mono else f


def _ima_args(spec: LaneSpec, b: torch.Tensor):
    """WAV-layout IMA blocks (aukit.lua:1511-1541): per-channel 4 B headers,
    then (stereo) channel-alternating 4-byte nibble groups; low nibble first.
    -> (nibbles u8[L*K*C, T], predictor, step_index), one lane per (stream,
    block, channel)."""
    ba, ch = spec.block_align, spec.channels
    L = b.shape[0]
    blk = b.reshape(L, -1, ba)
    K = blk.shape[1]
    hdr = blk[..., : 4 * ch].to(torch.int32)
    if ch == 1:
        pred0 = _le16(hdr[..., 0], hdr[..., 1]).reshape(-1)
        sidx0 = (hdr[..., 2] & 0x0F).reshape(-1)  # mono header quirk Q13 (aukit.lua:1544)
        body = blk[..., 4:]
        nibs = torch.stack([body & 0x0F, body >> 4], dim=-1).reshape(L * K, -1)
    else:
        pred_l = _le16(hdr[..., 0], hdr[..., 1])
        pred_r = _le16(hdr[..., 4], hdr[..., 5])
        # clamp instead of erroring: a malformed lane must not kill the batch
        sidx_l = hdr[..., 2].clamp(0, 88)
        sidx_r = hdr[..., 6].clamp(0, 88)
        body = blk[..., 8:].reshape(L, K, -1, 2, 4)  # [L, K, groups, chan, 4B]
        nib2 = torch.stack([body & 0x0F, body >> 4], dim=-1)  # low nibble first
        # -> [L, K, chan, groups*8]
        nibs = nib2.movedim(3, 2).reshape(L * K * 2, -1)
        pred0 = torch.stack([pred_l, pred_r], dim=-1).reshape(-1)
        sidx0 = torch.stack([sidx_l, sidx_r], dim=-1).reshape(-1)
    return nibs.contiguous(), pred0.contiguous(), sidx0.contiguous()


def _msadpcm_args(spec: LaneSpec, b: torch.Tensor):
    """MS ADPCM blocks (aukit.lua:1283-1353): stereo header <BBhhhhhh with
    channel-alternating nibbles (hi=L, lo=R); mono header <Bhhh. -> (signed
    nibbles i8[L*K*C, T], sample1, sample2, delta, c1, c2)."""
    ba, ch = spec.block_align, spec.channels
    L = b.shape[0]
    blk = b.reshape(L, -1, ba)
    K = blk.shape[1]
    hdr = blk[..., : 7 * ch].to(torch.int32)
    body = blk[..., 7 * ch :]
    if ch == 1:
        pidx = hdr[..., 0].clamp(0, 6).reshape(-1)
        delta = _le16(hdr[..., 1], hdr[..., 2]).reshape(-1)
        s1 = _le16(hdr[..., 3], hdr[..., 4]).reshape(-1)
        s2 = _le16(hdr[..., 5], hdr[..., 6]).reshape(-1)
        nib = torch.stack([body >> 4, body & 0x0F], dim=-1).reshape(L * K, -1)
    else:
        pidx = hdr[..., 0:2].clamp(0, 6).reshape(-1)
        delta = torch.stack([_le16(hdr[..., 2], hdr[..., 3]),
                             _le16(hdr[..., 4], hdr[..., 5])], dim=-1).reshape(-1)
        s1 = torch.stack([_le16(hdr[..., 6], hdr[..., 7]),
                          _le16(hdr[..., 8], hdr[..., 9])], dim=-1).reshape(-1)
        s2 = torch.stack([_le16(hdr[..., 10], hdr[..., 11]),
                          _le16(hdr[..., 12], hdr[..., 13])], dim=-1).reshape(-1)
        nib = torch.stack([body >> 4, body & 0x0F], dim=-2).reshape(L * K * 2, -1)
    nib = nib.to(torch.int8)
    nib = torch.where(nib >= 8, nib - 16, nib)
    c1 = torch.tensor(MSADPCM_DEFAULT_COEFFS[0], device=b.device)[pidx]
    c2 = torch.tensor(MSADPCM_DEFAULT_COEFFS[1], device=b.device)[pidx]
    return nib, s1.contiguous(), s2.contiguous(), delta.contiguous(), c1, c2


def _qoa_args(spec: LaneSpec, b: torch.Tensor):
    """QOA frames (aukit.lua:1713-1775): 8 B header + per-channel LMS state +
    64-bit big-endian slices interleaved one per channel per 20-sample group.
    -> (dequantised residuals i16[L*K*C, 5120], history, weights); the
    dequantisation is a table lookup."""
    ch = spec.channels
    fb = 8 + ch * (16 + QOA_SLICES_PER_FRAME * 8)
    L = b.shape[0]
    blk = b.reshape(L, -1, fb)
    K = blk.shape[1]
    hdr = blk[..., 8 : 8 + 16 * ch].to(torch.int32).reshape(L, K, ch, 2, 4, 2)
    state16 = _be16(hdr[..., 0], hdr[..., 1])  # [L, K, ch, 2, 4]
    hist = state16[..., 0, :].reshape(L * K * ch, 4).contiguous()
    wts = state16[..., 1, :].reshape(L * K * ch, 4).contiguous()
    sl = blk[..., 8 + 16 * ch :].reshape(L, K, QOA_SLICES_PER_FRAME, ch, 8)
    sf = sl[..., 0] >> 4  # [L, K, S, ch]
    # the slice's low 60 bits (below the scalefactor) as one int64 word
    word = (sl[..., 0] & 0x0F).to(torch.int64) << 56
    for k in range(1, 8):
        word |= sl[..., k].to(torch.int64) << (56 - 8 * k)
    # residual i sits at bits [57 - 3i, 59 - 3i]; i == 9 straddles the two
    # 32-bit words of the slice, which the int64 word needs no case for
    res = torch.stack([((word >> (57 - 3 * i)) & 7).to(torch.uint8) for i in range(20)],
                      dim=-1)  # [L, K, S, ch, 20]
    dq = qoa_dequant(sf[..., None], res)
    dq = dq.movedim(3, 2).reshape(L * K * ch, -1)  # [L*K*ch, 5120]
    return dq, hist, wts


# codec -> (the block-lane arguments of its kernel, the kernel)
BLOCK_KERNELS = {
    "ima": (_ima_args, ima_decode_kernel),
    "msadpcm": (_msadpcm_args, msadpcm_decode_kernel),
    "qoa": (_qoa_args, qoa_lms_kernel),
}


def _block_frames(spec: LaneSpec, out: torch.Tensor, lanes: int, mono: bool) -> torch.Tensor:
    """Block-lane samples int[L*K*C, T] (rows ordered lane, block, channel)
    -> normalised float32: mono [L, K*T], or per-channel [L, C, K*T]."""
    if spec.channels == 1:
        flat = _norm16(out.reshape(lanes, -1))
        return flat if mono else flat[:, None, :]
    f = _norm16(out).reshape(lanes, -1, 2, out.shape[1])
    if mono:
        return _mono(f).reshape(lanes, -1)
    return f.movedim(2, 1).reshape(lanes, 2, -1)


def _decode_ima(spec: LaneSpec, b: torch.Tensor, mono: bool) -> torch.Tensor:
    out, _ = ima_decode_kernel(*_ima_args(spec, b))
    return _block_frames(spec, out, b.shape[0], mono)


def _decode_msadpcm(spec: LaneSpec, b: torch.Tensor, mono: bool) -> torch.Tensor:
    """The two header samples (s2 then s1) are emitted before the
    predictions."""
    nib, s1, s2, delta, c1, c2 = _msadpcm_args(spec, b)
    preds, _ = msadpcm_decode_kernel(nib, s1, s2, delta, c1, c2)
    full = torch.cat([s2[:, None].to(torch.int16), s1[:, None].to(torch.int16), preds], dim=1)
    return _block_frames(spec, full, b.shape[0], mono)


def _decode_qoa(spec: LaneSpec, b: torch.Tensor, mono: bool) -> torch.Tensor:
    """Samples beyond a frame header's sample count (a short trailing
    frame) are masked; mono is the mean of the int samples, then the
    asymmetric normalise."""
    L = b.shape[0]
    recon, _ = qoa_lms_kernel(*_qoa_args(spec, b))
    recon = recon.reshape(L, -1, spec.channels, QOA_SAMPLES_PER_FRAME)
    blk = b.reshape(L, recon.shape[1], -1)
    samples = (blk[..., 4].to(torch.int32) << 8) | blk[..., 5].to(torch.int32)
    t = torch.arange(QOA_SAMPLES_PER_FRAME, dtype=torch.int32, device=b.device)
    recon = torch.where(t < samples[..., None, None], recon, 0)
    if mono:
        return _norm16(_mono(recon)).reshape(L, -1)
    return _norm16(recon.movedim(2, 1)).reshape(L, spec.channels, -1)


_DECODERS = {
    "pcm8": _decode_pcm8, "pcm8u": _decode_pcm8u,
    "pcm16": _decode_pcm16, "pcm16be": _decode_pcm16,
    "pcm24": _decode_pcm24, "pcm24be": _decode_pcm24,
    "pcm32": _decode_pcm32, "pcm32be": _decode_pcm32,
    "f32": _decode_f32, "f32be": _decode_f32,
    "ulaw": _decode_g711, "alaw": _decode_g711,
    "ima": _decode_ima, "msadpcm": _decode_msadpcm, "qoa": _decode_qoa,
}


def build_decoder(spec: LaneSpec, mono: bool = True):
    """fn(bytes_u8, state) -> (f32 samples, state): mono [L, in_samples], or
    per-channel [L, C, in_samples] with ``mono=False``. DFPWM decodes through
    ``dfpwm_decode_kernel`` and threads its state; every other codec reads
    its state in-band and passes ``state`` through."""
    if spec.codec == "dfpwm":
        def fn(b: torch.Tensor, state: DfpwmState):
            decoded, new_state = dfpwm_decode_kernel(b, state)
            f = norm8(decoded)
            return (f if mono else f[:, None, :]), new_state

        return fn
    dec = _DECODERS[spec.codec]

    def fn(b: torch.Tensor, state: NoState):
        return dec(spec, b, mono), state

    return fn


def init_state(spec: LaneSpec, lanes: int, device="cpu"):
    if spec.codec == "dfpwm":
        return DfpwmState.zeros(lanes, device)
    return NoState()
