"""The single-stream iterators — counterpart of ``aukit_tpu.stream`` (the
reference's ``aukit.stream.*``, aukit.lua:2197-3337), beside the batched
multi-stream decode engine, its container -> lane bridges, the batched FLAC
fleet, the ``Fleet`` facade over both and the batched encode engine.

Every iterator function returns ``(iterator, total_length_seconds | None)``;
each iterator step yields ``(chunk, position_seconds)`` where chunk is
``float32[C, <=48000]`` numpy holding values in the signed-8-bit range
[-128, 127] (integer-valued where the reference floors, float-valued where
it does not — e.g. stream.pcm). ``stream.pcm`` over a torch tensor of sample
values yields float32 tensors on that tensor's device (``ChunkResampler``'s
device twin), as the JAX package yields jax arrays for a jax array.

The block decodes run on ``device`` (keyword only, the card unless the
caller passes "cpu"): IMA and MS ADPCM (``adpcm``, ``msadpcm``, ``wav``) by
kernels (d) and (e), FLAC by kernel (g), QOA by kernel (f); DFPWM
(``dfpwm``, ``mdfpwm``) by the native host decoder when it builds (as the
JAX package routes it), else kernel (a). The resample, filter and
quantise steps are the JAX package's host float64 code.

Reference stream-path defects are FIXED here by default, as in the JAX
package (Q3 mono mix precedence, Q4 mono MS-ADPCM header reuse, Q5/Q6/Q17
g711 history bugs, Q9 per-chunk lowpass reseed [toggleable via
CONFIG.compat_quirks], Q15 dfpwm stereo de-interleave, Q16 IMA block
overread); structural semantics (per-block phase resets, per-second
batching, int8 scaling and floor placement, position reporting) are
replicated exactly.
"""

from __future__ import annotations

import struct

import numpy as np

from ..config import CONFIG, get_interpolation, require_device
from ..parallel.pipeline import fir_alpha
from ..utils.validation import check_bit_depth, check_data_type
from .batch import BatchDfpwmDecoder, BatchMetrics, BatchStreamEngine, LaneSpec
from .batch_codecs import (lane_spec_for_aiff, lane_spec_for_au, lane_spec_for_qoa,
                           lane_spec_for_wav, mdfpwm_to_lanes)
from .batch_encode import (ENCODE_CODECS, BatchDfpwmEncoder, BatchEncodeEngine, EncodeSpec,
                           encode_windows_many, transcode_fleet)
from .engine import ChunkResampler, iir_lowpass_scan, lua_block_resample
from .flac_fleet import FlacFleet
from .fleet import Fleet
from .sources import ByteSource, PcmFrameSource


class ChunkIterator:
    """Iterator over (chunk[C, n] float32, position_seconds). Also callable in
    the reference's iterator-function style: call -> tuple or None."""

    def __init__(self, gen):
        self._gen = gen
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        try:
            return next(self._gen)
        except StopIteration:
            self._done = True
            raise

    def __call__(self):
        if self._done:
            return None
        try:
            return next(self._gen)
        except StopIteration:
            self._done = True
            return None


# -- stream.pcm (aukit.lua:2228-2424) -------------------------------------------

def pcm(
    data,
    bit_depth: int = 8,
    data_type: str = "signed",
    channels: int = 1,
    sample_rate: int = 48000,
    big_endian: bool = False,
    mono: bool = False,
):
    check_bit_depth(bit_depth)
    check_data_type(data_type, bit_depth)
    if channels == 1:
        mono = False
    src = PcmFrameSource(data, bit_depth, data_type, channels, big_endian, mono)
    rs = ChunkResampler(
        sample_rate,
        1 if mono else channels,
        mode=None,
        lowpass=True,
        scale_int8=True,
        floor_output=False,
    )

    def gen():
        while True:
            fresh = src.read_frames(rs.samples_needed)
            short = fresh.shape[1] < rs.samples_needed
            res = rs.process(fresh)
            if res is None:
                return
            yield res
            if short:
                return

    length = src.total_frames / sample_rate if src.total_frames is not None else None
    return ChunkIterator(gen()), length


# -- stream.dfpwm (aukit.lua:2439-2496) ------------------------------------------

def dfpwm(data, sample_rate: int = 48000, channels: int = 1, mono: bool = False, *,
          device="cuda"):
    """Chunked DFPWM decode: 6000*channels bytes per call through one shared
    decoder, then per-channel resample (no lowpass), interp clamped to
    [-128, 127]. The reference resamples the still-interleaved buffer so all
    channels emit identical data (quirk Q15) — fixed here by de-interleaving
    before resampling; single-channel output is bit-identical. The decoder
    takes the native host route when it builds, else kernel (a) on
    ``device`` (``DfpwmStreamDecoder``)."""
    from ..codecs.dfpwm import DfpwmStreamDecoder

    if channels == 1:
        mono = False
    mode = get_interpolation(None)
    src = ByteSource(data)
    is_sized = isinstance(data, (bytes, bytearray, memoryview))
    total = len(data) * 8 / sample_rate / channels if is_sized else None
    dec = DfpwmStreamDecoder(lanes=1, device=device)
    last = np.zeros((channels, 1), np.float64)  # Lua audio[0] carry
    pos_bytes = 0

    def gen():
        nonlocal last, pos_bytes
        while True:
            d = src.read(6000 * channels)
            if not d:
                return
            samples = dec.decode(np.frombuffer(d, np.uint8)[None, :])[0]
            n = len(samples) // channels
            if n == 0:
                return
            chans = samples[: n * channels].reshape(n, channels).T.astype(np.float64)
            ext = np.concatenate([last, chans], axis=1)
            out = lua_block_resample(
                ext, 1, n, sample_rate, CONFIG.output_rate, mode,
                interp_clamp=(-128.0, 127.0),
            )
            last = chans[:, -1:].copy()
            if mono:
                out = out.mean(axis=0, keepdims=True)
            p = pos_bytes
            pos_bytes += len(d)
            yield out.astype(np.float32), p * 8 / sample_rate / channels
            if len(d) < 6000 * channels:
                return

    return ChunkIterator(gen()), total


# -- stream.g711 (aukit.lua:2850-2913) -------------------------------------------

def g711(input_data, ulaw: bool, channels: int = 1, sample_rate: int = 8000, mono: bool = False):
    """One second of bytes per call, LUT expand at int8 scale (/±0x40), whole-
    second resample with sinc-window history, floor+clamp output. The
    reference's history carry never lands in the channel arrays (quirks
    Q5/Q6/Q17) — fixed with a real per-channel history window."""
    from ..codecs.g711 import g711_float_lut

    lut = g711_float_lut(bool(ulaw), 0x40).astype(np.float64)
    mode = get_interpolation(None)
    src = ByteSource(input_data)
    is_sized = isinstance(input_data, (bytes, bytearray, memoryview))
    total = len(input_data) / sample_rate / channels if is_sized else None
    W = CONFIG.sinc_window_size
    hist = np.zeros((channels, W), np.float64)
    hist_valid = 0
    pos_bytes = 0

    def gen():
        nonlocal hist, hist_valid, pos_bytes
        while True:
            d = src.read(sample_rate * channels)
            if not d:
                return
            raw = np.frombuffer(d, np.uint8)
            vals = lut[raw]
            n = len(vals) // channels
            if n == 0:
                return
            chans = vals[: n * channels].reshape(n, channels).T
            ext = np.concatenate([hist, chans], axis=1)
            out = lua_block_resample(ext, hist_valid, n, sample_rate, CONFIG.output_rate, mode)
            take = min(n, W)
            hist = np.concatenate([hist[:, take:], chans[:, -take:]], axis=1)
            hist_valid = min(hist_valid + take, W)
            if mono:
                out = np.floor(out.mean(axis=0, keepdims=True))
            else:
                out = np.floor(out)
            out = np.clip(out, -128, 127)
            p = pos_bytes
            pos_bytes += len(d)
            yield out.astype(np.float32), p / sample_rate / channels
            if len(d) < sample_rate * channels:
                return

    return ChunkIterator(gen()), total


def _blocks_resample(dec, hist, sample_rate, ratio_out, mode, out_len=None):
    """Resample a second's decoded blocks in ONE vectorized call.

    ``dec`` is [B, C, n] (every block of a second shares one plan); block b's
    history row is block b-1 (the reference's negative-index carry,
    aukit.lua:2642-2645/2797), block 0's is ``hist`` — the previous second's
    last block — or zeros at stream start. Replaces the per-block Python loop
    (VERDICT r2 item 3) bit-identically: a zero-filled full-width history row
    with hist_valid=0 selects the same edge fallbacks as the loop's 1-column
    seed, because only positions >= H - hist_valid are ever real.

    Returns (out [C, B*out_len], new_hist [C, n])."""
    B, C, n = dec.shape
    prev = np.empty_like(dec)
    prev[1:] = dec[:-1]
    prev[0] = 0.0 if hist is None else hist
    ext = np.concatenate([prev, dec], axis=2)  # [B, C, 2n]
    if hist is None:
        # stream start: block 0 has NO valid history (hv=0), blocks 1.. do
        r0 = lua_block_resample(ext[:1], 0, n, sample_rate, ratio_out, mode,
                                out_len=out_len, hist=n)
        if B > 1:
            r = lua_block_resample(ext[1:], n, n, sample_rate, ratio_out, mode,
                                   out_len=out_len, hist=n)
            out = np.concatenate([r0, r], axis=0)
        else:
            out = r0
    else:
        out = lua_block_resample(ext, n, n, sample_rate, ratio_out, mode,
                                 out_len=out_len, hist=n)
    return np.moveaxis(out, 0, 1).reshape(C, -1), dec[-1].copy()


# -- stream.adpcm (IMA, WAV block layout; aukit.lua:2753-2835) --------------------

def adpcm(input_data, block_align: int, channels: int = 1, sample_rate: int = 48000,
          mono: bool = False, *, device="cuda"):
    """Per-second IMA ADPCM block batching: every block of a second decodes
    at once by kernel (d) on ``device`` (``ima_adpcm_blocks``), a lane a
    block and channel."""
    from ..codecs.adpcm import ima_adpcm_blocks
    from ..containers.wav import regroup_ima_stereo

    device = require_device(device, "stream.adpcm")
    mode = get_interpolation(None)
    src = ByteSource(input_data)
    is_sized = isinstance(input_data, (bytes, bytearray, memoryview))
    samples_per_block = (block_align - 4 * channels) * 2 // channels
    iter_per_second = -(-sample_rate // samples_per_block)
    bytes_per_second = block_align * iter_per_second
    total = (
        len(input_data) / block_align * samples_per_block / sample_rate if is_sized else None
    )
    ratio_out = CONFIG.output_rate
    hist = None  # previous block's decoded float lanes [C, samples_per_block]
    n_bytes = 0

    def gen():
        nonlocal hist, n_bytes
        while True:
            d = src.read(bytes_per_second)
            if not d:
                return
            raw = np.frombuffer(d, np.uint8)
            nblocks = len(raw) // block_align
            if nblocks == 0:
                return
            blocks = raw[: nblocks * block_align].reshape(nblocks, block_align)
            # decode all blocks of this second concurrently
            if channels == 2:
                hdr = blocks[:, :8]
                pred = np.stack(
                    [hdr[:, 0:2].copy().view("<i2")[:, 0], hdr[:, 4:6].copy().view("<i2")[:, 0]],
                    axis=1,
                ).astype(np.int32)
                # clamp malformed header indices (the reference nil-indexes
                # ima_step_table and errors the stream, aukit.lua:2806; we
                # keep the lane alive with defined output — the engine's
                # lenient §5.3 convention; quirk Q28, gated below)
                sidx = np.stack([hdr[:, 2], hdr[:, 6]], axis=1).astype(np.int32)
                if CONFIG.compat_quirks and (sidx > 88).any():
                    raise ValueError("malformed IMA step index")  # Q28 compat
                sidx = np.clip(sidx, 0, 88)
                ngroups = (block_align - 8) // 8
                body = blocks[:, 8 : 8 + ngroups * 8]
                lanes = regroup_ima_stereo(body).reshape(nblocks * 2, -1)
                preds = ima_adpcm_blocks(lanes, pred.reshape(-1), sidx.reshape(-1),
                                         device=device)
                dec = preds.reshape(nblocks, 2, -1).astype(np.float64)
            else:
                pred = blocks[:, 0:2].copy().view("<i2")[:, 0].astype(np.int32)
                sidx = blocks[:, 2].astype(np.int32)
                if CONFIG.compat_quirks and (sidx > 88).any():
                    raise ValueError("malformed IMA step index")  # Q28 compat
                sidx = np.clip(sidx, 0, 88)
                nbytes_body = ((block_align - 4 * channels) // (4 * channels)) * 4 * channels
                body = blocks[:, 4 : 4 + nbytes_body]
                lo = (body & 0x0F).astype(np.int32)
                hi = (body >> 4).astype(np.int32)
                nibs = np.stack([lo, hi], axis=-1).reshape(nblocks, -1)
                preds = ima_adpcm_blocks(nibs, pred, sidx, device=device)
                dec = preds[:, None, :].astype(np.float64)
            dec = dec / np.where(dec < 0, 128.0, 127.0)
            out, hist = _blocks_resample(dec, hist, sample_rate, ratio_out, mode)
            if mono:
                out = np.floor(out.mean(axis=0, keepdims=True))
            else:
                out = np.floor(out)
            out = np.clip(out, -128, 127)
            n_bytes += len(d)
            yield out.astype(np.float32), n_bytes / bytes_per_second
            if len(d) < bytes_per_second:
                return

    return ChunkIterator(gen()), total


# -- stream.msadpcm (aukit.lua:2588-2736) -----------------------------------------

def msadpcm(
    input_data,
    block_align: int,
    channels: int = 1,
    sample_rate: int = 48000,
    mono: bool = False,
    coefficients=None,
    *,
    device="cuda",
):
    """Per-second MS-ADPCM block batching: every block of a second decodes at
    once by kernel (e) on ``device`` (``decode_msadpcm_blocks``). The
    reference's mono path re-reads every block header from the stream start
    (quirk Q4) and its mono mixdown is l + r/2 (quirk Q3) — both fixed here."""
    from ..codecs.adpcm import decode_msadpcm_blocks

    device = require_device(device, "stream.msadpcm")
    mode = get_interpolation(None)
    src = ByteSource(input_data)
    is_sized = isinstance(input_data, (bytes, bytearray, memoryview))
    if channels == 2:
        samples_per_block = block_align - 14
    elif channels == 1:
        samples_per_block = (block_align - 7) * 2
    else:
        raise ValueError(f"Unsupported number of channels: {channels}")
    iter_per_second = -(-sample_rate // samples_per_block)
    bytes_per_second = block_align * iter_per_second
    total = (
        len(input_data) / block_align * samples_per_block / sample_rate if is_sized else None
    )
    hist = None
    n_bytes = 0

    def gen():
        nonlocal hist, n_bytes
        while True:
            d = src.read(bytes_per_second)
            if not d:
                return
            raw = np.frombuffer(d, np.uint8)
            nblocks = len(raw) // block_align
            if nblocks == 0:
                return
            blocks = raw[: nblocks * block_align].reshape(nblocks, block_align)
            if channels == 2:
                h = blocks[:, :14]
                pidx = np.stack([h[:, 0], h[:, 1]], axis=1).astype(np.int64)
                s16 = h[:, 2:14].copy().view("<i2").astype(np.int32)
                delta = s16[:, 0:2]
                s1 = s16[:, 2:4]
                s2 = s16[:, 4:6]
                nib = blocks[:, 14:].astype(np.int32)
                hi, lo = nib >> 4, nib & 0x0F
                hi = np.where(hi >= 8, hi - 16, hi)
                lo = np.where(lo >= 8, lo - 16, lo)
                lanes = np.concatenate([hi, lo], axis=0)  # [2B, D] L lanes then R
                preds = decode_msadpcm_blocks(
                    lanes,
                    np.concatenate([pidx[:, 0], pidx[:, 1]]),
                    np.concatenate([delta[:, 0], delta[:, 1]]),
                    np.concatenate([s1[:, 0], s1[:, 1]]),
                    np.concatenate([s2[:, 0], s2[:, 1]]),
                    coefficients,
                    device=device,
                )
                B = nblocks
                # per-channel per-block: [2 header samples] + body, floored to int8 scale
                def block_vals(sample2, sample1, body):
                    head = np.stack([sample2, sample1], axis=1).astype(np.float64)
                    head = np.floor(head / np.where(head < 0, 128.0, 127.0))
                    bodyf = np.floor(body.astype(np.float64) / np.where(body < 0, 128.0, 127.0))
                    return np.concatenate([head, bodyf], axis=1)

                vals = np.stack([block_vals(s2[:, 0], s1[:, 0], preds[:B]),
                                 block_vals(s2[:, 1], s1[:, 1], preds[B:])],
                                axis=1)  # [B, 2, 2+D]
            else:
                pidx = blocks[:, 0].astype(np.int64)
                s16 = blocks[:, 1:7].copy().view("<i2").astype(np.int32)
                delta, s1, s2 = s16[:, 0], s16[:, 1], s16[:, 2]
                nib = blocks[:, 7:].astype(np.int32)
                hi, lo = nib >> 4, nib & 0x0F
                hi = np.where(hi >= 8, hi - 16, hi)
                lo = np.where(lo >= 8, lo - 16, lo)
                lanes = np.stack([hi, lo], axis=-1).reshape(nblocks, -1)
                preds = decode_msadpcm_blocks(lanes, pidx, delta, s1, s2, coefficients,
                                              device=device)
                head = np.stack([s2, s1], axis=1).astype(np.float64)
                head = head / np.where(head < 0, 128.0, 127.0)  # mono: no floor (aukit.lua:2712)
                bodyf = preds.astype(np.float64) / np.where(preds < 0, 128.0, 127.0)
                vals = np.concatenate([head, bodyf], axis=1)[:, None, :]  # [B, 1, 2+D]
            out, hist = _blocks_resample(
                vals, hist, sample_rate, CONFIG.output_rate, mode,
                out_len=(samples_per_block * CONFIG.output_rate) // sample_rate)
            if mono and channels == 2:
                out = np.floor(out.mean(axis=0, keepdims=True))
            else:
                out = np.floor(out)
            out = np.clip(out, -128, 127)
            n_bytes += len(d)
            yield out.astype(np.float32), n_bytes / bytes_per_second
            if len(d) < bytes_per_second:
                return

    return ChunkIterator(gen()), total


# -- stream.mdfpwm (aukit.lua:2507-2572) -------------------------------------------

def mdfpwm(data, mono: bool = False, *, device="cuda"):
    """Chunked MDFPWM: 6000 bytes of each channel a call through one
    two-lane ``DfpwmStreamDecoder`` (native host route, else kernel (a) on
    ``device``)."""
    from ..codecs.dfpwm import DfpwmStreamDecoder
    from ..containers.mdfpwm import parse_mdfpwm_header

    src = ByteSource(data)
    header = src.read(11)
    # ensure the three pascal strings are available
    more = src.read(3 * 256 + 3)
    length, artist, title, album, hdr_size = parse_mdfpwm_header(header + more)
    src.push_front((header + more)[hdr_size:])
    total = length / 12000
    dec = DfpwmStreamDecoder(lanes=2, device=device)
    pos = 0

    def gen():
        nonlocal pos
        while True:
            dl = src.read(6000)
            dr = src.read(6000)
            if not dl or not dr:
                return
            n = min(len(dl), len(dr))
            lanes = np.stack([
                np.frombuffer(dl[:n], np.uint8),
                np.frombuffer(dr[:n], np.uint8),
            ])
            out = dec.decode(lanes).astype(np.float64)  # [2, n*8]
            # tail trim (aukit.lua:2553-2557)
            if pos + 12000 > length:
                keep = (length // 2) % 6000 * 8
                if keep:
                    out = out[:, :keep]
            if mono:
                out = np.floor(out.mean(axis=0, keepdims=True))  # fixed Q3
                out = np.clip(out, -128, 127)
            p = pos
            pos += len(dl) + len(dr)
            yield out.astype(np.float32), p / 12000
            if len(dl) < 6000 or len(dr) < 6000:
                return

    return ChunkIterator(gen()), total


# -- container streams ------------------------------------------------------------

def _resync_transform(magic_check, strip):
    def transform(chunk: bytes) -> bytes:
        if magic_check(chunk):
            return strip(chunk)
        return chunk

    return transform


def wav(data, mono: bool = False, ignore_header: bool = False, *, device="cuda"):
    """Streaming WAV (aukit.lua:2927-3003): parse the header from the first
    chunk, then dispatch to the codec stream (IMA, MS ADPCM and DFPWM decode
    on ``device``)."""
    from ..containers.wav import parse_fmt

    fn = None
    if not isinstance(data, (bytes, bytearray, memoryview)):
        src0 = ByteSource(data)
        first = src0.read(1 << 16)
        fn = src0
        data = first
    data = bytes(data)
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a WAV file")
    pos = 12
    fmt_info = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        pos += 8
        if cid == b"fmt ":
            fmt_info = parse_fmt(data[pos : pos + size])
            pos += size
        elif cid == b"data":
            data_type, channels, sample_rate, block_align, bit_depth, coefficients = fmt_info
            payload = data[pos : pos + size]
            if fn is not None:
                # preserve the caller's chunk boundaries so mid-stream RIFF
                # headers arrive chunk-aligned, like the reference's fn()
                # passthrough (aukit.lua:2979-2991)
                def source():
                    out = fn.pull_chunk()
                    if out is None:
                        return None
                    if ignore_header and out[:4] == b"RIFF" and out[8:12] == b"WAVE":
                        idx = out.find(b"data")
                        if idx >= 0:
                            return out[idx + 8 :]
                    return out

                body = _PrefixedSource(payload, source)
            else:
                body = payload
            if data_type == "adpcm":
                return adpcm(body, block_align, channels, sample_rate, mono, device=device)
            if data_type == "msadpcm":
                return msadpcm(body, block_align, channels, sample_rate, mono, coefficients,
                               device=device)
            if data_type == "dfpwm":
                it, _ = dfpwm(body, sample_rate, channels, mono, device=device)
                return it, size / channels / (bit_depth / 8) / sample_rate
            if data_type in ("alaw", "ulaw"):
                return g711(body, data_type == "ulaw", channels, sample_rate, mono)
            it, _ = pcm(body, bit_depth, data_type, channels, sample_rate, False, mono)
            return it, size / channels / (bit_depth / 8) / sample_rate
        else:
            pos += size
    raise ValueError("invalid WAV file")


class _PrefixedSource:
    """Callable byte source: first the in-header payload, then the tail fn."""

    def __init__(self, first: bytes, fn):
        self._first = first
        self._fn = fn

    def __call__(self):
        if self._first is not None:
            out, self._first = self._first, None
            return out
        return self._fn()


def aiff(data, mono: bool = False, ignore_header: bool = False):
    """Streaming AIFF/AIFC (aukit.lua:3016-3073)."""
    fn = None
    if not isinstance(data, (bytes, bytearray, memoryview)):
        src0 = ByteSource(data)
        first = src0.read(1 << 16)
        fn = src0
        data = first
    data = bytes(data)
    if data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError("not an AIFF file")
    is_aifc = data[8:12] == b"AIFC"
    pos = 12
    channels = sample_rate = bit_depth = length = None
    compression = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from(">I", data, pos + 4)
        pos += 8
        if cid == b"COMM":
            from ..containers.aiff import parse_comm_rate

            channels, frames, bit_depth, e = struct.unpack_from(">hIhH", data, pos)
            m = int.from_bytes(data[pos + 10 : pos + 17], "big")
            cpos = pos + 18
            if is_aifc:
                compression = data[cpos : cpos + 4].decode("latin-1")
                slen = data[cpos + 4]
                cpos += 5 + slen + (1 if slen % 2 == 0 else 0)
            length = frames * channels * (bit_depth // 8)
            sr = parse_comm_rate(e, m)
            sample_rate = int(sr) if sr == int(sr) else sr
            pos = cpos
        elif cid == b"SSND":
            offset, _align = struct.unpack_from(">II", data, pos)
            payload = data[pos + 8 + offset : pos + 8 + offset + length]
            if fn is not None:
                def source():
                    out = fn.pull_chunk()
                    if out is None:
                        return None
                    if ignore_header and out[:4] == b"FORM" and out[8:12] in (b"AIFF", b"AIFC"):
                        # re-sync on a repeated FORM header (aukit.lua:3053-3062;
                        # the reference misreads the size field as the offset —
                        # we skip SSND+size+offset+blockAlign+offset correctly)
                        idx = out.find(b"SSND")
                        if idx >= 0:
                            (off2,) = struct.unpack_from(">I", out, idx + 8)
                            return out[idx + 16 + off2 :]
                    return out

                body = _PrefixedSource(payload, source)
            else:
                body = payload
            if compression in (None, "NONE"):
                it, _ = pcm(body, bit_depth, "signed", channels, sample_rate, True, mono)
                return it, length / channels / (bit_depth / 8) / sample_rate
            if compression == "sowt":
                it, _ = pcm(body, bit_depth, "signed", channels, sample_rate, False, mono)
                return it, length / channels / (bit_depth / 8) / sample_rate
            if compression in ("fl32", "FL32"):
                it, _ = pcm(body, 32, "float", channels, sample_rate, True, mono)
                return it, length / channels / 4 / sample_rate
            if compression in ("alaw", "ulaw", "ALAW", "ULAW"):
                it, _ = g711(body, compression in ("ulaw", "ULAW"), channels, sample_rate, mono)
                return it, length / channels / sample_rate
            raise ValueError(f"Unsupported compression scheme {compression}")
        else:
            pos += size
    raise ValueError("invalid AIFF file")


def au(data, mono: bool = False, ignore_header: bool = False):
    """Streaming AU (aukit.lua:3086-3113)."""
    from ..containers.au import parse_au_header

    fn = None
    if not isinstance(data, (bytes, bytearray, memoryview)):
        src0 = ByteSource(data)
        first = src0.read(1 << 16)
        fn = src0
        data = first
    data = bytes(data)
    offset, size, encoding, sample_rate, channels = parse_au_header(data)
    start = offset - 1
    payload = data[start:] if size == 0xFFFFFFFF else data[start : start + size]
    if fn is not None:
        def source():
            out = fn.pull_chunk()
            if out is None:
                return None
            if ignore_header and out[:4] == b".snd":
                # strip a repeated AU header via its offset field (aukit.lua:3097)
                (off2,) = struct.unpack_from(">I", out, 4)
                return out[off2 - 1 :]  # 1-based offset quirk, like the loader
            return out

        body = _PrefixedSource(payload, source)
    else:
        body = payload
    if encoding == 1 or encoding == 27:
        it, _ = g711(body, encoding == 1, channels, sample_rate, mono)
        return it, size / channels / sample_rate
    depth = {2: 8, 3: 16, 4: 24, 5: 32, 6: 32}.get(encoding)
    if depth is None:
        raise ValueError(f"unsupported encoding type {encoding}")
    dtype = "float" if encoding == 6 else "signed"
    it, _ = pcm(body, depth, dtype, channels, sample_rate, True, mono)
    return it, size / channels / (depth // 8) / sample_rate


_PULL = 1 << 16  # bytes pulled from a function source per refill
_STALL_LIMIT = 8 << 20  # undecodable-buffer bound before ending the stream


def flac(data, mono: bool = False, *, device="cuda"):
    """Streaming FLAC (aukit.lua:3124-3191): accumulate decoded frames to
    ~sample_rate output samples per chunk; per-frame-block resample with
    2-sample history and a true IIR lowpass (state carried across chunks —
    the reference reseeds it from a wrongly-scaled value, fixed here).

    Function/iterator sources decode INCREMENTALLY with bounded memory (the
    reference's lazy byte table, aukit.lua:3128-3144): frames are committed
    as soon as their bytes (incl. the CRC16 footer) arrive; only the
    undecoded tail stays buffered. A mid-stream parse error ends the stream
    after at most _STALL_LIMIT buffered bytes (reference pcall semantics).
    Each parsed batch of frames restores at once by kernel (g) on ``device``
    (``restore_and_decorrelate``)."""
    from ..codecs import flac as flac_codec

    device = require_device(device, "stream.flac")
    src = ByteSource(data)
    buf = bytearray(src.read(4096))
    while True:
        try:
            sample_rate, channels, depth, num_samples, meta, fpos = (
                flac_codec.parse_flac_header(bytes(buf)))
            break
        except (IndexError, struct.error):
            more = src.read(4096)
            if not more:
                raise flac_codec.FlacError("unexpected end of FLAC stream")
            buf.extend(more)
    mode = get_interpolation(None)
    alpha = fir_alpha(sample_rate, CONFIG.output_rate)
    full = 1 << depth

    def frames():
        nonlocal buf
        pos = fpos
        source_done = False
        stalled_at = None
        while True:
            data_now = bytes(buf)
            if source_done:
                fm, sub, coefs, values = flac_codec.parse_all_frames(
                    data_now, pos, channels, depth, strict=False)
            else:
                fm, sub, coefs, values, end = flac_codec.parse_all_frames(
                    data_now, pos, channels, depth, strict=False, incremental=True)
            if len(fm):
                raw = flac_codec.restore_and_decorrelate(fm, sub, coefs, values, channels, depth,
                                                         device=device)
                off = 0
                for block_size, _ca in fm:
                    block = raw[:, off : off + int(block_size)]
                    off += int(block_size)
                    yield block.astype(np.float64) / full  # [C, block] in [-0.5, 0.5)
            if source_done:
                return
            if len(fm):
                del buf[: end]
                pos = 0
                stalled_at = None
            elif stalled_at is not None and len(buf) - stalled_at > _STALL_LIMIT:
                return  # undecodable (parse error mid-stream): end the stream
            elif stalled_at is None:
                stalled_at = len(buf)
            more = src.read(_PULL)
            if not more:
                source_done = True
            else:
                buf.extend(more)

    frame_iter = frames()
    last = np.zeros((channels, 2), np.float64)
    ls = np.zeros(channels, np.float64)
    out_pos = 0.0

    def gen():
        nonlocal last, ls, out_pos
        done = False
        while not done:
            parts = []
            got = 0
            while got < sample_rate:
                blk = next(frame_iter, None)
                if blk is None:
                    done = True
                    break
                n = blk.shape[1]
                ext = np.concatenate([last, blk], axis=1)
                res = lua_block_resample(ext, 2, n, sample_rate, CONFIG.output_rate, mode, hist=2)
                # recursive lowpass (aukit.lua:3172-3183) + int8 scale
                filt, ls = iir_lowpass_scan(res, alpha, ls)
                scaled = np.clip(filt * np.where(filt < 0, 128.0, 127.0), -128, 127)
                parts.append(scaled)
                got += scaled.shape[1]
                last = (blk[:, -2:] if n >= 2
                        else np.concatenate([last[:, -1:], blk], axis=1)[:, -2:])
            if not parts:
                return
            chunk = np.concatenate(parts, axis=1)
            if mono and channels > 1:
                chunk = chunk.mean(axis=0, keepdims=True)
            out_pos += chunk.shape[1] / CONFIG.output_rate
            yield chunk.astype(np.float32), out_pos

    total = num_samples / sample_rate if num_samples else None
    return ChunkIterator(gen()), total


def qoa(data, mono: bool = False, *, device="cuda"):
    """Streaming QOA (aukit.lua:3202-3337): accumulate ~1 s of input samples,
    int8 fast-path scale floor(recon/256) (quirk Q10, intentional), 2-sample
    history resample + recursive lowpass.

    Function/iterator sources decode INCREMENTALLY with bounded memory (the
    reference's buffered read/peek source, aukit.lua:3205-3238): frames are
    length-prefixed, so each is committed as soon as frame_size (+8 slack
    bytes, the reference's check) is buffered; decode is batched across all
    frames available at each refill, by kernel (f) on ``device``
    (``qoa_lms_batched``)."""
    from ..codecs.qoa import parse_qoa_bulk, qoa_lms_batched, walk_qoa_headers

    device = require_device(device, "stream.qoa")
    src = ByteSource(data)
    buf = bytearray(src.read(12))
    if len(buf) < 12:
        buf.extend(src.read(12 - len(buf)))
    if len(buf) < 12 or bytes(buf[:4]) != b"qoaf":
        raise ValueError("Not a QOA file")
    (file_samples,) = struct.unpack_from(">I", bytes(buf), 4)
    channels = buf[8]
    sample_rate = int.from_bytes(bytes(buf[9:12]), "big")
    mode = get_interpolation(None)
    alpha = fir_alpha(sample_rate, CONFIG.output_rate)
    last = np.zeros((channels, 2), np.float64)
    ls = np.zeros(channels, np.float64)
    in_pos = 0

    def decoded_frames():
        nonlocal buf
        pos = 8
        consumed_samples = 0
        source_done = False
        stalled_at = None
        while True:
            data_now = bytes(buf)
            metas, got = walk_qoa_headers(
                data_now, pos, channels, sample_rate, file_samples - consumed_samples)
            if metas:
                dq, hist, wts, samples = parse_qoa_bulk(
                    data_now, pos, channels, sample_rate, file_samples - consumed_samples)
                F, C, tmax = dq.shape
                out = qoa_lms_batched(
                    dq.reshape(F * C, tmax), hist.reshape(F * C, 4), wts.reshape(F * C, 4),
                    device=device).reshape(F, C, tmax)
                for i in range(F):
                    rec = out[i, :, : samples[i]]
                    yield np.floor(rec.astype(np.float64) / 256.0)  # Q10 fast path
                consumed_samples += got
                end = metas[-1][0] + metas[-1][2]
                del buf[:end]
                pos = 0
                stalled_at = None
            if source_done:
                return
            if not metas:
                if stalled_at is not None and len(buf) - stalled_at > _STALL_LIMIT:
                    return
                if stalled_at is None:
                    stalled_at = len(buf)
            more = src.read(_PULL)
            if not more:
                source_done = True
            else:
                buf.extend(more)

    frame_iter = decoded_frames()
    pending = None

    def gen():
        nonlocal last, ls, in_pos, pending
        done = False
        while not done:
            # accumulate >= sample_rate input samples (aukit.lua:3245)
            parts = []
            got = 0
            while got < sample_rate:
                blk = next(frame_iter, None) if pending is None else pending
                pending = None
                if blk is None:
                    done = True
                    break
                parts.append(blk)
                got += blk.shape[1]
            if not parts:
                return
            chunk_in = np.concatenate(parts, axis=1)
            n = chunk_in.shape[1]
            ext = np.concatenate([last, chunk_in], axis=1)
            res = lua_block_resample(
                ext, 2, n, sample_rate, CONFIG.output_rate, mode,
                interp_clamp=(-128.0, 127.0), hist=2,
            )
            filt, ls = iir_lowpass_scan(res, alpha, ls)
            out = filt
            if mono and channels > 1:
                out = out.mean(axis=0, keepdims=True)
            p = in_pos / sample_rate
            in_pos += n
            last = ext[:, -2:]
            yield out.astype(np.float32), p

    total = file_samples / sample_rate if sample_rate else None
    return ChunkIterator(gen()), total


__all__ = ["ChunkIterator", "ChunkResampler", "pcm", "dfpwm", "g711", "adpcm", "msadpcm",
           "mdfpwm", "wav", "aiff", "au", "flac", "qoa", "BatchStreamEngine",
           "BatchDfpwmDecoder", "BatchMetrics", "LaneSpec", "lane_spec_for_wav",
           "lane_spec_for_aiff", "lane_spec_for_au", "lane_spec_for_qoa", "mdfpwm_to_lanes",
           "FlacFleet", "Fleet", "BatchDfpwmEncoder", "BatchEncodeEngine", "EncodeSpec",
           "ENCODE_CODECS", "encode_windows_many", "transcode_fleet"]
