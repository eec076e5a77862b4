"""The radio stations' tracks, made from the seed, and the writers that make
them.

The writers start from frozen copies of the repository's example servers
(``aukit_tpu_torch/examples/flac_radio_fleet.py``: ``flac_stream_header``,
``_flac_crc8``, ``_utf8_coded``, ``pack_fields``, ``lpc_frames``;
``aukit_tpu_torch/examples/mixed_fleet_server.py``: ``_ima_wav_station``),
kept here so that a later change to the examples cannot change the
benchmark's inputs. ``lpc_frames`` also returns where each frame starts and
codes each frame as the reference encoder's ``-5`` does (below), where the
example codes one Rice partition with fixed coefficients; the IMA maker can
write the tail of a track.

A FLAC track is 48 kHz mono 16-bit in frames of 4096 samples with one
order-8 LPC subframe each, by the rules of ``flac -5`` (``-l 8 -b 4096 -r
5``): each frame's coefficients from the autocorrelation of the
Tukey(0.5)-windowed frame by Levinson-Durbin, quantised to libFLAC's
automatic precision for 16-bit blocks of this size (12 bits) with its shift
and error feedback, and the residual in the Rice partition order of 0 to 5
that codes it in the fewest bits, each partition's parameter libFLAC's
estimate. The signal is a drifting tone: a random walk, restarted each frame
as the example's stations, whose loudness swells and fades within a frame.
A DFPWM track is seeded random bytes at 6000 B/s. An IMA track is a WAV file
of 16 kHz mono IMA ADPCM in blocks of 256 bytes, with seeded headers and
nibbles.
"""

from __future__ import annotations

import struct

import numpy as np

FLAC_BLOCK = 4096
IMA_RATE, IMA_BLOCK = 16000, 256
IMA_SPB = (IMA_BLOCK - 4) * 2  # samples a block, as the system decodes a mono block
IMA_CHUNK_BLOCKS = -(-IMA_RATE // IMA_SPB)  # blocks a second: the engine's chunk of an IMA lane
IMA_OUT = IMA_CHUNK_BLOCKS * IMA_SPB * 48000 // IMA_RATE  # a chunk's samples at 48 kHz


# -- FLAC (frozen from aukit_tpu_torch/examples/flac_radio_fleet.py) ------------------

def flac_stream_header(sample_rate: int, channels: int, depth: int, total: int) -> bytes:
    si = struct.pack(">HH", 4096, 4096) + b"\x00\x00\x00" * 2
    packed = (sample_rate << 44) | ((channels - 1) << 41) | ((depth - 1) << 36) | total
    si += packed.to_bytes(8, "big") + b"\x00" * 16
    return b"fLaC" + bytes([0x80]) + len(si).to_bytes(3, "big") + si


def _flac_crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _utf8_coded(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    for count in range(1, 7):
        if n.bit_length() <= 6 - count + 6 * count:
            lead = (0xFF << (7 - count)) & 0xFF | (n >> (6 * count))
            cont = [0x80 | ((n >> (6 * (count - 1 - k))) & 0x3F) for k in range(count)]
            return bytes([lead] + cont)
    raise ValueError("frame number too large")


def pack_fields(values: np.ndarray, widths: np.ndarray) -> bytes:
    ends = np.cumsum(widths, dtype=np.int64)
    total = int(ends[-1])
    if total % 8:
        raise ValueError("fields must end on a byte boundary")
    last = ends - 1
    x = values.astype(np.int64) << (7 - (last & 7))
    byte = last >> 3
    out = np.zeros(total // 8, np.float64)
    for k in range(max(1, (int(x.max()).bit_length() + 7) // 8)):
        out += np.bincount(np.maximum(byte - k, 0), weights=(x >> (8 * k)) & 0xFF,
                           minlength=len(out))
    return out.astype(np.uint8).tobytes()


def lpc_frames(sigs: np.ndarray, qlp: np.ndarray, precision: int, shift: np.ndarray,
               max_porder: int = 5, depth: int = 16):
    """Mono FLAC frames numbered from 0, one a row of ``sigs``: one LPC
    subframe each, with the quantised coefficients ``qlp[f]`` at
    ``precision`` bits and ``shift[f]``, its residual Rice-coded (method 0)
    in the partition order of 0 to ``max_porder`` that codes it in the fewest
    bits, each partition with the parameter the reference encoder estimates.
    Returns (bytes, the byte offset of each frame and of the end)."""
    F, n = sigs.shape
    order = qlp.shape[1]
    pred = sum(sigs[:, order - 1 - j: n - 1 - j] * qlp[:, j: j + 1] for j in range(order))
    res = sigs[:, order:] - (pred >> shift[:, None])
    porder, params = rice_partitions(res, n, max_porder)
    u = np.where(res >= 0, 2 * res, -2 * res - 1)
    k = np.empty_like(u)
    for p in np.unique(porder):
        rows = porder == p
        k[rows] = np.repeat(params[rows, : 1 << p], n >> p, axis=1)[:, order:]
    rice_v = (1 << k) | (u & ((1 << k) - 1))
    rice_w = (u >> k) + 1 + k
    mask = (1 << depth) - 1
    pmask = (1 << precision) - 1
    head_w = [1, 6, 1] + [depth] * order + [4, 5] + [precision] * order + [2, 4]
    vals, wids, offsets = [], [], [0]
    for f in range(F):
        hdr = bytearray([0xFF, 0xF8, 0x70, 0x00]) + _utf8_coded(f) + struct.pack(">H", n - 1)
        hdr.append(_flac_crc8(hdr))
        sub_v = ([0, 31 + order, 0] + [int(v) & mask for v in sigs[f, :order]]
                 + [precision - 1, int(shift[f])] + [int(c) & pmask for c in qlp[f]]
                 + [0, int(porder[f])])
        parts = 1 << int(porder[f])
        # each partition's parameter goes before its residuals; the first
        # partition holds the block's share less the warm-up samples
        starts = np.maximum(np.arange(parts) * (n // parts) - order, 0)
        v = np.insert(rice_v[f], starts, params[f, :parts])
        w = np.insert(rice_w[f], starts, 4)
        bits = 8 * len(hdr) + sum(head_w) + int(w.sum())
        vals += [np.frombuffer(bytes(hdr), np.uint8).astype(np.int64), np.array(sub_v), v,
                 np.array([0, 0xBEEF])]
        wids += [np.full(len(hdr), 8), np.array(head_w), w, np.array([-bits % 8, 16])]
        offsets.append(offsets[-1] + (bits + (-bits % 8)) // 8 + 2)
    return pack_fields(np.concatenate(vals), np.concatenate(wids)), np.array(offsets)


def rice_partitions(res: np.ndarray, n: int, max_porder: int, limit: int = 14):
    """The reference encoder's choice of Rice partitions for each frame's
    residual ``res`` (int64[F, n - order]): each partition's parameter is
    its estimate from the partition's sum of magnitudes (the smallest k with
    samples * 2**k >= the sum), and of the orders 0 to ``max_porder`` the one
    whose partitions code the residual in the fewest bits. Returns
    (int64[F] partition orders, int64[F, 2**max_porder] parameters, each
    frame's first 2**order of them used)."""
    F, m = res.shape
    order = n - m
    mag = np.zeros((F, n), np.int64)
    mag[:, order:] = np.abs(res)
    u = np.zeros((F, n), np.int64)
    u[:, order:] = np.where(res >= 0, 2 * res, -2 * res - 1)
    best = np.full(F, np.iinfo(np.int64).max)
    porder = np.zeros(F, np.int64)
    params = np.zeros((F, 1 << max_porder), np.int64)
    for p in range(max_porder + 1):
        parts, size = 1 << p, n >> p
        count = np.full(parts, size, np.int64)
        count[0] -= order
        sums = mag.reshape(F, parts, size).sum(-1)
        k = np.zeros((F, parts), np.int64)
        while True:
            short = (count << k) < sums
            if not short.any():
                break
            k += short
        k = np.minimum(k, limit)
        bits = (4 + count * (1 + k)).sum(1) + (u >> np.repeat(k, size, axis=1)).sum(1)
        better = bits < best
        best[better] = bits[better]
        porder[better] = p
        params[better, :parts] = k[better]
    return porder, params


def tukey(n: int, alpha: float = 0.5) -> np.ndarray:
    """The Tukey window, the reference encoder's apodization at -5."""
    x = np.arange(n) / (n - 1)
    w = np.ones(n)
    edge = alpha / 2
    lo, hi = x < edge, x > 1 - edge
    w[lo] = 0.5 * (1 + np.cos(np.pi * (x[lo] / edge - 1)))
    w[hi] = 0.5 * (1 + np.cos(np.pi * ((x[hi] - 1) / edge + 1)))
    return w


def levinson(sigs: np.ndarray, order: int) -> np.ndarray:
    """Predictor coefficients a[f, 0..order-1] of x[n] ~ sum a[j] x[n-1-j],
    one set a row of ``sigs``, from the autocorrelation of the
    Tukey-windowed row."""
    x = sigs * tukey(sigs.shape[1])
    r = np.stack([(x[:, : x.shape[1] - k] * x[:, k:]).sum(1) for k in range(order + 1)], 1)
    r[:, 0] *= 1.0 + 1e-9
    a = np.zeros((len(x), order + 1))
    a[:, 0] = 1.0
    err = r[:, 0].copy()
    for i in range(1, order + 1):
        k = -(r[:, i] + (a[:, 1:i] * r[:, i - 1:0:-1]).sum(1)) / err
        a[:, 1:i] = a[:, 1:i] + k[:, None] * a[:, i - 1:0:-1]
        a[:, i] = k
        err *= 1.0 - k * k
    return -a[:, 1:]


def quantize(lp: np.ndarray, precision: int):
    """The reference encoder's quantisation of coefficients ``lp[f]`` to
    ``precision`` signed bits: the shift from the largest magnitude (0 to
    15), each coefficient rounded with the error of the ones before it
    carried forward. Returns (int64[F, order], int64[F] shifts)."""
    qmax = (1 << (precision - 1)) - 1
    log2cmax = np.frexp(np.abs(lp).max(1))[1] - 1
    shift = np.clip(precision - 2 - log2cmax, 0, 15).astype(np.int64)
    q = np.zeros(lp.shape, np.int64)
    error = np.zeros(len(lp))
    for i in range(lp.shape[1]):
        error += lp[:, i] * (1 << shift)
        qi = np.clip(np.sign(error) * np.floor(np.abs(error) + 0.5), -qmax - 1, qmax)
        error -= qi
        q[:, i] = qi
    return q, shift


def flac_signal(rng: np.random.Generator, frames: int) -> np.ndarray:
    """int64[frames, 4096] of a drifting tone: a random walk restarted each
    frame, its steps scaled by a loudness that swells and fades (2**-2.5 to
    2**0.5 times) 0 to 6 times a frame, so that the residual's size varies
    within a frame, as music's does, at a pace that differs between frames."""
    steps = rng.integers(-40, 41, (frames, FLAC_BLOCK))
    phase, cycles = rng.uniform(0, 1, (2, frames, 1))
    t = np.arange(FLAC_BLOCK) / FLAC_BLOCK
    loud = 2.0 ** (1.5 * np.sin(2 * np.pi * (phase + 6 * cycles * t)) - 1)
    return np.clip(np.cumsum(np.rint(steps * loud), axis=1), -32768, 32767).astype(np.int64)


class FlacTrack:
    """One FLAC track: ``header`` (STREAMINFO of the whole track), ``body``
    (the frames) and ``offsets`` (each frame's start in ``body``, then its
    end)."""

    ORDER, PRECISION, MAX_PORDER = 8, 12, 5

    def __init__(self, rng: np.random.Generator, seconds: float):
        frames = int(np.ceil(seconds * 48000 / FLAC_BLOCK))
        sigs = flac_signal(rng, frames)
        qlp, shift = quantize(levinson(sigs.astype(np.float64), self.ORDER), self.PRECISION)
        self.body, self.offsets = lpc_frames(sigs, qlp, self.PRECISION, shift, self.MAX_PORDER)
        self.frames = self.units = frames
        self.header = flac_stream_header(48000, 1, 16, frames * FLAC_BLOCK)

    def seconds(self, first: int = 0) -> float:
        return (self.frames - first) * FLAC_BLOCK / 48000

    def stream(self, first_frame: int = 0) -> bytes:
        """The bytes a station is fed: a STREAMINFO header and the frames from
        ``first_frame`` on (a track joined part way through)."""
        total = (self.frames - first_frame) * FLAC_BLOCK
        return flac_stream_header(48000, 1, 16, total) + self.body[self.offsets[first_frame]:]


# -- IMA ADPCM in WAV (frozen from aukit_tpu_torch/examples/mixed_fleet_server.py) ---------

def ima_wav_header(nblocks: int) -> bytes:
    rate, ba = IMA_RATE, IMA_BLOCK
    spb = IMA_SPB
    fmt = struct.pack("<HHIIHHHH", 0x11, 1, rate, rate * ba // spb, ba, 4, 2, spb)
    size = nblocks * ba
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + size)
            + b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", size))


class ImaTrack:
    """One IMA ADPCM WAV track: ``blocks`` (the data chunk's bytes)."""

    def __init__(self, rng: np.random.Generator, seconds: float):
        nblocks = -(-int(seconds * IMA_RATE) // IMA_SPB)
        head = np.zeros((nblocks, 4), np.uint8)
        pred = rng.integers(-2000, 2000, nblocks).astype(np.int16).view(np.uint8)
        head[:, 0:2] = pred.reshape(nblocks, 2)
        head[:, 2] = rng.integers(0, 89, nblocks)
        body = rng.integers(0, 256, (nblocks, IMA_BLOCK - 4), dtype=np.uint8)
        self.blocks = np.concatenate([head, body], axis=1).tobytes()
        self.nblocks = self.units = nblocks

    def seconds(self, first: int = 0) -> float:
        return (self.nblocks - first) * IMA_SPB / IMA_RATE

    def stream(self, first_block: int = 0) -> bytes:
        return ima_wav_header(self.nblocks - first_block) + self.blocks[first_block * IMA_BLOCK:]


class DfpwmTrack:
    """One raw DFPWM track at 48 kHz: seeded random bytes."""

    def __init__(self, rng: np.random.Generator, seconds: float):
        self.data = rng.integers(0, 256, int(seconds * 6000), dtype=np.uint8).tobytes()
        self.units = len(self.data)

    def seconds(self, first: int = 0) -> float:
        return (len(self.data) - first) / 6000

    def stream(self, first_byte: int = 0) -> bytes:
        return self.data[first_byte:]


WAV_HEADER = len(ima_wav_header(0))


class Track:
    """A station's track as it was fed: the pool track, where it was joined
    (a frame, block or byte), its stream's bytes, the codec body's byte range
    within them, and for FLAC each frame's offset in the stream."""

    def __init__(self, kind: str, track, first: int):
        self.kind, self.track, self.first = kind, track, first
        self.stream = track.stream(first)
        self.body = (WAV_HEADER if kind == "ima" else 0, len(self.stream))
        if kind == "flac":
            head = len(flac_stream_header(48000, 1, 16, 0))
            self.offsets = track.offsets[first:] - track.offsets[first] + head


def body_bytes(trk: Track, a: int, b: int) -> int:
    """Bytes of [a, b) of a track's stream that fall in its codec body (a
    WAV's data chunk; the whole stream otherwise)."""
    lo, hi = trk.body
    return max(0, min(b, hi) - max(a, lo))
