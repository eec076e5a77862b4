"""Whole-file tracks in every container, synthesised from a seed: the input
of the auplay preload chain in ``tests/test_torch_auplay.py`` (short files)
and of ``chip_smoke.py``'s ``[whole_file]`` phase (3-minute tracks).

A track is stereo int16 tones plus noise. The encoders here are vectorised
over blocks, frames and channels (a Python step a sample within a block),
each block starting from its own header state, so a cut of a track encodes
to the first blocks of the whole track's file:
 - IMA ADPCM in WAV (``block_align`` 1024): the header holds the block's
   first sample and a fixed step index; each nibble is the decoder's own
   quantisation of the difference, the decoder's update followed exactly;
 - MS ADPCM in WAV (``block_align`` 1024): tests/fixtures.py ``ms_encode``'s
   rule (predictor 0, delta from the block's mean step);
 - QOA: 5120-sample frames, each starting from the 4 samples before it and
   the reference encoder's initial weights; a slice's scalefactor from its
   largest step, each residual the nearest dequantised value;
 - FLAC: distinct stereo LPC-8 frames (fitted coefficients, mid/side),
   repeated to length, with their decoded samples;
 - µ-law: each sample's nearest code of the loader's table.
Imports numpy, struct, tests/fixtures.py (by path) and the port's codec
tables; the DFPWM files are the port's own encoders' output, made by the
callers on their device.
"""

from __future__ import annotations

import importlib.util
import struct
from pathlib import Path

import numpy as np

from aukit_tpu_torch.codecs.adpcm import IMA_INDEX_TABLE, IMA_STEP_TABLE, MSADPCM_ADAPTION
from aukit_tpu_torch.codecs.qoa import QOA_DEQUANT

IMA_STEP = IMA_STEP_TABLE.astype(np.int64)
IMA_INDEX = IMA_INDEX_TABLE[:8].astype(np.int64)  # by the nibble's magnitude
MS_ADAPT = np.roll(MSADPCM_ADAPTION, 8).astype(np.int64)  # by the nibble's low 4 bits
QOA_INITIAL_WEIGHTS = (0, 0, -(1 << 13), 1 << 14)


def _wrap32(v: np.ndarray) -> np.ndarray:
    """int64 values wrapped to int32, as the QOA decoder's arithmetic wraps."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def fixtures():
    """tests/fixtures.py by path: on the card's machine ``tests`` may name
    another installed package."""
    spec = importlib.util.spec_from_file_location("aukit_fixtures",
                                                  Path(__file__).parent / "fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def synth_track(seconds: float, rate: int, seed: int, channels: int = 2) -> np.ndarray:
    """int16[channels, seconds * rate]: two tones a channel (80-2000 Hz) and
    noise, at about half of full scale."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    out = np.empty((channels, n), np.int16)
    for c in range(channels):
        f = rng.uniform(80, 2000, 2)
        x = (9000 * np.sin(2 * np.pi * f[0] * t + rng.uniform(0, 6))
             + 5000 * np.sin(2 * np.pi * f[1] * t) + rng.normal(0, 600, n))
        out[c] = np.clip(np.round(x), -32768, 32767)
    return out


def _blocks(x: np.ndarray, spb: int) -> np.ndarray:
    """int64[C, B, spb]: each channel cut into blocks of spb samples, the
    last zero-padded."""
    c, n = x.shape
    nb = -(-n // spb)
    out = np.zeros((c, nb, spb), np.int64)
    out.reshape(c, -1)[:, :n] = x
    return out


def ima_wav(x: np.ndarray, rate: int, block_align: int = 1024) -> bytes:
    """IMA ADPCM in WAV of int16[C, N] (C = 1 or 2)."""
    fx = fixtures()
    c = x.shape[0]
    spb = (block_align - 4 * c) * 2 // c  # nibbles a channel a block
    s = _blocks(x, spb)  # [C, B, spb]
    pred0 = s[..., 0].copy()
    idx0 = np.full(pred0.shape, 20 if c == 2 else 15)  # mono headers hold 4 bits of index
    pred, idx = pred0.copy(), idx0.copy()
    nibs = np.empty(s.shape, np.int64)
    for k in range(spb):
        step = IMA_STEP[idx]
        diff = s[..., k] - pred
        mag = np.minimum(7, np.abs(diff) * 4 // step)
        d = ((mag * step) >> 2) + (step >> 3)
        pred = np.clip(np.where(diff < 0, pred - d, pred + d), -32768, 32767)
        idx = np.clip(idx + IMA_INDEX[mag], 0, 88)
        nibs[..., k] = mag | ((diff < 0) << 3)
    hdr = np.zeros(pred0.shape + (4,), np.uint8)  # [C, B, 4]: <hBx
    hdr[..., 0], hdr[..., 1] = pred0 & 0xFF, (pred0 >> 8) & 0xFF
    hdr[..., 2] = idx0
    packed = (nibs[..., 0::2] | (nibs[..., 1::2] << 4)).astype(np.uint8)  # low nibble first
    B = s.shape[1]
    if c == 2:  # 4-byte groups alternate L, R
        body = packed.reshape(2, B, -1, 4).transpose(1, 2, 0, 3).reshape(B, -1)
        blocks = np.concatenate([hdr[0], hdr[1], body], axis=1)
    else:
        blocks = np.concatenate([hdr[0], packed[0]], axis=1)
    return fx.wav_ima(blocks.tobytes(), rate, c, block_align)


def msadpcm_wav(x: np.ndarray, rate: int, block_align: int = 1024) -> bytes:
    """MS ADPCM in WAV of int16[C, N] (C = 1 or 2), predictor 0."""
    fx = fixtures()
    c = x.shape[0]
    nib_count = (block_align - 7 * c) * 2 // c
    spb = nib_count + 2
    s = _blocks(x, spb)
    delta0 = np.maximum(16, (np.abs(np.diff(s, axis=2)).mean(axis=2) / 4).astype(np.int64))
    s2, s1, d = s[..., 0].copy(), s[..., 1].copy(), delta0.copy()
    nibs = np.empty(s.shape[:2] + (nib_count,), np.int64)
    for k in range(nib_count):
        lin = (s1 * 256) >> 8  # predictor 0: c1 = 256, c2 = 0
        nib = np.clip(np.round((s[..., k + 2] - lin) / d), -8, 7).astype(np.int64)
        pred = np.clip(lin + nib * d, -32768, 32767)
        d = np.clip((MS_ADAPT[nib & 15] * d) >> 8, 16, 1 << 20)
        s2, s1 = s1, pred
        nibs[..., k] = nib & 15

    def le16(v):
        return np.stack([v & 0xFF, (v >> 8) & 0xFF], axis=-1).astype(np.uint8)

    B = s.shape[1]
    if c == 2:
        hdr = np.concatenate([np.zeros((B, 2), np.uint8), le16(delta0[0]), le16(delta0[1]),
                              le16(s[0, :, 1]), le16(s[1, :, 1]), le16(s[0, :, 0]),
                              le16(s[1, :, 0])], axis=1)
        body = ((nibs[0] << 4) | nibs[1]).astype(np.uint8)
    else:
        hdr = np.concatenate([np.zeros((B, 1), np.uint8), le16(delta0[0]), le16(s[0, :, 1]),
                              le16(s[0, :, 0])], axis=1)
        body = ((nibs[0, :, 0::2] << 4) | nibs[0, :, 1::2]).astype(np.uint8)
    return fx.wav_msadpcm(np.concatenate([hdr, body], axis=1).tobytes(), rate, c, block_align)


def qoa_file(x: np.ndarray, rate: int) -> bytes:
    """QOA of int16[C, N]: 5120-sample frames, 20-sample slices."""
    c, n = x.shape
    frames = _blocks(x, 5120).transpose(1, 0, 2)  # [F, C, 5120]
    F = frames.shape[0]
    flat = x.astype(np.int64)
    hist = np.zeros((F, c, 4), np.int64)
    for f in range(1, F):
        hist[f] = flat[:, f * 5120 - 4: f * 5120]
    wts = np.broadcast_to(np.array(QOA_INITIAL_WEIGHTS, np.int64), (F, c, 4)).copy()
    table = QOA_DEQUANT.astype(np.int64)  # [16 scalefactors, 8 codes]
    # a slice's scalefactor: the smallest whose largest step covers its largest step
    steps = np.abs(np.diff(frames, axis=2, prepend=frames[..., :1])).reshape(F, c, 256, 20)
    sf = np.searchsorted(table[:, 6], steps.max(axis=3) / 2).clip(0, 15)  # [F, C, 256]
    h, w = hist.copy(), wts.copy()
    codes = np.empty((F, c, 5120), np.int64)
    for k in range(5120):
        pred = _wrap32((h * w).sum(axis=2)) >> 13
        r = frames[..., k] - pred
        row = table[sf[..., k // 20]]  # [F, C, 8]
        q = np.abs(row - r[..., None]).argmin(axis=2)
        dq = np.take_along_axis(row, q[..., None], 2)[..., 0]
        recon = np.clip(pred + dq, -32768, 32767)
        delta = dq >> 4
        w = _wrap32(w + np.where(h < 0, -delta[..., None], delta[..., None]))
        h = np.concatenate([h[..., 1:], recon[..., None]], axis=2)
        codes[..., k] = q
    shifts = 57 - 3 * np.arange(20, dtype=np.uint64)
    words = (sf.astype(np.uint64) << np.uint64(60)) | np.bitwise_or.reduce(
        codes.reshape(F, c, 256, 20).astype(np.uint64) << shifts, axis=3)  # [F, C, 256]
    out = bytearray(struct.pack(">4sI", b"qoaf", n))
    for f in range(F):
        samples = min(5120, n - f * 5120)
        nsl = -(-samples // 20)
        size = 8 + 16 * c + nsl * c * 8
        out += struct.pack(">B", c) + int(rate).to_bytes(3, "big") + struct.pack(">HH", samples,
                                                                                  size)
        for ch in range(c):
            out += hist[f, ch].astype(">i2").tobytes() + wts[f, ch].astype(">i2").tobytes()
        out += words[f, :, :nsl].T.astype(">u8").tobytes()  # slice-major, channels inside
    return bytes(out)


def flac_file(x: np.ndarray, rate: int, variants: int = 8, block: int = 4096):
    """FLAC (16-bit, mid/side, LPC-8) of ``variants`` distinct blocks of
    int16[2, N] repeated to N samples -> (file bytes, int64[2, N] samples it
    decodes to)."""
    fx = fixtures()
    n = x.shape[1]
    nfr = -(-n // block)
    frames, sigs = [], []
    for v in range(min(variants, nfr)):
        seg = x[:, v * block: (v + 1) * block].astype(np.int64)
        left, right = seg
        frames.append(fx.flac_frame([fitted_subframe((left + right) >> 1),
                                     fitted_subframe(left - right)], seg.shape[1], 10, 16))
        sigs.append(seg)
    order = [k % len(frames) for k in range(nfr)]
    # a short last frame: the start of the pattern's next block
    last = n - (nfr - 1) * block
    tail = sigs[order[-1]][:, :last]
    mid, side = (tail[0] + tail[1]) >> 1, tail[0] - tail[1]
    if last > 16:
        subs = [fitted_subframe(mid), fitted_subframe(side)]
    else:
        subs = [{"type": "verbatim", "values": [int(v) for v in ch]} for ch in (mid, side)]
    body = b"".join(frames[k] for k in order[:-1]) + fx.flac_frame(subs, last, 10, 16)
    samples = np.concatenate([sigs[k] for k in order[:-1]] + [tail], axis=1)
    return fx.flac_stream_header(rate, 2, 16, n) + body, samples


def fitted_subframe(sig: np.ndarray) -> dict:
    """An encoder-like LPC-8 subframe: least-squares coefficients quantised to
    12 bits, and the best single Rice parameter for the residual."""
    win = np.lib.stride_tricks.sliding_window_view(sig, 8)[:-1, ::-1]
    a = np.linalg.lstsq(win.astype(np.float64), sig[8:].astype(np.float64), rcond=None)[0]
    shift = int(np.clip(np.floor(np.log2(2047 / max(np.abs(a).max(), 1e-6))), 0, 15))
    coefs = np.clip(np.round(a * (1 << shift)), -2048, 2047).astype(np.int64)
    res = sig[8:] - ((win @ coefs) >> shift)
    u = np.where(res >= 0, 2 * res, -2 * res - 1)
    return {"type": "lpc", "order": 8, "warmup": [int(v) for v in sig[:8]], "precision": 12,
            "shift": shift, "coefs": [int(c) for c in coefs], "residuals": [int(v) for v in res],
            "param": int(np.clip(np.log2(max(u.mean(), 1.0)), 0, 14)), "partition_order": 0}


def ulaw_au(x: np.ndarray, rate: int, expand_lut: np.ndarray) -> bytes:
    """Sun AU, µ-law, of int16[C, N]: each sample's nearest code of
    ``expand_lut`` (the loader's int32[256] magnitudes at 1/0x2000)."""
    fx = fixtures()
    order = np.argsort(expand_lut, kind="stable")
    vals = expand_lut[order].astype(np.float64) / 0x2000
    target = x.T.reshape(-1).astype(np.float64) / 32768
    i = np.clip(np.searchsorted(vals, target), 1, 255)
    nearer = np.where(np.abs(vals[i - 1] - target) <= np.abs(vals[i] - target), i - 1, i)
    return fx.au_file(order[nearer].astype(np.uint8).tobytes(), 1, rate, x.shape[0])


def pcm16_wav(x: np.ndarray, rate: int) -> bytes:
    return fixtures().wav_pcm(x.astype(np.int64), rate, 16)


def aiff16(x: np.ndarray, rate: int) -> bytes:
    return fixtures().aiff_file(x.T.reshape(-1).astype(">i2").tobytes(), x.shape[0], rate, 16)
