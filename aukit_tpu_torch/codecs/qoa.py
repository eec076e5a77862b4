"""QOA (Quite OK Audio) decoder — counterpart of ``aukit_tpu.codecs.qoa``:
the LMS reconstruction in plain PyTorch for the engine's frame lanes, and
the whole-file decoder (reference aukit.qoa, aukit.lua:1706-1777).

QOA frames carry their full LMS state (4 history + 4 weights per channel)
in-band, so every (frame, channel) pair decodes as an independent lane: one
Python step per sample with the lanes vectorised. The loop runs on any
device, but is meant for the CPU and as the plain version the CUDA kernel
(``kernels/qoa_cuda.py``) is held against.

Integer semantics: the reference's ``signed_rshift`` coerces through bit32,
which is int32 wraparound, and the predictor sum may legitimately wrap. The
four products are added one by one as int32 tensors, which wrap; a
``torch.sum`` over int32 would return int64 and not wrap.

The whole file is parsed on the host (a vectorised numpy pass over each run
of equal-size frames, copied from the JAX package), and its LMS runs on the
device as kernel (f) ``qoa_lms_kernel`` over F*C frame x channel lanes of up
to 5120 samples. (The JAX package sends a whole file's LMS to native C++ on
the host, to spare a slow remote-TPU link two bulk copies; a card attached
to its host has no such link.)

Slice layout: 64 bits = [sf:4][r0:3][r1:3]...[r19:3]; the reference reads
residuals MSB-first by shifting the high word left 3 per sample
(aukit.lua:1760-1762); all 20 indices are extracted vectorised on the host.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..config import require_device

# aukit_tpu/codecs/qoa.py:31 (aukit.lua:1662-1679): dequantised residual per
# (scalefactor, 3-bit residual index)
QOA_DEQUANT = np.array(
    [
        [1, -1, 3, -3, 5, -5, 7, -7],
        [5, -5, 18, -18, 32, -32, 49, -49],
        [16, -16, 53, -53, 95, -95, 147, -147],
        [34, -34, 113, -113, 203, -203, 315, -315],
        [63, -63, 210, -210, 378, -378, 588, -588],
        [104, -104, 345, -345, 621, -621, 966, -966],
        [158, -158, 528, -528, 950, -950, 1477, -1477],
        [228, -228, 760, -760, 1368, -1368, 2128, -2128],
        [316, -316, 1053, -1053, 1895, -1895, 2947, -2947],
        [422, -422, 1405, -1405, 2529, -2529, 3934, -3934],
        [548, -548, 1828, -1828, 3290, -3290, 5117, -5117],
        [696, -696, 2320, -2320, 4176, -4176, 6496, -6496],
        [868, -868, 2893, -2893, 5207, -5207, 8099, -8099],
        [1064, -1064, 3548, -3548, 6386, -6386, 9933, -9933],
        [1286, -1286, 4288, -4288, 7718, -7718, 12005, -12005],
        [1536, -1536, 5120, -5120, 9216, -9216, 14336, -14336],
    ],
    dtype=np.int32,
)


def qoa_dequant(sf: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """``QOA_DEQUANT[sf, res]`` as a table lookup on ``res``'s device:
    int scalefactors (0..15) broadcast against int residual indices (0..7)
    -> int16."""
    tbl = torch.tensor(QOA_DEQUANT.reshape(-1), dtype=torch.int16, device=res.device)
    return tbl[(sf.to(torch.int32) * 8 + res.to(torch.int32))]


def qoa_lms_samples(dq: torch.Tensor, history: torch.Tensor, weights: torch.Tensor):
    """The LMS loop: dequantised residuals int[L, T], history and weights
    int32[L, 4] -> (int32[T, L] samples, time-major, (history, weights))."""
    dev = dq.device
    d = dq.t().to(torch.int32)  # [T, L]
    delta = d >> 4
    neg_delta = -delta
    h = list(history.to(torch.int32).t().unbind(0))
    w = list(weights.to(torch.int32).t().unbind(0))
    outs = []
    for t in range(d.shape[0]):
        # int32 products added one by one: each add wraps, as the spec says
        pred = (w[0] * h[0] + w[1] * h[1] + w[2] * h[2] + w[3] * h[3]) >> 13
        recon = (pred + d[t]).clamp(-32768, 32767)
        w = [wi + torch.where(hi < 0, neg_delta[t], delta[t]) for wi, hi in zip(w, h)]
        h = h[1:] + [recon]
        outs.append(recon)
    out = (torch.stack(outs) if outs else
           torch.empty((0, dq.shape[0]), dtype=torch.int32, device=dev))
    return out, (torch.stack(h, dim=1), torch.stack(w, dim=1))


# -- whole-file decoder (aukit_tpu/codecs/qoa.py:89-269) -------------------------------


def parse_qoa_frames(data: bytes, pos: int, file_channels: int, file_sample_rate: int,
                     file_samples: int):
    """Per-(frame, channel) state and slices of every frame that
    ``walk_qoa_headers`` accepts. Returns (frames list, total_samples). Mirrors
    aukit.lua:1713-1775 including the graceful ``break`` on malformed frame
    headers."""
    metas, sample_pos = walk_qoa_headers(data, pos, file_channels, file_sample_rate,
                                         file_samples)
    frames = []
    n = len(data)
    channels = file_channels
    for pos, samples, _ in metas:
        fpos = pos + 8
        hist = np.zeros((channels, 4), np.int32)
        wts = np.zeros((channels, 4), np.int32)
        for c in range(channels):
            hist[c] = struct.unpack_from(">4h", data, fpos)
            wts[c] = struct.unpack_from(">4h", data, fpos + 8)
            fpos += 16
        nslices_per_ch = -(-samples // 20)
        total_slices = nslices_per_ch * channels
        avail = min(total_slices * 8, n - fpos)
        raw = np.frombuffer(data, np.uint8, count=avail, offset=fpos)
        if avail < total_slices * 8:  # defensively zero-pad malformed frames
            raw = np.concatenate([raw, np.zeros(total_slices * 8 - avail, np.uint8)])
        if raw.ctypes.data % 8:  # malformed frame sizes can misalign the view
            raw = raw.copy()
        # slice order: per 20-sample group, one slice per channel
        slices = raw.view(">u8").astype(np.uint64).reshape(nslices_per_ch, channels)
        sf = (slices >> np.uint64(60)).astype(np.int64)
        shifts = (57 - 3 * np.arange(20, dtype=np.uint64)).astype(np.uint64)
        res = ((slices[:, :, None] >> shifts[None, None, :]) & np.uint64(7)).astype(np.int64)
        dq = QOA_DEQUANT[sf[:, :, None], res]  # [S, C, 20]
        dq = np.moveaxis(dq, 1, 0).reshape(channels, -1)  # [C, S*20]
        frames.append({"history": hist, "weights": wts, "dequant": dq, "samples": samples})
    return frames, sample_pos


def walk_qoa_headers(data: bytes, pos: int, file_channels: int, file_sample_rate: int,
                     file_samples: int):
    """Cheap first pass: (pos, samples, frame_size) per valid frame, applying
    the reference's lenient break conditions (aukit.lua:1732-1740)."""
    metas = []
    sample_pos = 0
    n = len(data)
    while pos + 16 * file_channels + 8 <= n and sample_pos < file_samples:
        channels, samplerate_hi, samples, frame_size = struct.unpack_from(">B3sHH", data, pos)
        samplerate = int.from_bytes(samplerate_hi, "big")
        data_size = frame_size - 8 - 4 * 4 * channels
        num_slices = data_size // 8
        if (
            channels != file_channels
            or samplerate != file_sample_rate
            or frame_size > n - pos - 8
            or samples * channels > num_slices * 20
        ):
            break
        metas.append((pos, samples, frame_size))
        sample_pos += samples
        pos += frame_size
    return metas, sample_pos


def _extract_run(blk: np.ndarray, channels: int):
    """Vectorized state+slice extraction over a run of equal-size frames.
    blk: uint8[F, frame_size] -> (dq int32[F, C, S*20], hist, wts int32[F,C,4],
    samples int32[F])."""
    F, fs = blk.shape
    samples = (blk[:, 4].astype(np.int32) << 8) | blk[:, 5]
    hdr = blk[:, 8: 8 + 16 * channels]
    state16 = hdr.reshape(F, -1, 2)
    s = ((state16[..., 0].astype(np.int32) << 8) | state16[..., 1]).astype(np.int32)
    s = np.where(s >= 32768, s - 65536, s).reshape(F, channels, 2, 4)
    hist, wts = s[:, :, 0], s[:, :, 1]
    nslices_per_ch = (fs - 8 - 16 * channels) // (8 * channels)
    nbytes = nslices_per_ch * channels * 8
    sl = np.ascontiguousarray(blk[:, 8 + 16 * channels: 8 + 16 * channels + nbytes])
    slices = sl.view(">u8").astype(np.uint64).reshape(F, nslices_per_ch, channels)
    sf = (slices >> np.uint64(60)).astype(np.int64)
    shifts = (57 - 3 * np.arange(20, dtype=np.uint64)).astype(np.uint64)
    res = ((slices[..., None] >> shifts) & np.uint64(7)).astype(np.int64)
    dq = QOA_DEQUANT[sf[..., None], res]  # [F, S, C, 20]
    dq = np.moveaxis(dq, 2, 1).reshape(F, channels, -1)
    return dq.astype(np.int32), hist, wts, samples


def parse_qoa_bulk(data: bytes, pos: int, file_channels: int, file_sample_rate: int,
                   file_samples: int):
    """Whole-stream vectorized parse: contiguous equal-size frame runs extract
    in one numpy pass each (a real file is one run of full frames + a short
    tail).

    Returns (dq int32[F, C, Tmax], hist, wts int32[F, C, 4], samples int32[F])
    or None when no frame is valid."""
    metas, _ = walk_qoa_headers(data, pos, file_channels, file_sample_rate, file_samples)
    if not metas:
        return None
    raw = np.frombuffer(data, np.uint8)
    runs = []  # (start_index, count, frame_size)
    i = 0
    while i < len(metas):
        p0, _, fs = metas[i]
        j = i + 1
        while j < len(metas) and metas[j][2] == fs and metas[j][0] == p0 + (j - i) * fs:
            j += 1
        runs.append((i, j - i, fs))
        i = j
    parts = []
    for start, count, fs in runs:
        p0 = metas[start][0]
        blk = raw[p0: p0 + count * fs].reshape(count, fs)
        parts.append(_extract_run(blk, file_channels))
    tmax = max(p[0].shape[2] for p in parts)
    F = len(metas)
    dq = np.zeros((F, file_channels, tmax), np.int32)
    hist = np.zeros((F, file_channels, 4), np.int32)
    wts = np.zeros((F, file_channels, 4), np.int32)
    samples = np.zeros(F, np.int32)
    at = 0
    for d, h, w, smp in parts:
        c = d.shape[0]
        dq[at: at + c, :, : d.shape[2]] = d
        hist[at: at + c] = h
        wts[at: at + c] = w
        samples[at: at + c] = smp
        at += c
    return dq, hist, wts, samples


def qoa_lms_batched(dq: np.ndarray, hist: np.ndarray, wts: np.ndarray,
                    device="cuda") -> np.ndarray:
    """The LMS of host-resident frame x channel lanes, residuals int[L, T]
    and state int32[L, 4] -> int32[L, T] samples (numpy), by kernel (f)
    ``qoa_lms_kernel`` on ``device`` (its plain version on the CPU). The
    whole-file decoder and ``stream.qoa`` share it, so both give the same
    samples (the JAX package's runs on the host: see the module docstring)."""
    from ..kernels.qoa_cuda import qoa_lms_kernel  # that module builds on this one

    device = require_device(device, "qoa_lms_batched")

    def lanes(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    out, _ = qoa_lms_kernel(lanes(dq, np.int16), lanes(hist, np.int32), lanes(wts, np.int32))
    return out.cpu().numpy().astype(np.int32)


def decode_qoa(data: bytes, use_native: bool | None = None, *, device="cuda"):
    """QOA bytes -> (int32[C, N] reconstructed samples (numpy), sample_rate,
    file_samples): the host parse, then the LMS of every frame and channel
    at once by kernel (f) on ``device`` (``qoa_lms_batched``).
    ``use_native=True`` takes the JAX package's native route instead: one
    fused C++ pass on the host (frame walk, slices and LMS:
    ``flacbits.qoa_decode``; no kernel), and raises when the library does
    not build."""
    device = require_device(device, "decode_qoa")
    try:
        magic, file_samples = struct.unpack_from(">4sI", data, 0)
    except struct.error as e:
        raise ValueError("Not a QOA file") from e
    if magic != b"qoaf":
        raise ValueError("Not a QOA file")
    file_channels = data[8]
    file_sample_rate = int.from_bytes(data[9:12], "big")
    if use_native:
        from ..native import flacbits

        out = flacbits.qoa_decode(data, 8, file_channels, file_sample_rate, file_samples)
        return out, file_sample_rate, file_samples
    parsed = parse_qoa_bulk(data, 8, file_channels, file_sample_rate, file_samples)
    if parsed is None:
        return np.zeros((file_channels, 0), np.int32), file_sample_rate, file_samples
    dq, hist, wts, samples = parsed
    F, C, tmax = dq.shape
    lanes = (dq.reshape(F * C, tmax), hist.reshape(F * C, 4), wts.reshape(F * C, 4))
    out = qoa_lms_batched(*lanes, device=device).reshape(F, C, tmax)
    # per-frame sample masks -> one flat gather per channel
    keep = np.arange(tmax)[None, :] < samples[:, None]  # [F, tmax]
    chans = [out[:, c][keep] for c in range(C)]
    return np.stack(chans), file_sample_rate, file_samples


def decode_qoa_audio(data: bytes, device="cuda"):
    """reference aukit.qoa (aukit.lua:1706): an Audio on ``device``."""
    from ..audio import new_audio
    from ..ops import pcmcode

    samples, sample_rate, _ = decode_qoa(data, device=device)
    return new_audio(pcmcode.normalize_pcm(samples, 16, "signed"), sample_rate, {},
                     {"bitDepth": 16, "dataType": "signed"}, device)
