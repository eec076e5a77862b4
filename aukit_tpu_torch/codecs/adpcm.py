"""IMA ADPCM and Microsoft ADPCM decoders — counterpart of
``aukit_tpu.codecs.adpcm``: the decode loops in plain PyTorch for the
engine's block lanes, and the whole-file decoders.

Both formats carry their full predictor state in every block header (WAV
layout), so a chunk of K blocks decodes as K independent lanes: one Python
step per sample with the lanes vectorised, like ``codecs/dfpwm.py``. They run
on any device, but are meant for the CPU and as the plain versions the CUDA
kernels (``kernels/adpcm_cuda.py``) are held against.

Integer semantics are those of the Pallas kernels (``ima_pallas.py``,
``msadpcm_pallas.py``), which equal ``ima_adpcm_scan`` and ``msadpcm_scan``
on every input a valid stream gives:

 - IMA: the step-table lookup clamps the index to [0, 88] while the raw
   index feeds the index update for that one step; the index delta has the
   closed form ``m < 4 ? -1 : (m - 3) * 2`` with ``m = nib & 7``.
 - MS: the header delta is used raw for the first sample, even when
   negative; the >= 16 floor applies from the first update. The adaption
   table is evaluated arithmetically (``_adapt``), which equals
   ``MSADPCM_ADAPTION[nib + 8]`` for nibbles in [-8, 7].

All state and arithmetic is int32; elementwise torch ops wrap like JAX's.

The whole-file decoders run on a torch device (``device``, default the
card): block-parallel decodes (WAV blocks, MS ADPCM streams; lanes = blocks
x channels) go through kernels (d) ``ima_decode_kernel`` and (e)
``msadpcm_decode_kernel``, and the raw IMA stream (few long lanes) through
``ima_adpcm_parallel``, the time-parallel form of its two clamped-add
recurrences.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import require_device

# aukit_tpu/codecs/adpcm.py:28-56 (reference tables, aukit.lua:158-191)
IMA_INDEX_TABLE = np.array(
    [-1, -1, -1, -1, 2, 4, 6, 8, -1, -1, -1, -1, 2, 4, 6, 8], dtype=np.int32
)
IMA_STEP_TABLE = np.array(
    [7, 8, 9, 10, 11, 12, 13, 14, 16, 17,
     19, 21, 23, 25, 28, 31, 34, 37, 41, 45,
     50, 55, 60, 66, 73, 80, 88, 97, 107, 118,
     130, 143, 157, 173, 190, 209, 230, 253, 279, 307,
     337, 371, 408, 449, 494, 544, 598, 658, 724, 796,
     876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
     2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358,
     5894, 6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899,
     15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767],
    dtype=np.int32,
)

# MS ADPCM adaption table indexed by signed nibble -8..7
MSADPCM_ADAPTION = np.array(
    [768, 614, 512, 409, 307, 230, 230, 230,  # nibbles -8..-1
     230, 230, 230, 230, 307, 409, 512, 614],  # nibbles 0..7
    dtype=np.int32,
)

MSADPCM_DEFAULT_COEFFS = (
    np.array([256, 512, 0, 192, 240, 460, 392], dtype=np.int32),
    np.array([0, -256, 0, 64, 0, -208, -232], dtype=np.int32),
)

_DELTA_CAP = 1 << 20  # defensive overflow bound (aukit_tpu/codecs/adpcm.py:13-18)


def ima_decode_samples(nibbles: torch.Tensor, predictor: torch.Tensor,
                       step_index: torch.Tensor):
    """The IMA decode loop: nibbles int[L, T] (0..15), predictor and
    step_index int32[L] -> (int32[T, L] predictors, time-major,
    (predictor, step_index))."""
    dev = nibbles.device
    nib = nibbles.t().to(torch.int32)  # [T, L]
    m = nib & 7
    idx_delta = torch.where(m < 4, -1, (m - 3) * 2).to(torch.int32)
    negative = nib >= 8
    tbl = torch.tensor(IMA_STEP_TABLE, device=dev)
    pred, sidx = predictor.to(torch.int32), step_index.to(torch.int32)
    outs = []
    for t in range(nib.shape[0]):
        step = tbl[sidx.clamp(0, 88)]
        sidx = (sidx + idx_delta[t]).clamp(0, 88)
        diff = ((m[t] * step) >> 2) + (step >> 3)
        pred = torch.where(negative[t], pred - diff, pred + diff).clamp(-32768, 32767)
        outs.append(pred)
    out = (torch.stack(outs) if outs else
           torch.empty((0, nibbles.shape[0]), dtype=torch.int32, device=dev))
    return out, (pred, sidx)


def _adapt(nib: torch.Tensor) -> torch.Tensor:
    """MSADPCM_ADAPTION[nib + 8] as cumulative threshold adds on |nib|
    (the Pallas kernel's form, msadpcm_pallas.py:39-45)."""
    m = nib.abs()
    a = 230 + 77 * (m >= 4) + 102 * (m >= 5) + 103 * (m >= 6) + 102 * (m >= 7)
    return (a + 154 * (nib == -8)).to(torch.int32)


def msadpcm_decode_samples(nibbles: torch.Tensor, sample1: torch.Tensor,
                           sample2: torch.Tensor, delta: torch.Tensor,
                           c1: torch.Tensor, c2: torch.Tensor):
    """The MS ADPCM decode loop: signed nibbles int[L, T] (-8..7), per-lane
    state and coefficients int32[L] -> (int32[T, L] samples, time-major,
    excluding the two header samples; (sample1, sample2, delta))."""
    dev = nibbles.device
    nib = nibbles.t().to(torch.int32)  # [T, L]
    adapt = _adapt(nib)
    s1, s2, d = sample1.to(torch.int32), sample2.to(torch.int32), delta.to(torch.int32)
    c1, c2 = c1.to(torch.int32), c2.to(torch.int32)
    outs = []
    for t in range(nib.shape[0]):
        lin = (s1 * c1 + s2 * c2) >> 8  # floor((s1*c1 + s2*c2) / 256)
        pred = (lin + nib[t] * d).clamp(-32768, 32767)
        d = ((adapt[t] * d) >> 8).clamp(16, _DELTA_CAP)
        s1, s2 = pred, s1
        outs.append(pred)
    out = (torch.stack(outs) if outs else
           torch.empty((0, nibbles.shape[0]), dtype=torch.int32, device=dev))
    return out, (s1, s2, d)


# -- whole-file decoders -----------------------------------------------------------


def _clampadd_scan(deltas: torch.Tensor, lo: int, hi: int, init: torch.Tensor) -> torch.Tensor:
    """All x_t of x_t = clamp(x_{t-1} + d_t, lo, hi) over the last axis, time
    parallel. Maps x -> min(max(x + a, l), h) are closed under composition
    (min/max-plus algebra):
        (f2 . f1): a = a1+a2, l = clamp(l1+a2, l2, h2), h = clamp(h1+a2, l2, h2)
    so an inclusive scan of the maps (Hillis-Steele: log2(T) passes) gives
    every step. Integer arithmetic is exact in any order; the sums are held
    in int64 (the JAX package's int32 tree agrees while they stay inside
    int32, which takes ~35,000 samples of the largest same-signed steps to
    leave). Returns int32."""
    a = deltas.to(torch.int64)
    lo_t = torch.full_like(a, lo)
    hi_t = torch.full_like(a, hi)
    l, h = lo_t, hi_t
    off, T = 1, a.shape[-1]
    while off < T:
        a1, l1, h1 = a[..., :-off], l[..., :-off], h[..., :-off]
        a2, l2, h2 = a[..., off:], l[..., off:], h[..., off:]
        a = torch.cat([a[..., :off], a1 + a2], dim=-1)
        l = torch.cat([l[..., :off], torch.clamp(l1 + a2, l2, h2)], dim=-1)
        h = torch.cat([h[..., :off], torch.clamp(h1 + a2, l2, h2)], dim=-1)
        off *= 2
    return torch.clamp(init.to(torch.int64)[..., None] + a, l, h).to(torch.int32)


def ima_adpcm_parallel(nibbles: torch.Tensor, predictor: torch.Tensor, step_index: torch.Tensor):
    """Time-parallel IMA decode of nibbles int[L, T] (0..15) from per-lane
    predictor and step index int32[L] (step index in [0, 88]) ->
    (int32[L, T] predictors, (predictor, step_index)). Both IMA recurrences
    are clamped additions:
      idx_t  = clamp(idx_{t-1} + index_delta(nib_t), 0, 88)
      pred_t = clamp(pred_{t-1} +/- diff_t,      -32768, 32767)
    where diff_t depends only on (nib_t, idx_{t-1}): scan 1 gives every step
    index, one table lookup every step, scan 2 every predictor."""
    nib = nibbles.to(torch.int32)
    tbl = torch.tensor(IMA_STEP_TABLE, device=nib.device)
    m = nib & 7
    idx_delta = torch.where(m < 4, -1, (m - 3) * 2)
    idx_all = _clampadd_scan(idx_delta, 0, 88, step_index)
    idx_prev = torch.cat([step_index.to(torch.int32)[..., None], idx_all[..., :-1]], dim=-1)
    step = tbl[idx_prev.to(torch.int64)]
    diff = ((m * step) >> 2) + (step >> 3)
    signed = torch.where(nib >= 8, -diff, diff)
    pred_all = _clampadd_scan(signed, -32768, 32767, predictor)
    return pred_all, (pred_all[..., -1], idx_all[..., -1])


def decode_ima_adpcm(
    data,
    channels: int = 1,
    top_first: bool = True,
    interleaved: bool = True,
    predictor=None,
    step_index=None,
    device="cuda",
):
    """reference aukit.adpcm (aukit.lua:1183): bytes (nibble pairs) or a nibble
    array -> int32[channels, N] predictor samples (numpy; callers normalize to
    float), decoded by ``ima_adpcm_parallel`` on ``device``.

    ``interleaved``: nibble k belongs to channel k % channels; otherwise the
    stream is split into contiguous per-channel halves.
    """
    device = require_device(device, "decode_ima_adpcm")
    if isinstance(data, (bytes, bytearray, memoryview)):
        b = np.frombuffer(bytes(data), dtype=np.uint8).astype(np.int32)
        if top_first:
            nibs = np.stack([b >> 4, b & 0x0F], axis=1).reshape(-1)
        else:
            nibs = np.stack([b & 0x0F, b >> 4], axis=1).reshape(-1)
    else:
        nibs = np.asarray(data, dtype=np.int32)
    n = len(nibs) // channels
    nibs = nibs[: n * channels]
    if interleaved:
        lanes = np.ascontiguousarray(nibs.reshape(n, channels).T)  # [C, n]
    else:
        lanes = nibs.reshape(channels, n)
    pred0 = np.zeros(channels, np.int32) if predictor is None else np.asarray(predictor, np.int32)
    sidx0 = np.zeros(channels, np.int32) if step_index is None else np.asarray(step_index, np.int32)
    if sidx0.size and (sidx0.min() < 0 or sidx0.max() > 88):
        raise ValueError("IMA step index out of range [0, 88]")
    if n == 0:
        return np.zeros((channels, 0), np.int32)
    out, _ = ima_adpcm_parallel(torch.from_numpy(lanes).to(device),
                                torch.from_numpy(pred0).to(device),
                                torch.from_numpy(sidx0).to(device))
    return out.cpu().numpy()


def ima_adpcm_blocks(nibbles: np.ndarray, predictor: np.ndarray, step_index: np.ndarray,
                     device="cuda"):
    """Block-parallel entry: nibbles[L, T], predictor[L], step_index[L] ->
    int32[L, T] (numpy). Used by the WAV container, where every block's
    header gives the state (lanes = blocks*channels decode concurrently):
    kernel (d) ``ima_decode_kernel`` on ``device`` (its plain version on the
    CPU). Empty shapes never reach the kernel."""
    from ..kernels.adpcm_cuda import ima_decode_kernel  # that module builds on this one

    device = require_device(device, "ima_adpcm_blocks")
    nib = np.asarray(nibbles, dtype=np.uint8)
    if nib.shape[0] == 0 or nib.shape[1] == 0:
        return np.zeros(nib.shape, np.int32)

    def lanes(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    out, _ = ima_decode_kernel(torch.from_numpy(np.ascontiguousarray(nib)).to(device),
                               lanes(predictor), lanes(step_index))
    return out.cpu().numpy().astype(np.int32)


def decode_msadpcm_blocks(
    nibbles: np.ndarray,
    predictor_index: np.ndarray,
    delta: np.ndarray,
    sample1: np.ndarray,
    sample2: np.ndarray,
    coefficients=None,
    device="cuda",
):
    """Block-parallel MS ADPCM: per-lane header state -> int32[L, T] samples
    (numpy), by kernel (e) ``msadpcm_decode_kernel`` on ``device``. The
    caller prepends sample2, sample1 (the header samples are emitted first,
    aukit.lua:1308-1311). Empty shapes never reach the kernel."""
    from ..kernels.adpcm_cuda import msadpcm_decode_kernel  # that module builds on this one

    device = require_device(device, "decode_msadpcm_blocks")
    if coefficients is None:
        co1, co2 = MSADPCM_DEFAULT_COEFFS
    else:
        co1 = np.asarray(coefficients[0], dtype=np.int32)
        co2 = np.asarray(coefficients[1], dtype=np.int32)
    pidx = np.asarray(predictor_index, dtype=np.int64)
    nib = np.asarray(nibbles, dtype=np.int32)
    c1, c2 = co1[pidx], co2[pidx]
    if nib.shape[0] == 0 or nib.shape[1] == 0:
        return np.zeros(nib.shape, np.int32)

    def lanes(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    out, _ = msadpcm_decode_kernel(
        torch.from_numpy(np.ascontiguousarray(nib, np.int8)).to(device), lanes(sample1),
        lanes(sample2), lanes(delta), lanes(c1), lanes(c2))
    return out.cpu().numpy().astype(np.int32)


def _signed_nibbles(data_bytes: np.ndarray) -> np.ndarray:
    """bytes[..., n] -> int32[..., n*2] signed nibbles, high nibble first
    (aukit.lua:1317)."""
    b = data_bytes.astype(np.int32)
    hi, lo = b >> 4, b & 0x0F
    nib = np.stack([hi, lo], axis=-1).reshape(*b.shape[:-1], -1)
    return np.where(nib >= 8, nib - 16, nib)


def _padded_blocks(raw: np.ndarray, block_align: int, hdr: int):
    """Whole blocks [B, block_align] plus a trailing partial block that holds
    a full header, zero-padded; and that block's count of nibble bytes (None
    when there is no such block)."""
    nblocks = len(raw) // block_align
    tail = raw[nblocks * block_align:]
    full = (raw[: nblocks * block_align].reshape(nblocks, block_align) if nblocks
            else np.zeros((0, block_align), np.uint8))
    if len(tail) >= hdr:
        pad = np.zeros(block_align - len(tail), np.uint8)
        return np.concatenate([full, np.concatenate([tail, pad])[None, :]]), len(tail) - hdr
    return full, None


def decode_msadpcm(
    data: bytes,
    block_align: int,
    channels: int = 1,
    coefficients=None,
    mono_header_from_first_block: bool = True,
    device="cuda",
):
    """reference aukit.msadpcm (aukit.lua:1283): raw block stream ->
    int32[channels, N] samples (numpy, including the two header samples per
    block), the blocks' nibbles decoded by kernel (e) on ``device``.

    Stereo blocks: 14-byte header <BBhhhhhh, nibbles alternate L/R (hi=L, lo=R).
    Mono blocks: 7-byte header <Bhhh, both nibbles belong to the channel.

    ``mono_header_from_first_block``: the reference's mono path unpacks every
    block header from position 1 (aukit.lua:1316, ``str_unpack("<!1Bhhh",
    data)`` without a position argument), so all mono blocks re-initialize
    from block 1's header. Replicated by default, as the JAX package does;
    pass False for correct per-block headers.

    Partial trailing blocks are decoded up to the available bytes (the
    reference errors mid-way on them; the JAX package's lenient deviation).
    """
    device = require_device(device, "decode_msadpcm")
    raw = np.frombuffer(data, dtype=np.uint8)
    if channels == 2:
        hdr = 14
        full, tail_valid = _padded_blocks(raw, block_align, hdr)
        if full.shape[0] == 0:
            return np.zeros((2, 0), np.int32)
        h = full[:, :hdr]
        pidx_l = h[:, 0].astype(np.int32)
        pidx_r = h[:, 1].astype(np.int32)
        s16 = h[:, 2:14].view("<i2").astype(np.int32)  # [B, 6]
        delta_l, delta_r = s16[:, 0], s16[:, 1]
        s1l, s1r, s2l, s2r = s16[:, 2], s16[:, 3], s16[:, 4], s16[:, 5]
        nib = _signed_nibbles(full[:, hdr:])  # [B, (ba-14)*2] alternating L/R
        nib = nib.reshape(full.shape[0], -1, 2)
        nl, nr = nib[:, :, 0], nib[:, :, 1]
        lanes = np.concatenate([nl, nr], axis=0)
        out = decode_msadpcm_blocks(
            lanes,
            np.concatenate([pidx_l, pidx_r]),
            np.concatenate([delta_l, delta_r]),
            np.concatenate([s1l, s1r]),
            np.concatenate([s2l, s2r]),
            coefficients,
            device,
        )
        B = full.shape[0]
        out_l, out_r = out[:B], out[B:]
        chans = []
        for header2, header1, body in ((s2l, s1l, out_l), (s2r, s1r, out_r)):
            full_blocks = np.concatenate(
                [header2[:, None], header1[:, None], body], axis=1
            )  # [B, 2 + T]
            if tail_valid is not None:
                head = full_blocks[:-1].reshape(-1)
                tail_samples = full_blocks[-1, : 2 + tail_valid]
                chans.append(np.concatenate([head, tail_samples]))
            else:
                chans.append(full_blocks.reshape(-1))
        return np.stack(chans).astype(np.int32)
    elif channels == 1:
        hdr = 7
        full, tail_valid = _padded_blocks(raw, block_align, hdr)
        if full.shape[0] == 0:
            return np.zeros((1, 0), np.int32)
        pidx = full[:, 0].astype(np.int32)
        s16 = full[:, 1:7].view("<i2").astype(np.int32)
        delta, s1, s2 = s16[:, 0], s16[:, 1], s16[:, 2]
        if mono_header_from_first_block:
            pidx = np.broadcast_to(pidx[:1], pidx.shape)
            delta = np.broadcast_to(delta[:1], delta.shape)
            s1 = np.broadcast_to(s1[:1], s1.shape)
            s2 = np.broadcast_to(s2[:1], s2.shape)
        nib = _signed_nibbles(full[:, hdr:])  # [B, (ba-7)*2]
        out = decode_msadpcm_blocks(nib, pidx, delta, s1, s2, coefficients, device)
        full_blocks = np.concatenate([s2[:, None], s1[:, None], out], axis=1)
        if tail_valid is not None:
            head = full_blocks[:-1].reshape(-1)
            tail_samples = full_blocks[-1, : 2 + tail_valid * 2]
            flat = np.concatenate([head, tail_samples])
        else:
            flat = full_blocks.reshape(-1)
        return flat[None, :].astype(np.int32)
    raise ValueError(f"Unsupported number of channels: {channels}")
