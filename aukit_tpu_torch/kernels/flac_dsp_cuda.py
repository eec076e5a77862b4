"""The FLAC lanes' float64 DSP kernel: CUDA C++ for Hopper
(``csrc/flac_dsp.cu``) and its plain PyTorch version. It replaces no TPU
kernel: the JAX package runs this DSP on the host in numpy
(``aukit_tpu.stream.flac_fleet`` ``_host_dsp``), and the kernel takes that
route's work onto the card with the same float64 arithmetic.

One call covers one geometry group of a FLAC fleet step: lanes whose frames
share a rate, a channel count C and one block size n >= 2 (``DspGeometry``).
Per lane, its blocks in time order: stereo decorrelation by each block's own
channel assignment and sign wrap of the restored int64 samples, division by
2^depth, the block resample ("none" or "linear"), the recursive-doubling
lowpass chained block to block, the gain (a scalar or a ramp line), the
int8-range scale and clip, the channel handling and the float32 cast, each
operation in the order and rounding of ``FlacFleet._host_dsp`` (its native
``block_resample_rows`` and ``iir_scan_rows``), so that both versions are
bit-equal to it.

Tables, on the CPU: ``lanes`` int64[L, 6] (the lane's first restored sample
in ``restored``, its block count, its first output element in ``out``, its
ramp position and ramp length, and where its blocks' assignments start in
``asgn``), ``asgn`` int32 (one FLAC channel assignment a block: 0-7
independent channels, 8-10 left/side, side/right, mid/side, which only a
stereo group takes) and ``fin`` float64[L, 2 + C] (the ramp's start gain,
the gain, the C lowpass states). ``lanes`` and ``asgn`` reach the card in
one copy. Each lane writes
``[C, blocks * out_len]`` (out_mode "multi") or ``[blocks * out_len]``
float32 at its offset in ``out``; the call returns float64[L, 3C]: the C
new lowpass states, then the C pairs of last decoded samples (the resample
history). ``restored`` and ``out`` on the CPU go to the plain version; on a
CUDA device to the kernel, or the wrapper raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ._wrap import stream_of

LANE_FIELDS = 6  # in_off, blocks, out_off, ramp_pos, ramp_len, asgn_off
OUT_MODES = ("first", "mix", "multi")
SMEM_BYTES = 232448  # the shared memory one thread block may use on the H100


class DspGeometry(NamedTuple):
    channels: int
    block: int  # n, the frames' block size
    depth: int
    rate: int
    out_rate: int
    out_len: int  # samples a block resamples to
    linear: bool  # "linear" interpolation, else "none"
    out_mode: str  # "first" (mono, one channel), "mix" (mono), "multi"
    alpha: float  # the lowpass coefficient (parallel.pipeline.fir_alpha)


def geometry(rate: int, channels: int, depth: int, block: int, asgns, out_rate: int,
             mode: str, out_mode: str, alpha: float) -> DspGeometry | None:
    """The kernel's geometry for frames of ``block`` samples, ``channels``
    channels of ``depth`` bits at ``rate`` with the channel assignments
    ``asgns`` (one a frame, an int array), resampled to ``out_rate`` with
    interpolation ``mode``; or None where the kernel does not take them:
    interpolation other than "none" or "linear", a block under 2 samples or
    one that resamples to none, an assignment of 8-10 on other than 2
    channels or one over 10, "first" on other than 1 channel, or a block
    whose samples (twice, float64) and carried states overflow the kernel's
    shared memory."""
    out_len = block * out_rate // rate if rate > 0 else 0
    a = np.asarray(asgns)
    if not (mode in ("none", "linear") and 1 <= channels <= 8 and block >= 2
            and 1 <= depth <= 32 and out_len >= 1 and out_rate > 0
            and (a.size == 0 or (a.min() >= 0 and a.max() <= (10 if channels == 2 else 7)))
            and out_mode in OUT_MODES
            and (out_mode != "first" or channels == 1)
            and (2 * channels * out_len + channels) * 8 <= SMEM_BYTES):
        return None
    return DspGeometry(channels, block, depth, rate, out_rate, out_len, mode == "linear",
                       out_mode, float(alpha))


def _check(restored, lanes, asgn, fin, out, geo: DspGeometry) -> None:
    C, n = geo.channels, geo.block
    if restored.dtype != torch.int64 or restored.dim() != 1 or not restored.is_contiguous():
        raise ValueError(f"restored must be contiguous int64[N], got {restored.dtype}"
                         f"{list(restored.shape)}")
    if out.dtype != torch.float32 or out.dim() != 1 or not out.is_contiguous() \
            or out.device != restored.device:
        raise ValueError(f"out must be contiguous float32[M] on {restored.device}")
    if restored.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {restored.device}")
    L = lanes.shape[0]
    if lanes.dtype != torch.int64 or tuple(lanes.shape) != (L, LANE_FIELDS) \
            or lanes.device.type != "cpu":
        raise ValueError(f"lanes must be int64[L, {LANE_FIELDS}] on the CPU")
    if asgn.dtype != torch.int32 or asgn.dim() != 1 or asgn.device.type != "cpu":
        raise ValueError("asgn must be int32[B] on the CPU")
    if fin.dtype != torch.float64 or tuple(fin.shape) != (L, 2 + C) or fin.device.type != "cpu":
        raise ValueError(f"fin must be float64[{L}, {2 + C}] on the CPU")
    if geometry(geo.rate, C, geo.depth, n, asgn, geo.out_rate,
                "linear" if geo.linear else "none", geo.out_mode, geo.alpha) != geo:
        raise ValueError(f"unsupported geometry {geo} or assignment")
    if L:
        in_off, m, out_off, a_off = lanes[:, 0], lanes[:, 1], lanes[:, 2], lanes[:, 5]
        width = C if geo.out_mode == "multi" else 1
        if bool((m < 1).any() or (in_off < 0).any() or (out_off < 0).any()
                or (a_off < 0).any()):
            raise ValueError("every lane needs a block and offsets >= 0")
        if int((in_off + m * C * n).max()) > restored.numel() \
                or int((out_off + m * width * geo.out_len).max()) > out.numel() \
                or int((a_off + m).max()) > asgn.numel():
            raise ValueError("a lane's offsets run past restored, out or asgn")


def flac_dsp_ref(restored: torch.Tensor, lanes: torch.Tensor, asgn: torch.Tensor,
                 fin: torch.Tensor, out: torch.Tensor, geo: DspGeometry) -> torch.Tensor:
    """The DSP in torch float64 operations, lanes vectorised a block round
    at a time, each lane's block decorrelated by its own assignment; each
    operation rounds once, in the host route's order."""
    flac_dsp_ref.calls += 1
    _check(restored, lanes, asgn, fin, out, geo)
    dev = restored.device
    C, n, out_len = geo.channels, geo.block, geo.out_len
    L = lanes.shape[0]
    lanes, asgn, fin = lanes.to(dev), asgn.to(dev), fin.to(dev)
    in_off, m, out_off, ramp_pos, ramp_len, a_off = lanes.unbind(1)
    g0, g1 = fin[:, 0], fin[:, 1]
    carry = fin[:, 2:].clone()
    state = torch.empty((L, 3 * C), dtype=torch.float64, device=dev)
    i = torch.arange(out_len, dtype=torch.int64, device=dev)
    num = i * geo.rate
    f0 = num // geo.out_rate
    rem = num - f0 * geo.out_rate
    frac = rem.to(torch.float64) / geo.out_rate
    f2 = torch.where(f0 + 1 <= n - 1, f0 + 1, f0)
    t = i.to(torch.float64)
    c = 1.0 - geo.alpha
    half, full = 1 << (geo.depth - 1), 1 << geo.depth
    width = C if geo.out_mode == "multi" else 1
    T = m * out_len
    for r in range(int(m.max()) if L else 0):
        act = torch.nonzero(m > r)[:, 0]
        base = in_off[act] + r * C * n
        chans = restored[base[:, None] + torch.arange(C * n, device=dev)].reshape(-1, C, n)
        if C == 2:  # 0-7 keep the rows; 8 left/side, 9 side/right, 10 mid/side
            k = asgn[a_off[act] + r][:, None]
            a, b = chans[:, 0], chans[:, 1]
            right = a - (b >> 1)
            chans = torch.stack([torch.where(k == 9, a + b, torch.where(k == 10, right + b, a)),
                                 torch.where(k == 8, a - b, torch.where(k == 10, right, b))],
                                dim=1)
        dec = torch.where(chans >= half, chans - full, chans).to(torch.float64) / full
        p1 = dec[..., f0]
        v = torch.where(rem == 0, p1, p1 + (dec[..., f2] - p1) * frac) if geo.linear else p1
        y = v * geo.alpha
        y[..., 0] = y[..., 0] + c * carry[act]
        ck, shift = c, 1
        while shift < out_len:
            if ck == 0.0:
                break
            y = torch.cat([y[..., :shift], y[..., shift:] + ck * y[..., :-shift]], dim=-1)
            ck = ck * ck
            shift *= 2
        carry[act] = y[..., -1]
        state[act, C:] = dec[..., n - 2:].reshape(-1, 2 * C)
        pos = ramp_pos[act] + r * out_len
        line = (ramp_len[act] > 0) & (pos < ramp_len[act]) & (g0[act] != g1[act])
        x = (pos.to(torch.float64)[:, None] + t) / ramp_len[act].to(torch.float64)[:, None]
        x = torch.where(x > 1.0, 1.0, x)
        ga, gb = g0[act][:, None], g1[act][:, None]
        g = torch.where(line[:, None], ga + (gb - ga) * x, gb)
        y = y * g[:, None, :]
        s = torch.clamp(y * torch.where(y < 0, 128.0, 127.0), -128.0, 127.0)
        if geo.out_mode == "mix":
            acc = s[:, 0]
            for ch in range(1, C):
                acc = acc + s[:, ch]
            s = (acc / C)[:, None]
        elif geo.out_mode == "first":
            s = s[:, :1]
        idx = (out_off[act][:, None, None] + torch.arange(width, device=dev)[None, :, None]
               * T[act][:, None, None] + r * out_len + i)
        out[idx.reshape(-1)] = s.to(torch.float32).reshape(-1)
    state[:, :C] = carry
    return state


flac_dsp_ref.calls = 0


def flac_dsp_kernel(restored: torch.Tensor, lanes: torch.Tensor, asgn: torch.Tensor,
                    fin: torch.Tensor, out: torch.Tensor, geo: DspGeometry) -> torch.Tensor:
    """One geometry group's DSP (see the module docstring): writes each
    lane's float32 samples into ``out`` and returns the float64[L, 3C]
    states, on ``restored``'s device. The CUDA kernel is
    ``aukit_flac_dsp_f64``; it replaces no TPU kernel."""
    if restored.device.type == "cpu":
        return flac_dsp_ref(restored, lanes, asgn, fin, out, geo)
    _check(restored, lanes, asgn, fin, out, geo)
    L, C = lanes.shape[0], geo.channels
    dev = restored.device
    state = torch.empty((L, 3 * C), dtype=torch.float64, device=dev)
    if L == 0:
        return state
    # the lane table, then the assignments, in one buffer and one copy
    tables = torch.cat([lanes.contiguous().view(-1).view(torch.int32), asgn]).to(dev)
    fin_d = fin.contiguous().to(dev)
    with torch.cuda.device(dev):
        rc = _build.load().aukit_flac_dsp_f64(
            restored.data_ptr(), tables.data_ptr(), tables.data_ptr() + lanes.numel() * 8,
            fin_d.data_ptr(), out.data_ptr(), state.data_ptr(), L, C, geo.block, geo.depth,
            geo.rate, geo.out_rate, geo.out_len, int(geo.linear),
            OUT_MODES.index(geo.out_mode), float(geo.alpha), stream_of(restored))
    _build.check(rc, "aukit_flac_dsp_f64")
    flac_dsp_kernel.launches += 1
    return state


flac_dsp_kernel.launches = 0


KERNELS = (flac_dsp_kernel,)
PLAIN = (flac_dsp_ref,)
