"""DFPWM1a codec in plain PyTorch — counterpart of ``aukit_tpu.codecs.dfpwm``.

DFPWM1a is a 1-bit-per-sample adaptive delta codec: the decoder integrates a
"charge" toward +127/-128 at an adaptive "strength", then applies an antijerk
averager and a one-pole low-pass. It is strictly sequential in time, so these
plain versions loop over bytes in Python (8 bit steps per byte) with the lanes
(independent streams) vectorised. They run on any device but are meant for the
CPU and as the reference the CUDA kernels (``kernels/dfpwm_cuda.py``) are held
against; the lane-batched engine decodes through the kernels.

All state and arithmetic is int32 with arithmetic right shifts, exactly as in
the JAX package (|s*(t-q)| <= 1023*255 < 2^18, so nothing overflows).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import require_device

# -- spec (aukit_tpu/codecs/dfpwm.py:36-43) ----------------------------------------

PREC = 10
PREC_POW = 1 << PREC  # 1024
PREC_HALF = 1 << (PREC - 1)  # 512
STRENGTH_MAX = PREC_POW - 1  # 1023
STRENGTH_MIN = 1 << (PREC - 7)  # 8 — canonical dfpwm1a floor, applied post-slew
LOWPASS_NUM = 140  # output low-pass strength, /256
RESP_INC = 1  # strength slew per bit toward STRENGTH_MAX
RESP_DEC = 1  # strength slew per bit toward 0

FIELDS = ("charge", "strength", "previous_bit", "previous_charge", "lowpass")


def norm8(v: torch.Tensor) -> torch.Tensor:
    """Decoded samples (int, [-128, 127]) -> float32 in [-1, 1]: negative
    values divide by 128, the rest by 127 (a true division, as in the JAX
    package, not a multiply by a reciprocal)."""
    return v.to(torch.float32) / torch.where(v < 0, 128.0, 127.0)


@dataclasses.dataclass
class DfpwmState:
    """Per-lane decoder/encoder state: five int32[lanes] tensors, in the
    order of the JAX ``DfpwmState`` leaves (``FIELDS``)."""

    charge: torch.Tensor
    strength: torch.Tensor
    previous_bit: torch.Tensor  # 0/1
    previous_charge: torch.Tensor  # decoder antijerk state
    lowpass: torch.Tensor  # decoder output low-pass state

    @staticmethod
    def zeros(lanes: int, device="cpu") -> "DfpwmState":
        return DfpwmState(*(torch.zeros(lanes, dtype=torch.int32, device=device)
                            for _ in FIELDS))

    def leaves(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f) for f in FIELDS)

    def where(self, mask: torch.Tensor, other: "DfpwmState") -> "DfpwmState":
        """Per lane: this state where ``mask``, else ``other``'s."""
        return DfpwmState(*(torch.where(mask, a, b)
                            for a, b in zip(self.leaves(), other.leaves())))


class _Consts(NamedTuple):
    """The spec constants as 0-d int32 tensors on one device: a binary op on
    two tensors dispatches about twice as fast as one with a Python int."""

    half: torch.Tensor
    prec: torch.Tensor
    smax: torch.Tensor
    smin: torch.Tensor
    zero: torch.Tensor
    one: torch.Tensor
    inc: torch.Tensor
    dec: torch.Tensor
    lp_num: torch.Tensor
    lp_round: torch.Tensor
    lp_shift: torch.Tensor

    @staticmethod
    def on(device) -> "_Consts":
        return _Consts(*(torch.tensor(v, dtype=torch.int32, device=device) for v in (
            PREC_HALF, PREC, STRENGTH_MAX, STRENGTH_MIN, 0, 1, RESP_INC, -RESP_DEC,
            LOWPASS_NUM, 0x80, 8)))


def _predictor_step(q, s, lb, bit, target, sign, k: _Consts):
    """One shared predictor update (decoder and encoder) on int32 tensors:
    ``bit`` 0/1, ``target`` 127|-128 and ``sign`` +1|-1 by bit. Returns
    (charge, strength, bit == previous bit)."""
    nq = q + ((s * (target - q) + k.half) >> k.prec)
    nq = nq + ((nq == q) & (nq != target)) * sign
    same = bit == lb
    ns = s + (s != torch.where(same, k.smax, k.zero)) * torch.where(same, k.inc, k.dec)
    return nq, torch.maximum(ns, k.smin), same


def _bit_planes(bytes_u8: torch.Tensor) -> torch.Tensor:
    """uint8[L, B] -> int32[B*8, L] bits, time-major, LSB first in each byte."""
    lanes, nbytes = bytes_u8.shape
    shifts = torch.arange(8, dtype=torch.int32, device=bytes_u8.device)
    b = bytes_u8.t().to(torch.int32)
    return ((b[:, None, :] >> shifts[None, :, None]) & 1).reshape(nbytes * 8, lanes)


def decode_samples(bytes_u8: torch.Tensor, state: DfpwmState):
    """The decode loop: uint8[L, B] -> (int32[B*8, L] samples, time-major,
    new_state)."""
    k = _Consts.on(bytes_u8.device)
    bits = _bit_planes(bytes_u8)
    target, sign = bits * 255 - 128, bits * 2 - 1
    q, s, lb, pq, lp = state.leaves()
    outs = []
    for i in range(bits.shape[0]):
        bit = bits[i]
        nq, s, same = _predictor_step(q, s, lb, bit, target[i], sign[i], k)
        aj = torch.where(same, nq, (nq + pq + k.one) >> k.one)  # antijerk on flips
        lp = lp + (((aj - lp) * k.lp_num + k.lp_round) >> k.lp_shift)
        outs.append(lp)
        q = pq = nq
        lb = bit
    out = (torch.stack(outs) if outs else
           torch.empty((0, bytes_u8.shape[0]), dtype=torch.int32, device=bytes_u8.device))
    return out, DfpwmState(q, s, lb, pq, lp)


def dfpwm_decode(bytes_u8: torch.Tensor, state: DfpwmState):
    """Decode ``uint8[lanes, nbytes]`` -> (int32[lanes, nbytes*8], new_state).

    Bits are consumed LSB-first within each byte (DFPWM convention). Output
    samples are signed 8-bit values in [-128, 127] stored as int32.
    """
    out, state = decode_samples(bytes_u8, state)
    return out.t().contiguous(), state


def dfpwm_encode(levels_i32: torch.Tensor, state: DfpwmState):
    """Encode ``int32[lanes, nsamples]`` (values in [-128, 127]) ->
    (uint8[lanes, nsamples//8], new_state). nsamples must be a multiple of 8.

    Bit decision: 1 iff level > charge, or level == charge == 127 (the mirror
    of the decoder, so silence encodes to alternating bits).
    """
    lanes, nsamples = levels_i32.shape
    k = _Consts.on(levels_i32.device)
    top = torch.tensor(127, dtype=torch.int32, device=levels_i32.device)
    levels = levels_i32.to(torch.int32).t()
    q, s, lb = state.charge, state.strength, state.previous_bit
    byte = torch.zeros(lanes, dtype=torch.int32, device=levels.device)
    out = []
    for i in range(nsamples):
        level = levels[i]
        bit = ((level > q) | ((level == q) & (q == top))).to(torch.int32)
        q, s, _ = _predictor_step(q, s, lb, bit, bit * 255 - 128, bit * 2 - 1, k)
        lb = bit
        byte = byte | (bit << (i % 8))
        if i % 8 == 7:
            out.append(byte)
            byte = torch.zeros_like(byte)
    enc = (torch.stack(out, dim=1).to(torch.uint8) if out else
           torch.empty((lanes, 0), dtype=torch.uint8, device=levels.device))
    return enc, DfpwmState(q, s, lb, state.previous_charge, state.lowpass)


# -- the stream iterators' decoder -----------------------------------------------------


class DfpwmStreamDecoder:
    """Stateful lane-batched decoder mirroring ``dfpwm.make_decoder()``
    semantics: feed successive byte chunks, receive int32 sample arrays (the
    JAX package's ``DfpwmStreamDecoder``). ``stream.dfpwm`` feeds it 6000 *
    channels bytes a call (aukit.lua:2446), ``stream.mdfpwm`` two lanes of
    6000. Routed as ``_routed_decode`` routes a chunk: ``device`` is where
    kernel (a) runs where the native library is absent, and is checked
    there; the native route needs no card."""

    def __init__(self, lanes: int = 1, *, device="cuda"):
        self.lanes = lanes
        self.device = device
        self.state = DfpwmState.zeros(lanes)

    def decode(self, chunks) -> np.ndarray:
        """uint8[lanes, n] (or bytes for lanes==1) -> int32[lanes, n*8]"""
        if isinstance(chunks, (bytes, bytearray, memoryview)):
            chunks = np.frombuffer(bytes(chunks), dtype=np.uint8)[None, :]
        chunks = np.atleast_2d(np.asarray(chunks, dtype=np.uint8))
        if chunks.shape[1] == 0:
            return np.zeros((chunks.shape[0], 0), np.int32)
        out, self.state = _routed_decode(chunks, self.state, self.device)
        return out


def _routed_decode(chunks: np.ndarray, state: DfpwmState, device):
    """Host-resident bytes of a few lanes -> (int32[L, n*8] numpy, new state),
    routed as the JAX package routes them: the native C++ rows decoder when
    it builds (a chunk of one or two lanes is one thread's serial step, which
    the host runs 2-3x faster than one lane of kernel (a), PERF.md section
    6), else kernel (a) ``dfpwm_decode_kernel`` on ``device`` (its plain
    version on the CPU; a CUDA ``device`` without a card raises). The state
    stays where its route runs it."""
    from ..kernels.dfpwm_cuda import dfpwm_decode_kernel  # that module builds on this one
    from ..native import flacbits as _nb

    if _nb.available():
        st = np.stack([a.cpu().numpy() for a in state.leaves()]).astype(np.int32)
        out, st2 = _nb.dfpwm_decode_rows(chunks, st)
        return out, DfpwmState(*(torch.from_numpy(st2[i].copy()) for i in range(5)))
    device = require_device(device, "DfpwmStreamDecoder")
    state = DfpwmState(*(a.to(device) for a in state.leaves()))
    out, state = dfpwm_decode_kernel(torch.tensor(chunks, device=device), state)
    return out.to(torch.int32).cpu().numpy(), state


# -- whole-buffer entry points ----------------------------------------------------------

def decode_dfpwm_bytes(data: bytes, state: DfpwmState | None = None, device="cuda"):
    """Whole-buffer decode: bytes -> (np.int32[n*8], DfpwmState), through
    ``dfpwm_decode_kernel`` on ``device`` (the CUDA kernel; pass
    ``device="cpu"`` for its plain version)."""
    from ..kernels.dfpwm_cuda import dfpwm_decode_kernel  # that module builds on this one

    device = require_device(device, "decode_dfpwm_bytes")
    if state is None:
        state = DfpwmState.zeros(1, device)
    if len(data) == 0:  # empty input never reaches the kernel
        return np.zeros(0, np.int32), state
    raw = torch.tensor(np.frombuffer(bytes(data), np.uint8)[None, :], device=device)
    out, state = dfpwm_decode_kernel(raw, state)
    return out[0].to(torch.int32).cpu().numpy(), state


def encode_dfpwm_bytes(levels, state: DfpwmState | None = None, device="cuda"):
    """Whole-buffer encode: int levels [-128,127] -> (bytes, DfpwmState),
    through ``dfpwm_encode_kernel`` on ``device`` (pass ``device="cpu"`` for
    its plain version). Length is truncated to a multiple of 8 samples (the
    encoder consumes whole bytes)."""
    from ..kernels.dfpwm_cuda import dfpwm_encode_kernel  # that module builds on this one

    device = require_device(device, "encode_dfpwm_bytes")
    levels = np.asarray(levels, dtype=np.int32).reshape(-1)
    if levels.size and (levels.min() < -128 or levels.max() > 127):
        raise ValueError("DFPWM levels must lie in [-128, 127]")
    n = (len(levels) // 8) * 8
    if state is None:
        state = DfpwmState.zeros(1, device)
    if n == 0:
        return b"", state
    raw = torch.tensor(levels[None, :n].astype(np.int8), device=device)
    out, state = dfpwm_encode_kernel(raw, state)
    return out[0].cpu().numpy().tobytes(), state


def decode_dfpwm_audio(data: bytes, channels: int = 1, sample_rate: int = 48000, device="cuda"):
    """reference aukit.dfpwm (aukit.lua:1392): decode the full buffer with ONE
    shared decoder (kernel (a) on one lane, the whole file), then treat the
    samples as interleaved 8-bit signed PCM -> float32[channels, N] (numpy)."""
    from ..ops.pcmcode import decode_pcm

    samples, _ = decode_dfpwm_bytes(data, device=device)
    return decode_pcm(samples.astype(np.int64), 8, "signed", channels, True)


def encode_dfpwm_audio(audio, interleaved: bool = True):
    """reference Audio:dfpwm (aukit.lua:1005) on the audio's device, by
    kernel (c): one shared encoder over the interleaved samples (one lane),
    or one encoder per channel when planar (one lane a channel). The levels
    are the JAX package's ``trunc(Audio.pcm(8, "signed"))``, computed in
    float64 on the device. Levels beyond [-128, 127] (audio outside [-1, 1])
    are clamped first: the encoder's bit decision gives the same bits for a
    level and for its clamp."""
    from ..kernels.dfpwm_cuda import dfpwm_encode_kernel  # that module builds on this one

    v = audio.data.to(torch.float64)
    levels = torch.trunc(v * torch.where(v < 0, 128.0, 127.0)).clamp(-128, 127).to(torch.int8)
    if interleaved:
        levels = levels.t().reshape(1, -1)
    n = (levels.shape[1] // 8) * 8
    if n == 0:
        return b"" if interleaved else tuple(b"" for _ in range(levels.shape[0]))
    out, _ = dfpwm_encode_kernel(levels[:, :n].contiguous(),
                                 DfpwmState.zeros(levels.shape[0], levels.device))
    out = out.cpu().numpy()
    if interleaved:
        return out[0].tobytes()
    return tuple(out[c].tobytes() for c in range(out.shape[0]))
