"""DFPWM1a decode and encode kernels: CUDA C++ for Hopper (``csrc/dfpwm.cu``)
and their plain PyTorch versions — counterpart of
``aukit_tpu.kernels.dfpwm_pallas``.

The wrappers keep the JAX convenience wrappers' layout
(``dfpwm_decode_pallas`` / ``dfpwm_decode_dsp_pallas`` /
``dfpwm_encode_pallas``): lane-major ``uint8[L, B]`` bytes and ``int8[L, 8B]``
samples, so the two packages compare like with like. A tensor on the CPU
goes to the plain version; a tensor on a CUDA device goes to the kernel, or
the wrapper raises. Each
wrapper counts its kernel launches in its ``launches`` attribute, and each
plain version its calls in ``calls``, so a run can show which one served it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs.dfpwm import FIELDS, DfpwmState, decode_samples, dfpwm_encode, norm8
from . import _build
from ._wrap import check_lane_vector, check_rows, stream_of
from .fma_cuda import fma_ref

# -- plain versions ------------------------------------------------------------------


def dfpwm_decode_ref(bytes_u8: torch.Tensor, state: DfpwmState):
    """uint8[L, B] -> (int8[L, 8B], state): the decode loop of
    ``codecs.dfpwm``, one Python step per bit with the lanes vectorised."""
    dfpwm_decode_ref.calls += 1
    out, state = decode_samples(bytes_u8, state)
    return out.t().to(torch.int8).contiguous(), state


def dfpwm_decode_dsp_ref(bytes_u8: torch.Tensor, state: DfpwmState, alpha: float,
                         mask: torch.Tensor | None = None, gain=None):
    """uint8[L, B] -> (int8[L, 8B], state): decode, then the identity-rate
    epilogue of ``parallel.pipeline.dsp_chain``. Each sample is normalised
    (/128 | /127) and smoothed as ``prev + alpha*(cur - prev)``, where prev
    starts as the normalised incoming ``lowpass`` state. It is then scaled by
    ``g0 + slope*t`` when ``gain = (g0, slope)`` is given, scaled to int8,
    clipped and truncated. Each multiply feeding an add is one fused
    multiply-add (``fma_ref``), as in the JAX engine's jitted step. Lanes
    whose ``mask`` is False emit zeros, but their state still advances."""
    dfpwm_decode_dsp_ref.calls += 1
    lp0 = state.lowpass
    raw, state = decode_samples(bytes_u8, state)  # [T, L]
    f = norm8(raw.t())
    prev = torch.cat([norm8(lp0)[:, None], f[:, :-1]], dim=1)
    out = fma_ref(alpha, f - prev, prev)
    if gain is not None:
        g0, gslope = gain
        t = torch.arange(out.shape[1], dtype=torch.float32, device=out.device)
        out = out * fma_ref(gslope[:, None], t, g0[:, None])
    out = out * torch.where(out < 0, 128.0, 127.0)
    out = out.clamp(-128.0, 127.0).to(torch.int8)
    if mask is not None:
        out = torch.where(mask[:, None], out, 0)
    return out, state


def dfpwm_encode_ref(levels_i8: torch.Tensor, state: DfpwmState):
    """int8[L, N] levels (N a multiple of 8) -> (uint8[L, N/8], state): the
    encode loop of ``codecs.dfpwm``, one Python step per sample with the
    lanes vectorised. ``previous_charge`` and ``lowpass`` pass through."""
    dfpwm_encode_ref.calls += 1
    return dfpwm_encode(levels_i8, state)


dfpwm_decode_ref.calls = 0
dfpwm_decode_dsp_ref.calls = 0
dfpwm_encode_ref.calls = 0

# -- kernel wrappers -------------------------------------------------------------------


def _check_inputs(bytes_u8: torch.Tensor, state: DfpwmState):
    if bytes_u8.dtype != torch.uint8 or bytes_u8.dim() != 2:
        raise ValueError(f"bytes must be uint8[L, B], got {bytes_u8.dtype}"
                         f"{list(bytes_u8.shape)}")
    if bytes_u8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bytes_u8.device}")
    lanes = bytes_u8.shape[0]
    for name, leaf in zip(FIELDS, state.leaves()):
        if (leaf.dtype != torch.int32 or tuple(leaf.shape) != (lanes,)
                or leaf.device != bytes_u8.device):
            raise ValueError(f"state.{name} must be int32[{lanes}] on "
                             f"{bytes_u8.device}, got {leaf.dtype}"
                             f"{list(leaf.shape)} on {leaf.device}")


def _launch_args(bytes_u8: torch.Tensor, state: DfpwmState):
    if not bytes_u8.is_contiguous():
        raise ValueError("bytes must be contiguous")
    lanes, nbytes = bytes_u8.shape
    st_in = torch.stack(state.leaves())  # int32[5, L]
    out = torch.empty((lanes, nbytes * 8), dtype=torch.int8, device=bytes_u8.device)
    st_out = torch.empty_like(st_in)
    stream = stream_of(bytes_u8)
    return st_in, out, st_out, stream


def dfpwm_decode_kernel(bytes_u8: torch.Tensor, state: DfpwmState):
    """uint8[L, B] -> (int8[L, 8B] raw samples, new state). The CUDA kernel
    ``aukit_dfpwm_decode`` replaces ``dfpwm_decode_grouped``
    (aukit_tpu/kernels/dfpwm_pallas.py:113)."""
    _check_inputs(bytes_u8, state)
    if bytes_u8.device.type == "cpu":
        return dfpwm_decode_ref(bytes_u8, state)
    lanes, nbytes = bytes_u8.shape
    if lanes == 0 or nbytes == 0:
        return torch.empty((lanes, 0), dtype=torch.int8, device=bytes_u8.device), state
    st_in, out, st_out, stream = _launch_args(bytes_u8, state)
    with torch.cuda.device(bytes_u8.device):
        rc = _build.load().aukit_dfpwm_decode(
            bytes_u8.data_ptr(), st_in.data_ptr(), out.data_ptr(), st_out.data_ptr(),
            lanes, nbytes, stream)
    _build.check(rc, "aukit_dfpwm_decode")
    dfpwm_decode_kernel.launches += 1
    return out, DfpwmState(*st_out.unbind(0))


def dfpwm_decode_dsp_kernel(bytes_u8: torch.Tensor, state: DfpwmState, alpha: float,
                            mask: torch.Tensor | None = None, gain=None):
    """Decode with the fused identity-rate DSP epilogue (see
    ``dfpwm_decode_dsp_ref``): uint8[L, B] -> (int8[L, 8B], new state).
    ``mask``: optional bool[L] lane liveness; ``gain``: optional
    (gain0 f32[L], slope_per_sample f32[L]). The CUDA kernel
    ``aukit_dfpwm_decode_dsp`` replaces ``dfpwm_decode_dsp_grouped``
    (aukit_tpu/kernels/dfpwm_pallas.py:237)."""
    _check_inputs(bytes_u8, state)
    if mask is not None:
        check_lane_vector("mask", mask, torch.bool, bytes_u8)
    if gain is not None:
        for name, g in zip(("gain0", "gain slope"), gain):
            check_lane_vector(name, g, torch.float32, bytes_u8)
    if bytes_u8.device.type == "cpu":
        return dfpwm_decode_dsp_ref(bytes_u8, state, alpha, mask, gain)
    lanes, nbytes = bytes_u8.shape
    if lanes == 0 or nbytes == 0:
        return torch.empty((lanes, 0), dtype=torch.int8, device=bytes_u8.device), state
    st_in, out, st_out, stream = _launch_args(bytes_u8, state)
    g0, gs = (None, None) if gain is None else (gain[0].data_ptr(), gain[1].data_ptr())
    with torch.cuda.device(bytes_u8.device):
        rc = _build.load().aukit_dfpwm_decode_dsp(
            bytes_u8.data_ptr(), st_in.data_ptr(), out.data_ptr(), st_out.data_ptr(),
            lanes, nbytes, float(np.float32(alpha)),
            None if mask is None else mask.data_ptr(), g0, gs, stream)
    _build.check(rc, "aukit_dfpwm_decode_dsp")
    dfpwm_decode_dsp_kernel.launches += 1
    return out, DfpwmState(*st_out.unbind(0))


def dfpwm_encode_kernel(levels_i8: torch.Tensor, state: DfpwmState):
    """int8[L, N] levels (N a multiple of 8) -> (uint8[L, N/8] DFPWM bytes,
    new state): bit = ``level > charge`` or ``level == charge == 127``, the
    decoder's predictor, 8 bits packed LSB first. Only charge, strength and
    previous bit take part; ``previous_charge`` and ``lowpass`` pass through
    untouched, as in ``dfpwm_encode_pallas``. The CUDA kernel
    ``aukit_dfpwm_encode`` replaces ``dfpwm_encode_grouped``
    (aukit_tpu/kernels/dfpwm_pallas.py:348)."""
    check_rows("levels", levels_i8, torch.int8)
    lanes, nsamples = levels_i8.shape
    if nsamples % 8:
        raise ValueError(f"levels must hold a multiple of 8 samples per lane, got {nsamples}")
    for name, leaf in zip(FIELDS, state.leaves()):
        check_lane_vector(f"state.{name}", leaf, torch.int32, levels_i8)
    if levels_i8.device.type == "cpu":
        return dfpwm_encode_ref(levels_i8, state)
    out = torch.empty((lanes, nsamples // 8), dtype=torch.uint8, device=levels_i8.device)
    if out.numel() == 0:
        return out, state
    # the kernel reads each row as 4-byte words
    if not levels_i8.is_contiguous() or levels_i8.data_ptr() % 4:
        levels_i8 = levels_i8.clone(memory_format=torch.contiguous_format)
    st_in = torch.stack(state.leaves()[:3])  # int32[3, L]
    st_out = torch.empty_like(st_in)
    with torch.cuda.device(levels_i8.device):
        rc = _build.load().aukit_dfpwm_encode(
            levels_i8.data_ptr(), st_in.data_ptr(), out.data_ptr(), st_out.data_ptr(),
            lanes, nsamples // 8, stream_of(levels_i8))
    _build.check(rc, "aukit_dfpwm_encode")
    dfpwm_encode_kernel.launches += 1
    return out, DfpwmState(*st_out.unbind(0), state.previous_charge, state.lowpass)


dfpwm_decode_kernel.launches = 0
dfpwm_decode_dsp_kernel.launches = 0
dfpwm_encode_kernel.launches = 0

KERNELS = (dfpwm_decode_kernel, dfpwm_decode_dsp_kernel, dfpwm_encode_kernel)
PLAIN = (dfpwm_decode_ref, dfpwm_decode_dsp_ref, dfpwm_encode_ref)

