"""IMA and MS ADPCM block-lane decode kernels: CUDA C++ for Hopper
(``csrc/adpcm.cu``) and their plain PyTorch versions — counterpart of
``aukit_tpu.kernels.ima_pallas`` and ``aukit_tpu.kernels.msadpcm_pallas``.

The wrappers keep the JAX convenience wrappers' lane-major layout
(``ima_decode_pallas`` / ``msadpcm_decode_pallas``): nibbles ``[L, T]`` and
per-lane state in, ``int16[L, T]`` samples and the final state out. A tensor
on the CPU goes to the plain version; a tensor on a CUDA device goes to the
kernel, or the wrapper raises. Each wrapper counts its kernel launches in
``launches``, and each plain version its calls in ``calls``.
"""

from __future__ import annotations

import torch

from ..codecs.adpcm import ima_decode_samples, msadpcm_decode_samples
from . import _build
from ._wrap import check_lane_vector, check_rows, stream_of

# -- plain versions ------------------------------------------------------------------


def ima_decode_ref(nibbles: torch.Tensor, predictor: torch.Tensor, step_index: torch.Tensor):
    """uint8[L, T] nibbles (0..15), int32[L] predictor and step index ->
    (int16[L, T] predictors, (predictor, step_index)): the loop of
    ``codecs.adpcm``, one Python step per sample."""
    ima_decode_ref.calls += 1
    out, state = ima_decode_samples(nibbles, predictor, step_index)
    return out.t().to(torch.int16).contiguous(), state


def msadpcm_decode_ref(nibbles: torch.Tensor, sample1: torch.Tensor, sample2: torch.Tensor,
                       delta: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor):
    """int8[L, T] signed nibbles (-8..7), int32[L] state and coefficients ->
    (int16[L, T] samples, (sample1, sample2, delta)): the loop of
    ``codecs.adpcm``, one Python step per sample."""
    msadpcm_decode_ref.calls += 1
    out, state = msadpcm_decode_samples(nibbles, sample1, sample2, delta, c1, c2)
    return out.t().to(torch.int16).contiguous(), state


ima_decode_ref.calls = 0
msadpcm_decode_ref.calls = 0

# -- kernel wrappers -------------------------------------------------------------------


def _check(nibbles: torch.Tensor, dtype: torch.dtype, lane_vectors: dict) -> None:
    check_rows("nibbles", nibbles, dtype)
    for name, v in lane_vectors.items():
        check_lane_vector(name, v, torch.int32, nibbles)


def ima_decode_kernel(nibbles: torch.Tensor, predictor: torch.Tensor, step_index: torch.Tensor):
    """uint8[L, T] nibbles + int32[L] state -> (int16[L, T] predictors,
    (predictor, step_index)). The CUDA kernel ``aukit_ima_decode`` replaces
    ``ima_decode_grouped`` (aukit_tpu/kernels/ima_pallas.py:94)."""
    _check(nibbles, torch.uint8, {"predictor": predictor, "step_index": step_index})
    if nibbles.device.type == "cpu":
        return ima_decode_ref(nibbles, predictor, step_index)
    if not nibbles.is_contiguous():
        raise ValueError("nibbles must be contiguous")
    lanes, T = nibbles.shape
    if lanes == 0 or T == 0:
        return (torch.empty((lanes, T), dtype=torch.int16, device=nibbles.device),
                (predictor, step_index))
    st_in = torch.stack([predictor, step_index])
    out = torch.empty((lanes, T), dtype=torch.int16, device=nibbles.device)
    st_out = torch.empty_like(st_in)
    with torch.cuda.device(nibbles.device):
        rc = _build.load().aukit_ima_decode(nibbles.data_ptr(), st_in.data_ptr(), out.data_ptr(),
                                            st_out.data_ptr(), lanes, T, stream_of(nibbles))
    _build.check(rc, "aukit_ima_decode")
    ima_decode_kernel.launches += 1
    return out, tuple(st_out.unbind(0))


def msadpcm_decode_kernel(nibbles: torch.Tensor, sample1: torch.Tensor, sample2: torch.Tensor,
                          delta: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor):
    """int8[L, T] signed nibbles + int32[L] state and coefficients ->
    (int16[L, T] samples, (sample1, sample2, delta)). The header delta is
    used raw for the first sample. The CUDA kernel ``aukit_msadpcm_decode``
    replaces ``msadpcm_decode_grouped``
    (aukit_tpu/kernels/msadpcm_pallas.py:104)."""
    _check(nibbles, torch.int8, {"sample1": sample1, "sample2": sample2, "delta": delta,
                                 "c1": c1, "c2": c2})
    if nibbles.device.type == "cpu":
        return msadpcm_decode_ref(nibbles, sample1, sample2, delta, c1, c2)
    if not nibbles.is_contiguous():
        raise ValueError("nibbles must be contiguous")
    lanes, T = nibbles.shape
    if lanes == 0 or T == 0:
        return (torch.empty((lanes, T), dtype=torch.int16, device=nibbles.device),
                (sample1, sample2, delta))
    st_in = torch.stack([sample1, sample2, delta])
    coefs = torch.stack([c1, c2])
    out = torch.empty((lanes, T), dtype=torch.int16, device=nibbles.device)
    st_out = torch.empty_like(st_in)
    with torch.cuda.device(nibbles.device):
        rc = _build.load().aukit_msadpcm_decode(
            nibbles.data_ptr(), st_in.data_ptr(), coefs.data_ptr(), out.data_ptr(),
            st_out.data_ptr(), lanes, T, stream_of(nibbles))
    _build.check(rc, "aukit_msadpcm_decode")
    msadpcm_decode_kernel.launches += 1
    return out, tuple(st_out.unbind(0))


ima_decode_kernel.launches = 0
msadpcm_decode_kernel.launches = 0

KERNELS = (ima_decode_kernel, msadpcm_decode_kernel)
PLAIN = (ima_decode_ref, msadpcm_decode_ref)
