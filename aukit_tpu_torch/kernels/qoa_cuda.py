"""QOA LMS reconstruction kernel: CUDA C++ for Hopper (``csrc/qoa.cu``) and
its plain PyTorch version — counterpart of ``aukit_tpu.kernels.qoa_pallas``.

The wrapper keeps the JAX convenience wrapper's lane-major layout
(``qoa_lms_pallas``): dequantised residuals ``int16[L, T]`` and the LMS
state ``int32[L, 4]`` twice in, ``int16[L, T]`` samples and the final state
out. A tensor on the CPU goes to the plain version; a tensor on a CUDA
device goes to the kernel, or the wrapper raises. ``launches`` and ``calls``
count which one served.
"""

from __future__ import annotations

import torch

from ..codecs.qoa import qoa_lms_samples
from . import _build
from ._wrap import check_lane_vector, check_rows, stream_of


def qoa_lms_ref(dq: torch.Tensor, history: torch.Tensor, weights: torch.Tensor):
    """int16[L, T] residuals, int32[L, 4] history and weights ->
    (int16[L, T] samples, (history, weights)): the loop of ``codecs.qoa``,
    one Python step per sample, int32 wraparound included."""
    qoa_lms_ref.calls += 1
    out, state = qoa_lms_samples(dq, history, weights)
    return out.t().to(torch.int16).contiguous(), state


qoa_lms_ref.calls = 0


def qoa_lms_kernel(dq: torch.Tensor, history: torch.Tensor, weights: torch.Tensor):
    """int16[L, T] residuals + int32[L, 4] history and weights ->
    (int16[L, T] samples, (history, weights)). The CUDA kernel
    ``aukit_qoa_lms`` replaces ``qoa_lms_grouped``
    (aukit_tpu/kernels/qoa_pallas.py:105)."""
    check_rows("dq", dq, torch.int16)
    check_lane_vector("history", history, torch.int32, dq, width=4)
    check_lane_vector("weights", weights, torch.int32, dq, width=4)
    if dq.device.type == "cpu":
        return qoa_lms_ref(dq, history, weights)
    if not dq.is_contiguous():
        raise ValueError("dq must be contiguous")
    lanes, T = dq.shape
    if lanes == 0 or T == 0:
        return torch.empty((lanes, T), dtype=torch.int16, device=dq.device), (history, weights)
    st_in = torch.cat([history.t(), weights.t()]).contiguous()  # int32[8, L]
    out = torch.empty((lanes, T), dtype=torch.int16, device=dq.device)
    st_out = torch.empty_like(st_in)
    with torch.cuda.device(dq.device):
        rc = _build.load().aukit_qoa_lms(dq.data_ptr(), st_in.data_ptr(), out.data_ptr(),
                                         st_out.data_ptr(), lanes, T, stream_of(dq))
    _build.check(rc, "aukit_qoa_lms")
    qoa_lms_kernel.launches += 1
    return out, (st_out[:4].t().contiguous(), st_out[4:].t().contiguous())


qoa_lms_kernel.launches = 0

KERNELS = (qoa_lms_kernel,)
PLAIN = (qoa_lms_ref,)
