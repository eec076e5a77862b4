"""Zero-state one-pole lowpass kernel: CUDA C++ for Hopper (``csrc/iir.cu``)
and its plain PyTorch version — counterpart of
``aukit_tpu.kernels.iir_pallas`` (``iir_zero_grouped`` and its wrapper
``iir_zero_lanes``).

``y[t] = a*x[t] + c*y[t-1]`` from ``y[-1] = 0`` along each row of
``float32[R, T]``, with ``a = f32(alpha)`` and ``c = f32(1 - alpha)`` (the
subtraction in float64, as the JAX wrapper computes it). Both versions
round as the JAX kernel does when XLA compiles it: the first sample of
each group of 8 fuses ``c*y`` into the add, the other seven fuse ``a*x``
(csrc/iir.cu says why). A tensor on the CPU goes to the plain version; a
tensor on a CUDA device goes to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from ._wrap import check_rows, stream_of
from .fma_cuda import fma_ref

GROUP = 8  # the JAX kernel's unroll: where the fused multiply-add changes sides


def coefficients(alpha: float) -> tuple[float, float]:
    """(a, c) as float32 values: ``f32(alpha)``, ``f32(1 - alpha)``."""
    return float(np.float32(alpha)), float(np.float32(1.0 - alpha))


def iir_zero_ref(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """The lowpass as a torch loop over time, rows vectorised."""
    iir_zero_ref.calls += 1
    check_rows("x", x, torch.float32)
    a, c = coefficients(alpha)
    out = torch.empty_like(x)
    y = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for t in range(x.shape[1]):
        if t % GROUP == 0:
            y = fma_ref(c, y, x[:, t] * a)
        else:
            y = fma_ref(a, x[:, t], y * c)
        out[:, t] = y
    return out


iir_zero_ref.calls = 0


def iir_zero_kernel(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """float32[R, T] -> float32[R, T] zero-state lowpass along each row. The
    CUDA kernel ``aukit_iir_zero`` replaces ``iir_zero_grouped``
    (aukit_tpu/kernels/iir_pallas.py:62)."""
    check_rows("x", x, torch.float32)
    if x.device.type == "cpu":
        return iir_zero_ref(x, alpha)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    R, T = x.shape
    out = torch.empty_like(x)
    if R == 0 or T == 0:
        return out
    a, c = coefficients(alpha)
    with torch.cuda.device(x.device):
        rc = _build.load().aukit_iir_zero(x.data_ptr(), out.data_ptr(), R, T, a, c,
                                          stream_of(x))
    _build.check(rc, "aukit_iir_zero")
    iir_zero_kernel.launches += 1
    return out


iir_zero_kernel.launches = 0

KERNELS = (iir_zero_kernel,)
PLAIN = (iir_zero_ref,)
