"""Float32 fused multiply-add: a CUDA kernel (``csrc/fma.cu``) and its plain
PyTorch version.

The JAX package's engine step is one jitted computation, and XLA compiles
every float multiply that feeds an add into a fused multiply-add, rounded
once. torch rounds a multiply and an add separately, which moves about one
resampled or smoothed sample in four by one ulp and, rarely, an int8 output
by one. ``dsp_chain`` and the resampler call ``fma_kernel`` where XLA fuses,
so the port's windows equal the JAX engine's bit for bit.

``fma_ref`` computes the correctly rounded result on any device in float64:
the product of two float32 values is exact there; the sum is rounded to odd
(TwoSum gives its exact error, and an inexact sum with an even last bit
steps one ulp toward the error), and rounding that to float32 is then
correct (53 >= 24 + 2 bits). A tensor on the CPU goes to it; a tensor on a
CUDA device goes to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _build
from ._wrap import stream_of

_CHUNK = 1 << 22  # elements per float64 pass of fma_ref: bounds its memory


def _operands(x, y, z):
    """Tensors and Python floats -> float32 tensors on one device, expanded
    to their broadcast shape."""
    dev = next(a.device for a in (x, y, z) if isinstance(a, torch.Tensor))
    ts = []
    for a in (x, y, z):
        if isinstance(a, torch.Tensor):
            if a.dtype != torch.float32:
                raise ValueError(f"fma operands must be float32, got {a.dtype}")
            if a.device != dev:
                raise ValueError(f"fma operands on {a.device} and {dev}")
            ts.append(a)
        else:  # a Python scalar is a float32 constant, as in the JAX package
            ts.append(torch.tensor(float(np.float32(a)), dtype=torch.float32, device=dev))
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    return [t.expand(shape) for t in ts], shape, dev


def _fma64(x, y, z) -> torch.Tensor:
    x, y, z = x.to(torch.float64), y.to(torch.float64), z.to(torch.float64)
    p = x * y  # exact
    s = p + z
    bp = s - p
    err = (p - (s - bp)) + (z - bp)  # TwoSum: s + err == p + z exactly
    bits = s.view(torch.int64)
    to_odd = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)  # one ulp toward err
    return (bits + to_odd * step).view(torch.float64).to(torch.float32)


def fma_ref(x, y, z) -> torch.Tensor:
    """float32 ``x * y + z`` rounded once, broadcast; float32 tensors or
    Python floats. Rows of the output are computed a chunk at a time."""
    fma_ref.calls += 1
    (x, y, z), shape, dev = _operands(x, y, z)
    if len(shape) == 0:
        return _fma64(x, y, z)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    rows = max(1, _CHUNK // max(1, math.prod(shape[1:])))
    for r in range(0, shape[0], rows):
        out[r: r + rows] = _fma64(x[r: r + rows], y[r: r + rows], z[r: r + rows])
    return out


fma_ref.calls = 0


def fma_kernel(x, y, z) -> torch.Tensor:
    """float32 ``x * y + z`` rounded once, broadcast: the CUDA kernel
    ``aukit_fma`` for CUDA tensors, ``fma_ref`` for CPU tensors."""
    (xe, ye, ze), shape, dev = _operands(x, y, z)
    if dev.type == "cpu":
        return fma_ref(x, y, z)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    cols = shape[-1] if len(shape) else 1
    rows = math.prod(shape[:-1]) if len(shape) else 1
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    # 2-D views keep the broadcast (zero) strides where the leading dims merge
    ops = [t.reshape(rows, cols) for t in (xe, ye, ze)]
    args = []
    for t in ops:
        args += [t.data_ptr(), t.stride(0), t.stride(1)]
    with torch.cuda.device(dev):
        rc = _build.load().aukit_fma(*args, out.data_ptr(), rows, cols, stream_of(out))
    _build.check(rc, "aukit_fma")
    fma_kernel.launches += 1
    return out


fma_kernel.launches = 0

KERNELS = (fma_kernel,)
PLAIN = (fma_ref,)
