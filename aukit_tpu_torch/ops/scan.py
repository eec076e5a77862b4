"""The one-pole filter recurrence of the engine's DSP stage as the combine
tree of ``jax.lax.associative_scan`` — counterpart of the scan in
``aukit_tpu/stream/batch.py``'s ``with_dsp`` step.

The recurrence ``y[t] = A[t] * y[t-1] + B[t]`` composes pairs ``(A, B)`` with
``(p, q) -> (p.A * q.A, q.A * p.B + q.B)``. ``associative_scan`` evaluates it
as a fixed tree: combine adjacent pairs, scan the half-length result by
recursion (the odd outputs), combine each odd output with the next even input
(the even outputs), interleave. Float addition does not associate, so the
tree fixes the rounding; a sequential loop rounds differently (up to 1.2e-7
on filtered audio). Each ``q.A * p.B + q.B`` is one ``fma_kernel`` call,
rounded once, as XLA contracts it on most elements.

Only ``B`` of the scan is needed: the even combine reads the caller's own
``A`` and the odd ``B``, so the scanned ``A`` is never built.
"""

from __future__ import annotations

import torch

from ..kernels.fma_cuda import fma_kernel


def linear_scan(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """float32 ``y`` with ``y[..., 0] = B[..., 0]`` and ``y[..., t] =
    A[..., t] * y[..., t-1] + B[..., t]``, by ``associative_scan``'s tree
    over the last axis. ``A`` and ``B`` share one shape; ``A`` may be a
    broadcast view (stride 0 over the last axis), and is then never
    materialised."""
    n = B.shape[-1]
    if n < 2:
        return B
    a1 = A[..., 1::2]
    if A.stride(-1) == 0:  # one A a row, broadcast: so are the pair products
        pa = (A[..., :1] * A[..., :1]).expand(a1.shape)
    else:
        pa = A[..., 0:-1:2] * a1
    # pairs (2i, 2i+1): A = A[2i] * A[2i+1], B = A[2i+1] * B[2i] + B[2i+1]
    odd = linear_scan(pa, fma_kernel(a1, B[..., 0:-1:2], B[..., 1::2]))
    # even outputs 2i+2 = combine(odd output 2i+1, input 2i+2)
    prev = odd if n % 2 else odd[..., :-1]
    even = fma_kernel(A[..., 2::2], prev, B[..., 2::2])
    y = torch.empty_like(B)
    y[..., :1] = B[..., :1]
    y[..., 2::2] = even
    y[..., 1::2] = odd
    return y
