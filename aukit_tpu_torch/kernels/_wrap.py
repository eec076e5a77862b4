"""Argument checks and launch plumbing shared by the kernel wrappers.

A wrapper checks every tensor before it hands a pointer to a kernel: the
kernels trust dtypes, shapes, devices and contiguity and check nothing.
"""

from __future__ import annotations

import torch


def check_rows(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    """A lane-major kernel input: ``dtype[L, T]`` on the CPU or a CUDA device."""
    if t.dtype != dtype or t.dim() != 2:
        raise ValueError(f"{name} must be {dtype}[L, T], got {t.dtype}{list(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def check_lane_vector(name: str, t: torch.Tensor, dtype: torch.dtype, like: torch.Tensor,
                      width: int | None = None) -> None:
    """A per-lane kernel argument: contiguous ``dtype[L]`` (or ``[L, width]``)
    on ``like``'s device, where L is ``like``'s row count."""
    shape = (like.shape[0],) if width is None else (like.shape[0], width)
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != like.device:
        raise ValueError(f"{name} must be {dtype}{list(shape)} on {like.device}, "
                         f"got {t.dtype}{list(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the C entry points take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
