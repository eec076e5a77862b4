"""Global configuration — counterpart of ``aukit_tpu.config``: the settings
the batched DFPWM engine reads (reference switches aukit.lua:96-99
``defaultInterpolation`` and aukit.lua:129 ``sincWindowSize``, and the 48 kHz
speaker output rate), and the device check every entry point makes."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Config:
    # interpolation used by every resampling site when none is given
    default_interpolation: str = "linear"
    # half-width of the windowed-sinc interpolator (the high-quality setting)
    sinc_window_size: int = 30
    # output sample rate of the streaming pipeline
    output_rate: int = 48000


CONFIG = Config()


def get_interpolation(mode: str | None) -> str:
    mode = mode or CONFIG.default_interpolation
    if mode not in ("none", "linear", "cubic", "sinc"):
        raise ValueError(f"invalid interpolation type {mode!r}")
    return mode


def require_device(device, who: str) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and no CUDA
    device is present (no entry point carries on on the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}(device='cuda'): no CUDA device is available; "
                           "pass device='cpu' for the plain PyTorch path")
    return device
