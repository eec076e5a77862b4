"""Global configuration — counterpart of ``aukit_tpu.config``: the settings
the engines and stream iterators read (reference switches aukit.lua:96-99
``defaultInterpolation`` and aukit.lua:129 ``sincWindowSize``, the 48 kHz
speaker output rate and chunk, the quirk switch), and the device check every
entry point makes."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Config:
    # interpolation used by every resampling site when none is given
    default_interpolation: str = "linear"
    # half-width of the windowed-sinc interpolator (the high-quality setting)
    sinc_window_size: int = 30
    # output samples per channel per stream chunk (one second at 48 kHz,
    # aukit.lua:2395)
    chunk_samples: int = 48000
    # output sample rate of the streaming pipeline
    output_rate: int = 48000
    # replicate the reference's stream-path quirks (Q9: the per-chunk lowpass
    # re-seed; Q28: a malformed IMA step index errors the stream); False
    # keeps the fixed semantics, as in the JAX package
    compat_quirks: bool = False
    # the least restore batch (subframes x largest block) that
    # ``codecs.flac.restore_flat(device=None)`` sends to kernel (g) when its
    # rows are to land on a CUDA device: the default route of
    # ``FlacFleet(device_restore=None)``, of ``Fleet`` and of ``austream
    # --fleet``. A smaller batch, and any batch bound for the CPU, takes the
    # native host restore. The default, the JAX package's, keeps every such
    # batch on the host; 0 sends every batch of depth <= 24 to the card.
    flac_device_restore_min: int = 1 << 62


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
