"""Audio generators: silence, tones, white noise — counterpart of
``aukit_tpu.ops.generate``.

Reference: wavegen closed forms (aukit.lua:286-299) and the constructors
aukit.new / aukit.tone / aukit.noise (aukit.lua:1784/1808/1837). Sample k
(1-based) is evaluated at x = k / sample_rate; lengths are
floor(duration * sample_rate). Waveforms are computed in float64 numpy on the
host, exactly as the JAX package does (so the float32 samples are bit-equal),
then placed on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..audio import Audio
from ..config import require_device

WAVE_TYPES = ("sine", "triangle", "square", "sawtooth")


def _xs(duration: float, sample_rate: int) -> np.ndarray:
    n = int(np.floor(duration * sample_rate))
    return np.arange(1, n + 1, dtype=np.float64) / sample_rate


def _on(data: np.ndarray, sample_rate: int, device, who: str) -> Audio:
    device = require_device(device, who)
    return Audio(torch.from_numpy(data).to(device), sample_rate, {}, {})


def silence(duration: float, channels: int = 1, sample_rate: int = 48000,
            device="cuda") -> Audio:
    """reference aukit.new (aukit.lua:1784)."""
    n = int(np.floor(duration * sample_rate))
    return _on(np.zeros((channels, n), np.float32), sample_rate, device, "silence")


def tone(
    frequency: float,
    duration: float,
    amplitude: float = 1.0,
    wave_type: str = "sine",
    duty: float = 0.5,
    channels: int = 1,
    sample_rate: int = 48000,
    device="cuda",
) -> Audio:
    """reference aukit.tone (aukit.lua:1808)."""
    if wave_type not in WAVE_TYPES:
        raise ValueError(f"invalid wave type {wave_type!r}")
    if not (0.0 <= amplitude <= 1.0):
        raise ValueError("amplitude out of range [0, 1]")
    if not (0.0 <= duty <= 1.0):
        raise ValueError("duty out of range [0, 1]")
    x = _xs(duration, sample_rate)
    f, a = float(frequency), float(amplitude)
    if wave_type == "sine":
        line = np.sin(2.0 * x * np.pi * f) * a
    elif wave_type == "triangle":
        line = 2.0 * np.abs(a * np.fmod(2.0 * x * f + 1.5, 2.0) - a) - a
    elif wave_type == "square":
        line = np.where(np.mod(x * f, 1.0) >= duty, -a, a)
    else:  # sawtooth
        line = a * np.fmod(2.0 * x * f + 1.0, 2.0) - a
    data = np.broadcast_to(line.astype(np.float32), (channels, len(line))).copy()
    return _on(data, sample_rate, device, "tone")


def noise(
    duration: float,
    amplitude: float = 1.0,
    channels: int = 1,
    sample_rate: int = 48000,
    seed: int | None = None,
    device="cuda",
) -> Audio:
    """reference aukit.noise (aukit.lua:1837); ``seed`` seeds the explicit
    generator ``np.random.default_rng(seed)`` (the reference uses
    math.random), so a seed gives the JAX package's samples."""
    if not (0.0 <= amplitude <= 1.0):
        raise ValueError("amplitude out of range [0, 1]")
    n = int(np.floor(duration * sample_rate))
    rng = np.random.default_rng(seed)
    data = ((rng.random((channels, n)) * 2.0 - 1.0) * amplitude).astype(np.float32)
    return _on(data, sample_rate, device, "noise")
