"""The plain reference of a radio station's output, one kind at a time: what
a chunk of DFPWM or IMA ADPCM, or the first seconds of a FLAC track, should
become at 48 kHz int8, as the system states its lane DSP.

- DFPWM at 48 kHz: the decoded samples normalised, then the two-tap
  smoothing from the previous decoded sample, int8.
- IMA ADPCM at 16 kHz: each block decoded, normalised by 32768 below zero and
  32767 above, resampled linearly to 48 kHz within the chunk, smoothed from
  the previous chunk's last resampled sample, int8.
- FLAC: each sample over 2**depth, the one-pole lowpass
  ``y += alpha * (x - y)`` from zero at the track's start (alpha the
  smoothing constant at 48 kHz), scaled by 128 below zero and 127 above,
  clipped, rounded to float32, then clamped and truncated to int8 where the
  Fleet merges it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dfpwm as ref_dfpwm
from . import dsp, ima
from . import flac as ref_flac


def dfpwm_chunks(data: torch.Tensor, state: torch.Tensor, prev0: torch.Tensor,
                 dtype=torch.int32, fdtype=torch.float32):
    """uint8[N, 6000] chunks at 48 kHz -> (int8[N, 48000], state after,
    the last sample before smoothing)."""
    raw, st = ref_dfpwm.decode(data, state, dtype)
    f = dsp.norm8(raw, fdtype)
    return dsp.smooth_int8(f, prev0, dsp.smoothing_alpha(48000), fdtype), st, f[:, -1]


def ima_chunks(blocks: np.ndarray, per_chunk: int, rate: int, device, fdtype=torch.float32,
               idtype=np.int32):
    """uint8[N * per_chunk, block] blocks, ``per_chunk`` consecutive blocks a
    chunk, in each lane's order -> (f32 resampled chunks [N, out]); the
    caller smooths them in order."""
    dec = ima.decode_blocks(blocks, idtype).reshape(-1, per_chunk * (blocks.shape[1] - 4) * 2)
    f = dsp.norm16(torch.from_numpy(dec).to(device), fdtype)
    return dsp.resample_linear(f, rate, 48000, fdtype)


def flac_output(stream: bytes, offsets: np.ndarray, frames: int, fdtype=np.float64) -> np.ndarray:
    """int8 output of the first ``frames`` frames of a FLAC station's stream
    (``offsets``: each frame's start, then the end of the last)."""
    rate, _ch, depth, _total, _ = ref_flac.streaminfo(stream)
    x = ref_flac.decode_frames([(stream, offsets[: frames + 1])])[0].reshape(-1)
    return flac_dsp(x, depth, rate, fdtype)


def flac_dsp(x: np.ndarray, depth: int, rate: int, fdtype=np.float64, taps: int = 24):
    """The lowpass, scale and int8 of a FLAC station's decoded samples. The
    lowpass keeps ``(1 - alpha)**k`` of a sample after k more: at 48 kHz
    ``1 - alpha = exp(-pi)``, so after 24 samples less than 1e-32 of it is
    left, and summing the 24 latest terms gives the recursion in float64."""
    alpha = 1.0 - np.exp(-(rate / (48000 * 2)) * 2.0 * np.pi)
    v = x.astype(fdtype) / fdtype(1 << depth)
    c = fdtype(1.0 - alpha)
    w = (fdtype(alpha) * c ** np.arange(taps, dtype=fdtype)).astype(fdtype)
    y = np.convolve(v, w)[: len(v)].astype(fdtype)
    scaled = np.clip(y * np.where(y < 0, fdtype(128.0), fdtype(127.0)), -128, 127)
    return np.trunc(np.clip(scaled.astype(np.float32), -128.0, 127.0)).astype(np.int8)
