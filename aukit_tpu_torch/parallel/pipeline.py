"""Batched decode + DSP pipeline — counterpart of ``aukit_tpu.parallel.pipeline``.

``dsp_chain`` turns a float block at the lane's rate into 48 kHz int8:
resample (static gather tables) -> FIR smoothing -> optional volume ramp ->
int8 scale/clamp, as torch ops on whatever device the block lives on. The
float steps run in the order of the JAX package's jitted step, and every
multiply that XLA fuses into the add it feeds (the FIR, the volume ramp, the
interpolators) is one ``fma_kernel`` call, so the int8 output agrees with the
JAX engine's bit for bit.

Multi-device (``make_mesh``, ``sharded_pipeline_step``): lanes split into
shards (``parallel/mesh.py``), each decoded by kernel (a) on its own device;
the only cross-shard operation is the optional batch peak of the normalize,
one max over the shards' peaks on the mesh's first device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..codecs.dfpwm import DfpwmState, norm8
from ..config import CONFIG
from ..kernels.dfpwm_cuda import dfpwm_decode_kernel
from ..kernels.fma_cuda import fma_kernel
from ..ops.resample import block_interp_device, sinc_weights
from .mesh import Mesh, check_mesh, make_mesh, shard_bounds

__all__ = ["Mesh", "decode_pipeline_pallas", "decode_pipeline_scan", "dsp_chain", "fir_alpha",
           "make_mesh", "sharded_pipeline_step"]


@functools.lru_cache(maxsize=64)
def _resample_tables(n_in: int, in_rate: int, out_rate: int):
    """Static linear-interp gather tables for one block: (n_out, idx0, frac)."""
    n_out = (n_in * out_rate) // in_rate
    i = np.arange(n_out, dtype=np.int64)
    num = i * in_rate
    ffx = num // out_rate
    frac = (num - ffx * out_rate).astype(np.float32) / out_rate
    return n_out, ffx.astype(np.int32), frac


def fir_alpha(in_rate: int, out_rate: int) -> float:
    """The chunk-DSP smoothing constant (aukit.lua:2365 ``lp_alpha``), shared
    by ``dsp_chain`` and the fused decode+DSP kernel: bit parity between the
    engine's fused and two-stage routes depends on both reading this value."""
    return float(1.0 - np.exp(-(in_rate / (out_rate * 2)) * 2.0 * np.pi))


def _f32(x: float) -> float:
    """``x`` rounded to float32: a Python scalar torch multiplies in float32
    exactly as JAX multiplies its float32 constant."""
    return float(np.float32(x))


def dsp_chain(samples_f32: torch.Tensor, in_rate: int, out_rate: int = 48000,
              fir_state: torch.Tensor | None = None, mode: str = "linear", gain=None):
    """float[..., T] @in_rate -> int8[..., T_out] @out_rate: resample
    (none/linear/cubic/sinc) + FIR smoothing (alpha per aukit.lua:2365) +
    int8 scale/clamp.

    ``fir_state``: optional float[...] previous raw sample carried across
    chunks; when given, returns (out, new_fir_state).

    ``gain``: optional (gain0, slope_per_sample), each float[...]: the
    smoothed stream is scaled by ``gain0 + slope * t`` before the int8
    quantize; gain 1 / slope 0 multiplies by exactly 1.0.

    The interpolation window clamps at each chunk's edges (the JAX package's
    fixed-shape simplification; exact for identity rates)."""
    if mode not in ("none", "linear", "cubic", "sinc"):
        raise ValueError(f"invalid interpolation mode {mode!r}")
    n_in = samples_f32.shape[-1]
    if in_rate == out_rate:
        s = samples_f32  # identity: every mode passes p1 through at exact x
    else:
        _, ffx, frac = _resample_tables(n_in, in_rate, out_rate)
        w = None
        if mode == "sinc":
            w = sinc_weights(frac.astype(np.float64), CONFIG.sinc_window_size)
        s = block_interp_device(samples_f32, n_in, 0, ffx.astype(np.int64), frac,
                                frac == 0.0, mode, w)
    alpha = _f32(fir_alpha(in_rate, out_rate))
    first = torch.zeros_like(s[..., :1]) if fir_state is None else fir_state[..., None]
    prev = torch.cat([first, s[..., :-1]], dim=-1)
    out = fma_kernel(alpha, s - prev, prev)
    if gain is not None:
        g0, gslope = gain
        t = torch.arange(out.shape[-1], dtype=torch.float32, device=out.device)
        out = out * fma_kernel(gslope[..., None], t, g0[..., None])
    out = out * torch.where(out < 0, 128.0, 127.0)
    out = out.clamp(-128.0, 127.0).to(torch.int8)
    if fir_state is None:
        return out
    return out, s[..., -1]


def decode_pipeline_scan(bytes_u8: torch.Tensor, state: DfpwmState, in_rate: int = 48000,
                         normalize_peak: float | None = None):
    """Flagship step: uint8[L, B] -> (int8[L, T_out], new_state). The decode
    runs through ``dfpwm_decode_kernel`` (the CUDA kernel for a CUDA tensor,
    its plain version on the CPU). With ``normalize_peak`` set, the batch is
    rescaled by one peak taken over every lane."""
    decoded, state = dfpwm_decode_kernel(bytes_u8, state)
    f = norm8(decoded)
    if normalize_peak is not None:
        f = f * _peak_scale(f.abs().max(), normalize_peak)
    return dsp_chain(f, in_rate), state


def _peak_scale(peak: torch.Tensor, normalize_peak: float) -> torch.Tensor:
    """The normalize multiplier of a batch peak |x| (a 0-d float32 tensor)."""
    peak = peak.clamp_min(_f32(1e-6))
    # a true division: Python-scalar / tensor multiplies by a reciprocal
    return torch.full_like(peak, normalize_peak) / peak


def decode_pipeline_pallas(bytes_u8: torch.Tensor, state: DfpwmState, in_rate: int = 48000):
    """The flagship step through kernel (a): uint8[L, B] ->
    (int8[L, T_out], new_state). The JAX function takes the TPU kernel's
    grouped layout (``uint8[G, B, 32, 128]`` bytes, ``int32[G, 5, 32, 128]``
    state, ``int8[G, T_out, 32, 128]`` out, time on axis 1); the GPU layout
    is lane-major, so this twin takes and returns rows of lanes and a
    ``DfpwmState``, and equals ``decode_pipeline_scan`` without its
    normalize."""
    decoded, state = dfpwm_decode_kernel(bytes_u8, state)
    return dsp_chain(norm8(decoded), in_rate), state


def shard_pipeline_fn(in_rate: int = 48000, normalize_peak: float | None = 0.9,
                      reduce_peak=None):
    """The sharded flagship step: ``fn(bytes, charge, strength, prev_bit,
    prev_charge, lowpass)``, each argument a list of one tensor per shard
    (lane rows on the shard's device), returns ``(out, charge, strength,
    prev_bit, prev_charge, lowpass)`` in the same form. Every shard decodes
    its rows by kernel (a); the batch peak is one max over the shards'
    peaks on the first shard's device, passed through ``reduce_peak`` (the
    all-reduce of a multi-process group) when given; the DSP runs on each
    shard. Bit-equal to ``decode_pipeline_scan`` over the rows in order."""
    def step(bytes_u8, *leaves):
        decoded = [dfpwm_decode_kernel(b, DfpwmState(*st))
                   for b, *st in zip(bytes_u8, *leaves)]
        f = [norm8(d) for d, _st in decoded]
        if normalize_peak is not None:
            first = f[0].device
            peak = torch.stack([x.abs().max().to(first) for x in f]).max()
            if reduce_peak is not None:
                peak = reduce_peak(peak)
            scale = _peak_scale(peak, normalize_peak)
            f = [x * scale.to(x.device) for x in f]
        out = [dsp_chain(x, in_rate) for x in f]
        states = [st.leaves() for _d, st in decoded]
        return (out, *(list(leaf) for leaf in zip(*states)))

    return step


def place_rows(mesh: Mesh, rows) -> list[torch.Tensor]:
    """``rows`` (numpy or torch, a multiple of the mesh's shards long) as one
    tensor of contiguous rows a shard, each on its shard's device."""
    bounds = shard_bounds(rows.shape[0], mesh.size)
    return [torch.as_tensor(rows[lo:hi]).to(dev).contiguous()
            for dev, (lo, hi) in zip(mesh.devices.flat, bounds)]


def sharded_pipeline_step(mesh: Mesh, lanes: int, nbytes: int, in_rate: int = 48000):
    """The flagship step with lanes sharded over the whole mesh, DSP local,
    the peak-normalize's max the one cross-shard operation. Returns (fn,
    args) as the JAX package does: ``fn(*args)`` runs one step (see
    ``shard_pipeline_fn``); ``args`` are ``default_rng(0)`` bytes
    uint8[lanes, nbytes] and zero states, placed as shards. ``lanes`` must
    split evenly over the mesh."""
    mesh = check_mesh(mesh, "sharded_pipeline_step")
    if lanes % mesh.size:
        raise ValueError(f"{lanes} lanes do not split over the {mesh.size}-shard mesh")
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (lanes, nbytes), dtype=np.uint8)
    z = np.zeros(lanes, np.int32)
    args = (place_rows(mesh, data),) + tuple(place_rows(mesh, z) for _ in range(5))
    return shard_pipeline_fn(in_rate, 0.9), args
