"""IMA ADPCM and Microsoft ADPCM decode loops in plain PyTorch — counterpart of
``aukit_tpu.codecs.adpcm`` for the engine's block lanes.

Both formats carry their full predictor state in every block header (WAV
layout), so a chunk of K blocks decodes as K independent lanes: one Python
step per sample with the lanes vectorised, like ``codecs/dfpwm.py``. They run
on any device, but are meant for the CPU and as the plain versions the CUDA
kernels (``kernels/adpcm_cuda.py``) are held against.

Integer semantics are those of the Pallas kernels (``ima_pallas.py``,
``msadpcm_pallas.py``), which equal ``ima_adpcm_scan`` and ``msadpcm_scan``
on every input a valid stream gives:

 - IMA: the step-table lookup clamps the index to [0, 88] while the raw
   index feeds the index update for that one step; the index delta has the
   closed form ``m < 4 ? -1 : (m - 3) * 2`` with ``m = nib & 7``.
 - MS: the header delta is used raw for the first sample, even when
   negative; the >= 16 floor applies from the first update. The adaption
   table is evaluated arithmetically (``_adapt``), which equals
   ``MSADPCM_ADAPTION[nib + 8]`` for nibbles in [-8, 7].

All state and arithmetic is int32; elementwise torch ops wrap like JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

# aukit_tpu/codecs/adpcm.py:28-56 (reference tables, aukit.lua:158-191)
IMA_INDEX_TABLE = np.array(
    [-1, -1, -1, -1, 2, 4, 6, 8, -1, -1, -1, -1, 2, 4, 6, 8], dtype=np.int32
)
IMA_STEP_TABLE = np.array(
    [7, 8, 9, 10, 11, 12, 13, 14, 16, 17,
     19, 21, 23, 25, 28, 31, 34, 37, 41, 45,
     50, 55, 60, 66, 73, 80, 88, 97, 107, 118,
     130, 143, 157, 173, 190, 209, 230, 253, 279, 307,
     337, 371, 408, 449, 494, 544, 598, 658, 724, 796,
     876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
     2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358,
     5894, 6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899,
     15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767],
    dtype=np.int32,
)

# MS ADPCM adaption table indexed by signed nibble -8..7
MSADPCM_ADAPTION = np.array(
    [768, 614, 512, 409, 307, 230, 230, 230,  # nibbles -8..-1
     230, 230, 230, 230, 307, 409, 512, 614],  # nibbles 0..7
    dtype=np.int32,
)

MSADPCM_DEFAULT_COEFFS = (
    np.array([256, 512, 0, 192, 240, 460, 392], dtype=np.int32),
    np.array([0, -256, 0, 64, 0, -208, -232], dtype=np.int32),
)

_DELTA_CAP = 1 << 20  # defensive overflow bound (aukit_tpu/codecs/adpcm.py:13-18)


def ima_decode_samples(nibbles: torch.Tensor, predictor: torch.Tensor,
                       step_index: torch.Tensor):
    """The IMA decode loop: nibbles int[L, T] (0..15), predictor and
    step_index int32[L] -> (int32[T, L] predictors, time-major,
    (predictor, step_index))."""
    dev = nibbles.device
    nib = nibbles.t().to(torch.int32)  # [T, L]
    m = nib & 7
    idx_delta = torch.where(m < 4, -1, (m - 3) * 2).to(torch.int32)
    negative = nib >= 8
    tbl = torch.tensor(IMA_STEP_TABLE, device=dev)
    pred, sidx = predictor.to(torch.int32), step_index.to(torch.int32)
    outs = []
    for t in range(nib.shape[0]):
        step = tbl[sidx.clamp(0, 88)]
        sidx = (sidx + idx_delta[t]).clamp(0, 88)
        diff = ((m[t] * step) >> 2) + (step >> 3)
        pred = torch.where(negative[t], pred - diff, pred + diff).clamp(-32768, 32767)
        outs.append(pred)
    out = (torch.stack(outs) if outs else
           torch.empty((0, nibbles.shape[0]), dtype=torch.int32, device=dev))
    return out, (pred, sidx)


def _adapt(nib: torch.Tensor) -> torch.Tensor:
    """MSADPCM_ADAPTION[nib + 8] as cumulative threshold adds on |nib|
    (the Pallas kernel's form, msadpcm_pallas.py:39-45)."""
    m = nib.abs()
    a = 230 + 77 * (m >= 4) + 102 * (m >= 5) + 103 * (m >= 6) + 102 * (m >= 7)
    return (a + 154 * (nib == -8)).to(torch.int32)


def msadpcm_decode_samples(nibbles: torch.Tensor, sample1: torch.Tensor,
                           sample2: torch.Tensor, delta: torch.Tensor,
                           c1: torch.Tensor, c2: torch.Tensor):
    """The MS ADPCM decode loop: signed nibbles int[L, T] (-8..7), per-lane
    state and coefficients int32[L] -> (int32[T, L] samples, time-major,
    excluding the two header samples; (sample1, sample2, delta))."""
    dev = nibbles.device
    nib = nibbles.t().to(torch.int32)  # [T, L]
    adapt = _adapt(nib)
    s1, s2, d = sample1.to(torch.int32), sample2.to(torch.int32), delta.to(torch.int32)
    c1, c2 = c1.to(torch.int32), c2.to(torch.int32)
    outs = []
    for t in range(nib.shape[0]):
        lin = (s1 * c1 + s2 * c2) >> 8  # floor((s1*c1 + s2*c2) / 256)
        pred = (lin + nib[t] * d).clamp(-32768, 32767)
        d = ((adapt[t] * d) >> 8).clamp(16, _DELTA_CAP)
        s1, s2 = pred, s1
        outs.append(pred)
    out = (torch.stack(outs) if outs else
           torch.empty((0, nibbles.shape[0]), dtype=torch.int32, device=dev))
    return out, (s1, s2, d)
