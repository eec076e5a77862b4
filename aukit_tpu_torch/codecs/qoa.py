"""QOA (Quite OK Audio) LMS reconstruction in plain PyTorch — counterpart of
``aukit_tpu.codecs.qoa`` for the engine's frame lanes.

QOA frames carry their full LMS state (4 history + 4 weights per channel)
in-band, so every (frame, channel) pair decodes as an independent lane: one
Python step per sample with the lanes vectorised. The loop runs on any
device, but is meant for the CPU and as the plain version the CUDA kernel
(``kernels/qoa_cuda.py``) is held against.

Integer semantics: the reference's ``signed_rshift`` coerces through bit32,
which is int32 wraparound, and the predictor sum may legitimately wrap. The
four products are added one by one as int32 tensors, which wrap; a
``torch.sum`` over int32 would return int64 and not wrap.
"""

from __future__ import annotations

import numpy as np
import torch

# aukit_tpu/codecs/qoa.py:31 (aukit.lua:1662-1679): dequantised residual per
# (scalefactor, 3-bit residual index)
QOA_DEQUANT = np.array(
    [
        [1, -1, 3, -3, 5, -5, 7, -7],
        [5, -5, 18, -18, 32, -32, 49, -49],
        [16, -16, 53, -53, 95, -95, 147, -147],
        [34, -34, 113, -113, 203, -203, 315, -315],
        [63, -63, 210, -210, 378, -378, 588, -588],
        [104, -104, 345, -345, 621, -621, 966, -966],
        [158, -158, 528, -528, 950, -950, 1477, -1477],
        [228, -228, 760, -760, 1368, -1368, 2128, -2128],
        [316, -316, 1053, -1053, 1895, -1895, 2947, -2947],
        [422, -422, 1405, -1405, 2529, -2529, 3934, -3934],
        [548, -548, 1828, -1828, 3290, -3290, 5117, -5117],
        [696, -696, 2320, -2320, 4176, -4176, 6496, -6496],
        [868, -868, 2893, -2893, 5207, -5207, 8099, -8099],
        [1064, -1064, 3548, -3548, 6386, -6386, 9933, -9933],
        [1286, -1286, 4288, -4288, 7718, -7718, 12005, -12005],
        [1536, -1536, 5120, -5120, 9216, -9216, 14336, -14336],
    ],
    dtype=np.int32,
)


def qoa_dequant(sf: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """``QOA_DEQUANT[sf, res]`` as a table lookup on ``res``'s device:
    int scalefactors (0..15) broadcast against int residual indices (0..7)
    -> int16."""
    tbl = torch.tensor(QOA_DEQUANT.reshape(-1), dtype=torch.int16, device=res.device)
    return tbl[(sf.to(torch.int32) * 8 + res.to(torch.int32))]


def qoa_lms_samples(dq: torch.Tensor, history: torch.Tensor, weights: torch.Tensor):
    """The LMS loop: dequantised residuals int[L, T], history and weights
    int32[L, 4] -> (int32[T, L] samples, time-major, (history, weights))."""
    dev = dq.device
    d = dq.t().to(torch.int32)  # [T, L]
    delta = d >> 4
    neg_delta = -delta
    h = list(history.to(torch.int32).t().unbind(0))
    w = list(weights.to(torch.int32).t().unbind(0))
    outs = []
    for t in range(d.shape[0]):
        # int32 products added one by one: each add wraps, as the spec says
        pred = (w[0] * h[0] + w[1] * h[1] + w[2] * h[2] + w[3] * h[3]) >> 13
        recon = (pred + d[t]).clamp(-32768, 32767)
        w = [wi + torch.where(hi < 0, neg_delta[t], delta[t]) for wi, hi in zip(w, h)]
        h = h[1:] + [recon]
        outs.append(recon)
    out = (torch.stack(outs) if outs else
           torch.empty((0, dq.shape[0]), dtype=torch.int32, device=dev))
    return out, (torch.stack(h, dim=1), torch.stack(w, dim=1))
