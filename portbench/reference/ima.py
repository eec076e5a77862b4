"""Plain IMA ADPCM decoder of mono WAV blocks, NumPy only, with the rules the
system states for its IMA lanes (aukit's ``adpcm`` decoder, which the JAX
package and the port follow): each block starts with a 4-byte header, the
16-bit little-endian predictor and a step index of which only the low four
bits count; then each byte gives two samples, low nibble first; a nibble's
magnitude ``m`` moves the predictor by ``(m * step >> 2) + (step >> 3)`` and
the step index by the standard table; the header's predictor itself is not
output. The blocks are independent, so they decode side by side.
"""

from __future__ import annotations

import numpy as np

STEPS = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37, 41, 45, 50, 55, 60,
    66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173, 190, 209, 230, 253, 279, 307, 337, 371,
    408, 449, 494, 544, 598, 658, 724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878,
    2066, 2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484, 7132, 7845,
    8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818, 18500, 20350, 22385, 24623, 27086,
    29794, 32767], np.int64)
INDEX_MOVE = np.array([-1, -1, -1, -1, 2, 4, 6, 8], np.int64)


def decode_blocks(blocks: np.ndarray, dtype=np.int32) -> np.ndarray:
    """uint8[B, block_align] mono blocks -> [B, (block_align - 4) * 2]
    samples, the arithmetic in ``dtype`` (int32 holds it; the benchmark's
    control passes int16, the precision below)."""
    b = blocks.astype(np.int64)
    pred = b[:, 0] | (b[:, 1] << 8)
    pred = np.where(pred >= 32768, pred - 65536, pred)
    index = b[:, 2] & 0x0F
    body = b[:, 4:]
    nib = np.stack([body & 0x0F, body >> 4], axis=-1).reshape(len(b), -1).astype(dtype)
    steps, moves = STEPS.astype(dtype), INDEX_MOVE.astype(dtype)
    pred, index = pred.astype(dtype), index.astype(dtype)
    lo, hi = dtype(-32768), dtype(32767)
    out = np.empty(nib.shape, np.int64)
    with np.errstate(over="ignore"):
        for t in range(nib.shape[1]):
            step = steps[index]
            m = nib[:, t] & 7
            index = np.clip(index + moves[m], 0, 88).astype(dtype)
            diff = ((m * step) >> 2) + (step >> 3)
            pred = np.clip(np.where(nib[:, t] >= 8, pred - diff, pred + diff), lo, hi).astype(dtype)
            out[:, t] = pred
    return out
