"""Raw PCM value conversion — the parts of ``aukit_tpu.ops.pcmcode`` that the
write path uses, copied unchanged (numpy on the host, float64 like the
reference's Lua doubles; aukit.lua:868-874, 1082-1088, 1861).

 - signed normalise   : s / (s < 0 ? 2^(b-1) : 2^(b-1)-1)
 - unsigned normalise : (s - 128) / (s < 128 ? 2^(b-1) : 2^(b-1)-1), the
   128 bias and pivot at every depth (the reference's hardcoded value)
 - encode             : d * (d < 0 ? 2^(b-1) : 2^(b-1)-1) + (unsigned ? 2^(b-1) : 0),
   neither rounded nor clamped
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    (8, "signed"): "i1",
    (8, "unsigned"): "u1",
    (16, "signed"): "i2",
    (16, "unsigned"): "u2",
    (32, "signed"): "i4",
    (32, "unsigned"): "u4",
    (32, "float"): "f4",
}


def pack_pcm(values: np.ndarray, bit_depth: int, data_type: str, big_endian: bool = False) -> bytes:
    """Sample values -> bytes (reference aukit.pack, aukit.lua:1861).
    Non-integer values are truncated toward zero."""
    order = ">" if big_endian else "<"
    values = np.asarray(values)
    if data_type == "float":
        return np.ascontiguousarray(values.astype(np.dtype(order + "f4"))).tobytes()
    ints = np.trunc(values).astype(np.int64)
    if bit_depth == 24:
        if data_type == "signed":
            ints = np.where(ints < 0, ints + (1 << 24), ints)
        b = np.empty((len(ints), 3), dtype=np.uint8)
        lo, mid, hi = ints & 0xFF, (ints >> 8) & 0xFF, (ints >> 16) & 0xFF
        if big_endian:
            b[:, 0], b[:, 1], b[:, 2] = hi, mid, lo
        else:
            b[:, 0], b[:, 1], b[:, 2] = lo, mid, hi
        return b.tobytes()
    dt = _DTYPES[(bit_depth, data_type)]
    return np.ascontiguousarray(ints.astype(np.dtype(order + dt))).tobytes()


def normalize_pcm(vals: np.ndarray, bit_depth: int, data_type: str) -> np.ndarray:
    """Raw sample values -> float32 in [-1, 1] per the reference's rules."""
    if data_type == "float":
        return np.asarray(vals, dtype=np.float32)
    v = np.asarray(vals, dtype=np.float64)
    max_value = float(1 << (bit_depth - 1))
    if data_type == "signed":
        out = v / np.where(v < 0, max_value, max_value - 1)
    else:  # unsigned: pivot and bias fixed at 128
        out = (v - 128.0) / np.where(v < 128, max_value, max_value - 1)
    return out.astype(np.float32)


def denormalize_pcm(d: np.ndarray, bit_depth: int, data_type: str) -> np.ndarray:
    """float samples -> raw (unrounded) sample values, reference encodePCM
    (aukit.lua:868-874)."""
    if data_type == "float":
        return np.asarray(d, dtype=np.float32)
    v = np.asarray(d, dtype=np.float64)
    max_value = float(1 << (bit_depth - 1))
    add = max_value if data_type == "unsigned" else 0.0
    return v * np.where(v < 0, max_value, max_value - 1) + add
