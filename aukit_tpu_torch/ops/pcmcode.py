"""Raw PCM (de)serialization and value conversion — copied from
``aukit_tpu.ops.pcmcode`` (numpy on the host, float64 like the reference's
Lua doubles; aukit.lua:868-874, 1049-1088, 1861). The byte buffer is
reinterpreted as a numpy dtype in one pass (24-bit by 3-byte assembly).

 - signed normalise   : s / (s < 0 ? 2^(b-1) : 2^(b-1)-1)
 - unsigned normalise : (s - 128) / (s < 128 ? 2^(b-1) : 2^(b-1)-1), the
   128 bias and pivot at every depth (the reference's hardcoded value)
 - encode             : d * (d < 0 ? 2^(b-1) : 2^(b-1)-1) + (unsigned ? 2^(b-1) : 0),
   neither rounded nor clamped; float data passes through untouched
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


def unpack_pcm(data: bytes, bit_depth: int, data_type: str, big_endian: bool = False) -> np.ndarray:
    """bytes -> raw sample values (int64, or float32 for float data)."""
    order = ">" if big_endian else "<"
    if bit_depth == 24:
        b = np.frombuffer(data, dtype=np.uint8)
        if len(b) % 3:
            raise ValueError("24-bit data length not divisible by 3")
        b = b.reshape(-1, 3).astype(np.int64)
        if big_endian:
            v = (b[:, 0] << 16) | (b[:, 1] << 8) | b[:, 2]
        else:
            v = (b[:, 2] << 16) | (b[:, 1] << 8) | b[:, 0]
        if data_type == "signed":
            v = np.where(v >= 1 << 23, v - (1 << 24), v)
        return v
    dt = _DTYPES[(bit_depth, data_type)]
    vals = np.frombuffer(data, dtype=np.dtype(order + dt))
    if data_type == "float":
        return vals
    return vals.astype(np.int64)


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


def encode_pcm_values(data: np.ndarray, bit_depth: int, data_type: str) -> np.ndarray:
    """[C, N] float -> [C, N] raw values (unrounded), reference encodePCM."""
    return denormalize_pcm(data, bit_depth, data_type)


def decode_pcm(
    data,
    bit_depth: int = 8,
    data_type: str = "signed",
    channels: int = 1,
    interleaved: bool = True,
    big_endian: bool = False,
) -> np.ndarray:
    """bytes or value-array -> [channels, N] float32 (reference aukit.pcm,
    aukit.lua:1049)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        vals = unpack_pcm(bytes(data), bit_depth, data_type, big_endian)
    else:
        vals = np.asarray(data)
    if len(vals) % channels != 0:
        raise ValueError("uneven amount of data per channel")
    norm = normalize_pcm(vals, bit_depth, data_type)
    n = len(norm) // channels
    if interleaved and channels > 1:
        return np.ascontiguousarray(norm.reshape(n, channels).T)
    return norm.reshape(channels, n)
