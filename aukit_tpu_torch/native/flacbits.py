"""ctypes bindings for the native FLAC bitstream parser (``native/flacbits.cpp``)
— the entry points of ``aukit_tpu.native.flacbits``: the ones the FLAC fleet
calls, the padded-rows LPC restore ``restore_lpc``,
the host DFPWM decode that ``Fleet.seek`` replays a lane's prefix with and
``DfpwmStreamDecoder`` routes host bytes through, the host DFPWM encode and
QOA LMS, the fused whole-file FLAC and QOA decodes (``decode_full``,
``qoa_decode``: ``decode_flac``'s and ``decode_qoa``'s ``use_native=True``
routes), the routes the JAX package takes for a whole file (``chip_smoke.py``
times the kernels against them), and the stream iterators' PCM unpack and
fused chunk DSP (``pcm_frames``, ``chunk_dsp``).

At first use the repository's ``native/flacbits.cpp`` is compiled by g++ with
the JAX package's loader's flags into ``aukit_tpu_torch/_build/`` (the file
name carries a hash of the source and the flags, so an edited source is
rebuilt). The same flags keep the host route bit-equal to the JAX package's:
``-ffp-contract=off`` holds the DSP twins to the numpy oracle's per-op IEEE
rounding. ``available()`` is False when no compiler or source is present;
callers then take the pure-Python BitReader path of ``codecs.flac``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG.parent / "native" / "flacbits.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC")

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)


class _ParseResult(ctypes.Structure):
    _fields_ = [
        ("frame_block_size", _I32P),
        ("frame_chan_asgn", _I32P),
        ("n_frames", ctypes.c_int64),
        ("sub_order", _I32P),
        ("sub_shift", _I32P),
        ("sub_wasted", _I32P),
        ("sub_blk", _I32P),
        ("coefs", _I32P),
        ("n_subs", ctypes.c_int64),
        ("values", _I32P),
        ("n_values", ctypes.c_int64),
        ("error", ctypes.c_int32),
        ("end_pos", ctypes.c_int64),
    ]


class _DecodeResult(ctypes.Structure):
    _fields_ = [
        ("samples", ctypes.POINTER(ctypes.c_float)),
        ("n", ctypes.c_int64),
        ("error", ctypes.c_int32),
    ]


class _QoaDecodeResult(ctypes.Structure):
    _fields_ = [
        ("samples", _I32P),
        ("n", ctypes.c_int64),
    ]


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"flacbits_{h.hexdigest()[:16]}.so"


@functools.cache
def _load():
    """Compile (if the source changed) and load the library; None when the
    source or a working g++ is missing."""
    if not SRC.is_file():
        return None
    so = _library_path()
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp, so)  # atomic: a concurrent build never loads a partial file
    lib = ctypes.CDLL(str(so))
    lib.flac_parse.restype = ctypes.POINTER(_ParseResult)
    lib.flac_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.flac_free.restype = None
    lib.flac_free.argtypes = [ctypes.POINTER(_ParseResult)]
    lib.flac_decode_full.restype = ctypes.POINTER(_DecodeResult)
    lib.flac_decode_full.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int32, ctypes.c_int32]
    lib.flac_decode_free.restype = None
    lib.flac_decode_free.argtypes = [ctypes.POINTER(_DecodeResult)]
    lib.qoa_decode_full.restype = ctypes.POINTER(_QoaDecodeResult)
    lib.qoa_decode_full.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int32, ctypes.c_int32, ctypes.c_int64]
    lib.qoa_decode_free.restype = None
    lib.qoa_decode_free.argtypes = [ctypes.POINTER(_QoaDecodeResult)]
    lib.flac_restore.restype = None
    lib.flac_restore.argtypes = [_I64P] * 5 + [ctypes.c_int64] * 2
    lib.flac_restore_flat.restype = None
    lib.flac_restore_flat.argtypes = [_I64P] * 7 + [ctypes.c_int64]
    lib.block_resample_rows.restype = None
    lib.block_resample_rows.argtypes = [
        _F64P, ctypes.c_int64, ctypes.c_int64, _I64P, _F64P, _U8P, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_double, _F64P]
    lib.iir_scan_rows.restype = None
    lib.iir_scan_rows.argtypes = [_F64P, _F64P, _F64P, ctypes.c_double, ctypes.c_int64,
                                  ctypes.c_int64]
    lib.dfpwm_decode_rows.restype = None
    lib.dfpwm_decode_rows.argtypes = [_U8P, ctypes.c_int64, ctypes.c_int64, _I32P, _I32P]
    lib.dfpwm_encode_rows.restype = None
    lib.dfpwm_encode_rows.argtypes = [_I32P, ctypes.c_int64, ctypes.c_int64, _I32P, _U8P]
    lib.qoa_lms.restype = None
    lib.qoa_lms.argtypes = [_I32P, _I32P, _I32P, _I32P, ctypes.c_int64, ctypes.c_int64]
    lib.pcm_frames.restype = ctypes.c_int64
    lib.pcm_frames.argtypes = [ctypes.c_char_p, ctypes.c_int64] + [ctypes.c_int32] * 5 + [_F64P]
    lib.chunk_dsp.restype = None
    lib.chunk_dsp.argtypes = [
        _F64P, ctypes.c_int64, ctypes.c_int64, _I64P, _F64P, _U8P, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_double, ctypes.c_int32,
        ctypes.c_double, _F64P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _F64P]
    return lib


def available() -> bool:
    return _load() is not None


_ERRORS = {
    1: "Reserved residual coding method",
    2: "Block size not divisible by number of Rice partitions",
    3: "Reserved subframe type",
    4: "Sync code expected",
    5: "Reserved block size",
    6: "Reserved channel assignment",
    7: "unexpected end of FLAC stream",
}


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native FLAC parser did not build from {SRC}")
    return lib


def decode_full(data: bytes, pos: int, channels: int, depth: int, strict: bool = True):
    """Fused whole-file decode: parse -> restore -> decorrelate -> normalize
    in one native pass. Returns float32[C, N] (half-scale, /2^depth).
    Raises FlacError on malformed streams when strict."""
    from ..codecs.flac import FlacError

    lib = _lib()
    res = lib.flac_decode_full(data, len(data), pos, channels, depth)
    try:
        r = res.contents
        if r.error != 0 and strict:
            raise FlacError(_ERRORS.get(int(r.error), f"FLAC parse error {int(r.error)}"))
        n = int(r.n)
        if n == 0:
            return np.zeros((channels, 0), np.float32)
        return np.ctypeslib.as_array(r.samples, (channels * n,)).copy().reshape(channels, n)
    finally:
        lib.flac_decode_free(res)


def qoa_decode(data: bytes, pos: int, channels: int, sample_rate: int,
               file_samples: int) -> np.ndarray:
    """Fused whole-stream QOA decode (frame walk + slices + LMS in one native
    pass). Returns int32[C, N] reconstructed samples."""
    lib = _lib()
    res = lib.qoa_decode_full(data, len(data), pos, channels, sample_rate, file_samples)
    try:
        n = int(res.contents.n)
        if n == 0:
            return np.zeros((channels, 0), np.int32)
        return np.ctypeslib.as_array(res.contents.samples, (channels * n,)).copy().reshape(
            channels, n)
    finally:
        lib.qoa_decode_free(res)


def parse_frames(data: bytes, pos: int, channels: int, depth: int, strict: bool = True,
                 incremental: bool = False):
    """Parse all frames natively. Returns
    (frame_meta [F,2] int32 (block_size, chan_asgn),
     sub_meta dict of int64 arrays (order, shift, wasted, block),
     coefs [S,32] int64, values_flat int64[n]) — dtypes match the Python path;
    with ``incremental=True`` a fifth element is returned: the byte offset
    just past the last committed frame (frames whose CRC16 bytes are absent
    stay uncommitted — resume from end_pos once more bytes arrive).
    Raises FlacError on malformed streams (same conditions as the reference);
    with strict=False, returns the frames completed before the error (the
    stream path's lenient behavior, aukit.lua:3158)."""
    from ..codecs.flac import FlacError

    lib = _lib()
    res = lib.flac_parse(data, len(data), pos, channels, depth, 1 if incremental else 0)
    try:
        r = res.contents
        if r.error != 0 and strict:
            raise FlacError(_ERRORS.get(int(r.error), f"FLAC parse error {int(r.error)}"))
        F, S, NV = int(r.n_frames), int(r.n_subs), int(r.n_values)
        fbs = np.ctypeslib.as_array(r.frame_block_size, (max(F, 1),))[:F].copy()
        fca = np.ctypeslib.as_array(r.frame_chan_asgn, (max(F, 1),))[:F].copy()
        sub = {
            "order": np.ctypeslib.as_array(r.sub_order, (max(S, 1),))[:S].astype(np.int64),
            "shift": np.ctypeslib.as_array(r.sub_shift, (max(S, 1),))[:S].astype(np.int64),
            "wasted": np.ctypeslib.as_array(r.sub_wasted, (max(S, 1),))[:S].astype(np.int64),
            "block": np.ctypeslib.as_array(r.sub_blk, (max(S, 1),))[:S].astype(np.int64),
        }
        coefs = np.ctypeslib.as_array(r.coefs, (max(S, 1) * 32,))[: S * 32].astype(
            np.int64).reshape(S, 32)
        values = np.ctypeslib.as_array(r.values, (max(NV, 1),))[:NV].astype(np.int64)
        frame_meta = np.stack([fbs, fca], axis=1) if F else np.zeros((0, 2), np.int32)
        if incremental:
            return frame_meta, sub, coefs, values, int(r.end_pos)
        return frame_meta, sub, coefs, values
    finally:
        lib.flac_free(res)


def restore_lpc_flat(flat: np.ndarray, offsets: np.ndarray, blocks: np.ndarray,
                     orders: np.ndarray, shifts: np.ndarray, wasted: np.ndarray,
                     coefs: np.ndarray) -> np.ndarray:
    """In-place LPC restore + wasted-bits shift on the parser's flat int64
    values (one contiguous span per subframe) — no padded-matrix staging."""
    lib = _lib()
    flat = np.ascontiguousarray(flat, np.int64)
    # hold references: ascontiguousarray temporaries must outlive the C call
    arrs = [np.ascontiguousarray(a, np.int64)
            for a in (offsets, blocks, orders, shifts, wasted, coefs)]
    lib.flac_restore_flat(flat.ctypes.data_as(_I64P), *(a.ctypes.data_as(_I64P) for a in arrs),
                          len(blocks))
    return flat


def restore_lpc(values: np.ndarray, blocks: np.ndarray, orders: np.ndarray,
                shifts: np.ndarray, coefs: np.ndarray) -> np.ndarray:
    """In-place batched LPC restore over values[S, T] int64 (C-contiguous):
    the padded-rows layout of the JAX package's binding of the same name.
    Raises ValueError where the C loop would index or shift out of range
    (coefs not [S, 32], a block outside [0, T], an order outside [0, 32], a
    shift outside [-63, 63]), which the JAX binding passes through."""
    lib = _lib()
    values = np.ascontiguousarray(values, np.int64)
    # hold references: ascontiguousarray temporaries must outlive the C call
    arrs = [np.ascontiguousarray(a, np.int64) for a in (blocks, orders, shifts, coefs)]
    if values.ndim != 2:
        raise ValueError(f"values must be [S, T], got shape {values.shape}")
    S, T = values.shape
    blocks, orders, shifts, coefs = arrs
    if coefs.shape != (S, 32) or any(a.shape != (S,) for a in (blocks, orders, shifts)):
        raise ValueError("blocks, orders and shifts must be [S] and coefs [S, 32]")
    if S and (blocks.min() < 0 or blocks.max() > T or orders.min() < 0 or orders.max() > 32
              or np.abs(shifts).max() > 63):
        raise ValueError("a block, order or shift is out of the restore's range")
    lib.flac_restore(values.ctypes.data_as(_I64P), *(a.ctypes.data_as(_I64P) for a in arrs),
                     S, T)
    return values


def block_resample_rows(ext: np.ndarray, ffx: np.ndarray, frac: np.ndarray,
                        exact: np.ndarray, out_len: int, mode: str,
                        interp_clamp) -> np.ndarray:
    """Row-batched block resample ("none"/"linear") — bit-identical f64 order
    to the numpy path in stream/engine.py::lua_block_resample. ``ext`` is
    [..., n_ext] (any leading dims); returns [..., out_len]."""
    lib = _lib()
    ext = np.ascontiguousarray(ext, np.float64)
    n_ext = ext.shape[-1]
    R = ext.size // n_ext if n_ext else 0
    ffx = np.ascontiguousarray(ffx, np.int64)
    frac = np.ascontiguousarray(frac, np.float64)
    exact_u8 = np.ascontiguousarray(exact, np.uint8)
    out = np.empty(ext.shape[:-1] + (out_len,), np.float64)
    lib.block_resample_rows(
        ext.ctypes.data_as(_F64P), R, n_ext, ffx.ctypes.data_as(_I64P),
        frac.ctypes.data_as(_F64P), exact_u8.ctypes.data_as(_U8P), out_len,
        0 if mode == "none" else 1,
        0 if interp_clamp is None else 1,
        0.0 if interp_clamp is None else float(interp_clamp[0]),
        0.0 if interp_clamp is None else float(interp_clamp[1]),
        out.ctypes.data_as(_F64P))
    return out


def iir_scan_rows(x: np.ndarray, alpha: float, state: np.ndarray):
    """Row-batched recursive-doubling IIR — bit-identical to
    stream/engine.py::iir_lowpass_scan's numpy math. ``x`` is [..., T] with
    ``state`` shaped like x[..., 0]. Returns (y, final_state)."""
    lib = _lib()
    T = x.shape[-1]
    y = np.array(x, np.float64, order="C")  # a fresh copy: the scan runs in place
    st = np.ascontiguousarray(state, np.float64).reshape(-1).copy()
    R = y.size // T
    fs = np.empty(R, np.float64)
    lib.iir_scan_rows(y.ctypes.data_as(_F64P), st.ctypes.data_as(_F64P),
                      fs.ctypes.data_as(_F64P), float(alpha), R, T)
    return y, fs.reshape(np.shape(state)).copy()


def dfpwm_decode_rows(bytes_u8: np.ndarray, state: np.ndarray):
    """Host DFPWM1a decode, bit-identical to ``codecs.dfpwm.dfpwm_decode``.
    ``bytes_u8`` uint8[L, B], ``state`` int32[5, L] (the ``DfpwmState``
    fields in order). Returns (int32[L, B*8] samples, new int32[5, L] state)."""
    lib = _lib()
    b = np.ascontiguousarray(bytes_u8, np.uint8)
    st = np.array(state, np.int32, order="C")  # a fresh copy: updated in place
    L, B = b.shape
    out = np.empty((L, B * 8), np.int32)
    lib.dfpwm_decode_rows(b.ctypes.data_as(_U8P), L, B, st.ctypes.data_as(_I32P),
                          out.ctypes.data_as(_I32P))
    return out, st


def dfpwm_encode_rows(levels: np.ndarray, state: np.ndarray):
    """Host DFPWM1a encode, bit-identical to ``codecs.dfpwm.dfpwm_encode``.
    ``levels`` int32[L, N] (N a multiple of 8), ``state`` int32[3, L]
    (charge, strength, previous bit). Returns (uint8[L, N//8], new state)."""
    lib = _lib()
    lv = np.ascontiguousarray(levels, np.int32)
    st = np.array(state, np.int32, order="C")  # a fresh copy: updated in place
    L, N = lv.shape
    if N % 8:
        raise ValueError(f"levels must hold a multiple of 8 samples per lane, got {N}")
    out = np.empty((L, N // 8), np.uint8)
    lib.dfpwm_encode_rows(lv.ctypes.data_as(_I32P), L, N, st.ctypes.data_as(_I32P),
                          out.ctypes.data_as(_U8P))
    return out, st


def qoa_lms(dequantized: np.ndarray, history: np.ndarray, weights: np.ndarray):
    """Host QOA LMS: residuals int32[L, T] and the state int32[L, 4] twice ->
    (int32[L, T] samples, history, weights), the state updated in copies."""
    lib = _lib()
    dq = np.ascontiguousarray(dequantized, np.int32)
    hist = np.array(history, np.int32, order="C")
    wts = np.array(weights, np.int32, order="C")
    L, T = dq.shape
    out = np.empty((L, T), np.int32)
    lib.qoa_lms(dq.ctypes.data_as(_I32P), out.ctypes.data_as(_I32P),
                hist.ctypes.data_as(_I32P), wts.ctypes.data_as(_I32P), L, T)
    return out, hist, wts


_PCM_TYPE = {"signed": 0, "unsigned": 1, "float": 2}


def pcm_frames(raw: bytes, bit_depth: int, data_type: str, big_endian: bool,
               channels: int, mono: bool) -> np.ndarray:
    """One-pass unpack + normalize (+mono mean) -> float64[C_out, k].
    Bit-identical to the staged unpack_pcm/normalize_pcm/mean pipeline."""
    lib = _lib()
    bpf = (bit_depth // 8) * channels
    k = len(raw) // bpf
    c_out = 1 if (mono and channels > 1) else channels
    out = np.empty((c_out, k), np.float64)
    lib.pcm_frames(raw, len(raw), bit_depth, _PCM_TYPE[data_type], 1 if big_endian else 0,
                   channels, 1 if (mono and channels > 1) else 0, out.ctypes.data_as(_F64P))
    return out


def chunk_dsp(ext: np.ndarray, ffx: np.ndarray, frac: np.ndarray, exact: np.ndarray,
              out_len: int, mode: str, interp_clamp, lowpass: bool, alpha: float,
              filter_state: np.ndarray, zero_state_after: bool,
              scale_int8: bool, floor_output: bool):
    """Fused gather+lerp+FIR+scale for the 'none'/'linear' stream modes —
    float64 ops in the numpy oracle's exact order. Returns
    (out f64[C, out_len], new_filter_state f64[C])."""
    lib = _lib()
    ext = np.ascontiguousarray(ext, np.float64)
    C, n_ext = ext.shape
    ffx = np.ascontiguousarray(ffx[:out_len], np.int64)
    frac = np.ascontiguousarray(frac[:out_len], np.float64)
    exact_u8 = np.ascontiguousarray(exact[:out_len], np.uint8)
    fs = np.ascontiguousarray(filter_state, np.float64).copy()
    out = np.empty((C, out_len), np.float64)
    lib.chunk_dsp(
        ext.ctypes.data_as(_F64P), C, n_ext, ffx.ctypes.data_as(_I64P),
        frac.ctypes.data_as(_F64P), exact_u8.ctypes.data_as(_U8P), out_len,
        0 if mode == "none" else 1,
        0 if interp_clamp is None else 1,
        0.0 if interp_clamp is None else float(interp_clamp[0]),
        0.0 if interp_clamp is None else float(interp_clamp[1]),
        1 if lowpass else 0, float(alpha), fs.ctypes.data_as(_F64P),
        1 if zero_state_after else 0, 1 if scale_int8 else 0,
        1 if floor_output else 0, out.ctypes.data_as(_F64P))
    return out, fs
