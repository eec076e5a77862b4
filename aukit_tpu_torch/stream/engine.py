"""Chunked-stream resample/filter engine — counterpart of
``aukit_tpu.stream.engine``.

Replicates the per-chunk semantics of the reference's ``aukit.stream.pcm`` hot
loop (aukit.lua:2376-2421) as vectorized table-driven array ops:

 - each iterator call emits up to ``chunk`` (48000) output samples per channel;
 - output i (1-based) samples input position x_i = (i-1)*in_rate/out_rate + 1;
 - integer x passes through; fractional x interpolates (none/linear/cubic/sinc)
   over the *lazily consumed* input, so the per-chunk input consumption M is a
   static function of (mode, rates) — M = the highest input index touched by
   any output (computed in exact integer arithmetic);
 - warmup (aukit.lua:2376-2386): the first chunk eagerly reads
   interpolation_start..interpolation_end — for cubic/sinc (start == 0) the
   very first input sample lands at position 0, shifting the stream by one;
   every chunk requires at least interpolation_end fresh samples or the stream
   ends with no partial chunk;
 - the last two input samples (sinc: the last W+1) carry to the next chunk as
   positions -1..0 (-W..0) and x restarts at 1 — the reference's per-chunk
   phase reset;
 - a "lowpass" smoother out_i = prev_raw + alpha*(s_i - prev_raw) with
   alpha = 1 - exp(-(in_rate/96000)*2*pi). This is a 2-tap FIR, because the
   reference stores the *raw* previous sample as filter state
   (aukit.lua:2403-2404);
 - output scale: v * (v < 0 ? 128 : 127), optionally floored, clamped to
   [-128, 127] (stream.pcm never floors — float-valued int8-range output).

By default the filter state carries across chunks; the reference re-seeds it
to 0 every chunk (quirk Q9, aukit.lua:2392-2394) — set
``CONFIG.compat_quirks`` for that behavior.

At EOF a partial chunk is emitted covering every output whose inputs were
readable, matching the reference's pcall-truncated final chunk
(aukit.lua:2389, 2406).

``ChunkResampler`` has two backends, as in the JAX package: the numpy float64
host oracle (the native ``chunk_dsp`` in none/linear mode), bit-equal to the
JAX package's, and a float32 device twin for torch tensors (a stream of
device-resident values). The twin is the JAX package's jitted
``_device_chunk_fn`` in torch operations: every multiply that XLA fuses into
the add it feeds is one ``fma_kernel`` call (read from the optimised code of
the jitted function on the CPU: the linear lerp, the cubic polynomial's
multiply-adds, 60 of the 61 sinc taps and the FIR), so on the CPU
its chunks equal the jitted function's bit for bit. Below are also the FLAC
and QOA streams' host block resample and recursive lowpass, which the FLAC
fleet's host route calls too; their native twins in ``native/flacbits.cpp``
replay the numpy operation order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import CONFIG
from ..kernels.fma_cuda import fma_kernel
from ..ops.resample import INTERPOLATION_END, INTERPOLATION_START, sinc_weights
from ..parallel.pipeline import fir_alpha


@functools.lru_cache(maxsize=256)
def stream_plan(in_rate: int, out_rate: int, mode: str, chunk: int, window: int):
    """Static per-chunk tables (see module docstring)."""
    i = np.arange(chunk, dtype=np.int64)
    num = i * in_rate  # x_i - 1 = num / out_rate, exact rational
    ffx1 = num // out_rate + 1  # Lua floor(x_i), 1-based
    rem = num - (num // out_rate) * out_rate
    frac = rem.astype(np.float64) / out_rate
    exact = rem == 0
    if mode == "none":
        touch = ffx1
    elif mode == "linear":
        touch = np.where(exact, ffx1, ffx1 + 1)
    elif mode == "cubic":
        touch = np.where(exact, ffx1, ffx1 + 2)
    elif mode == "sinc":
        touch = np.where(exact, ffx1, ffx1 + window)
    else:
        raise ValueError(f"invalid interpolation mode {mode!r}")
    maxtouch = np.maximum.accumulate(touch)
    # EOF rule: lookahead taps fall back via the Lua `or` chain without
    # erroring; only the base sample d[floor(x)] (or d[x] at integer x) is
    # required, so a partial chunk emits while required <= available.
    required = np.maximum.accumulate(ffx1)
    warm_later = INTERPOLATION_END[mode]
    warm_first = warm_later - INTERPOLATION_START[mode] + 1
    M = int(max(maxtouch[-1], warm_later))
    hist = window + 1 if mode == "sinc" else 2
    w = sinc_weights(frac, window).astype(np.float64) if mode == "sinc" else None
    return {
        "ffx0": (ffx1 - 1).astype(np.int64),
        "frac": frac,
        "exact": exact,
        "maxtouch": maxtouch,
        "required": required,
        "M": M,
        "hist": hist,
        "warm_first": warm_first,
        "warm_later": warm_later,
        "shift_first": INTERPOLATION_START[mode] == 0,
        "sinc_w": w,
    }


def iir_lowpass_scan(x: np.ndarray, alpha: float, state: np.ndarray):
    """First-order IIR y_i = y_{i-1} + alpha*(x_i - y_{i-1}) over the last axis
    with initial state, evaluated by recursive doubling (O(n log n) vector ops,
    no per-sample Python loop). Returns (y, final_state). The reference's
    FLAC lowpass is truly recursive (aukit.lua:3178). ``state`` must be shaped
    like ``x[..., 0]``. The native twin (flacbits.cpp::iir_scan_rows) replays
    the identical doubling pass order — bit-equal, in place."""
    from ..native import flacbits as _nb

    if _nb.available() and np.ndim(x) >= 1 and x.shape[-1] > 0 \
            and np.shape(state) == np.shape(x)[:-1]:
        return _nb.iir_scan_rows(np.asarray(x, np.float64), alpha, state)
    c = 1.0 - alpha
    b = x * alpha
    b[..., 0] += c * state
    y = b
    ck = c
    shift = 1
    n = y.shape[-1]
    while shift < n:
        if ck == 0.0:  # f64 underflow: every further doubling pass adds
            break  # exactly +0.0 — skipping is bit-identical
        y[..., shift:] += ck * y[..., :-shift]
        ck = ck * ck
        shift *= 2
    return y, y[..., -1].copy()


@functools.lru_cache(maxsize=512)
def block_resample_plan(n_in: int, in_rate: int, out_rate: int, mode: str, window: int,
                        out_len: int | None = None):
    """Tables for resampling ONE block of n_in samples the Lua way:
    out i (0-based) at x = i*in/out + 1 (Lua 1-based), out_len =
    floor(n_in*out/in) unless given. Returns (out_len, ffx0, frac, exact,
    sinc weights) with ffx0 0-based relative to the block start."""
    if out_len is None:
        out_len = (n_in * out_rate) // in_rate
    i = np.arange(out_len, dtype=np.int64)
    num = i * in_rate
    ffx0 = num // out_rate
    rem = num - ffx0 * out_rate
    frac = rem.astype(np.float64) / out_rate
    exact = rem == 0
    w = sinc_weights(frac, window).astype(np.float64) if mode == "sinc" else None
    return out_len, ffx0, frac, exact, w


def lua_block_resample(
    ext: np.ndarray,
    hist_valid: int,
    n_in: int,
    in_rate: int,
    out_rate: int,
    mode: str,
    interp_clamp: tuple | None = None,
    out_len: int | None = None,
    hist: int | None = None,
) -> np.ndarray:
    """Resample one block with Lua edge-fallback semantics (aukit.lua:253-284):
    ``ext[..., H + n_in]`` where the last ``n_in`` columns are the block
    (Lua d[1..n]) and the preceding H columns are history (Lua d[<=0], of which
    only the trailing ``hist_valid`` are real). Missing p0 falls back to p1,
    missing p2 to p1, missing p3 to p2->p1; sinc skips missing taps.
    Vectorized over arbitrary leading dims. Returns float64 [..., out_len]."""
    H = ext.shape[-1] - n_in if hist is None else hist
    window = CONFIG.sinc_window_size
    out_len, ffx0, frac, exact, w = block_resample_plan(n_in, in_rate, out_rate, mode, window,
                                                        out_len)
    if out_len == 0:
        return np.zeros(ext.shape[:-1] + (0,), np.float64)
    ffx = ffx0 + H  # position of Lua d[floor(x)] within ext
    lo = H - hist_valid
    hi = ext.shape[-1] - 1

    if mode in ("none", "linear"):
        from ..native import flacbits as _nb

        if _nb.available():
            # fused native gather+lerp over rows (bit-identical f64 order)
            return _nb.block_resample_rows(
                np.asarray(ext, np.float64), ffx, frac, exact, out_len, mode,
                interp_clamp)

    def take(idx):
        return np.take(ext, np.clip(idx, 0, hi), axis=-1)

    def clip(v):
        if interp_clamp is None:
            return v
        return np.clip(v, interp_clamp[0], interp_clamp[1])

    if mode == "none":
        return take(ffx).astype(np.float64)
    if mode == "linear":
        p1 = take(ffx)
        p2 = take(np.where(ffx + 1 <= hi, ffx + 1, ffx))
        return np.where(exact, p1, clip(p1 + (p2 - p1) * frac))
    if mode == "cubic":
        p1 = take(ffx)
        p0 = take(np.where(ffx - 1 >= lo, ffx - 1, ffx))
        i2 = np.where(ffx + 1 <= hi, ffx + 1, ffx)
        p2 = take(i2)
        p3 = take(np.where(ffx + 2 <= hi, ffx + 2, i2))
        val = (
            (-0.5 * p0 + 1.5 * p1 - 1.5 * p2 + 0.5 * p3) * frac**3
            + (p0 - 2.5 * p1 + 2.0 * p2 - 0.5 * p3) * frac**2
            + (-0.5 * p0 + 0.5 * p2) * frac
            + p1
        )
        return np.where(exact, p1, clip(val))
    # sinc
    acc = np.zeros(ext.shape[:-1] + (out_len,), np.float64)
    for t in range(2 * window + 1):
        idx = ffx + (t - window)
        valid = (idx >= lo) & (idx <= hi)
        acc += take(idx) * (w[:, t] * valid)
    return np.where(exact, take(ffx), clip(acc))


def device_tables(plan: dict, mode: str, window: int, device) -> dict:
    """The device twin's plan tables on ``device``, which a ``ChunkResampler``
    makes once and keeps (its chunks slice them and copy nothing; they go
    with the resampler). ``ffx`` is the base tap within [carry, fresh];
    cubic adds frac**2 and frac**3 (XLA folds the constant powers in
    float32); sinc the tap offsets and weights [2W+1, chunk]."""
    fr = plan["frac"].astype(np.float32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    tables = {"ffx": put(plan["ffx0"] + plan["hist"]), "frac": put(fr),
              "exact": put(plan["exact"])}
    if mode == "cubic":
        tables["f2"], tables["f3"] = put(fr * fr), put(fr * fr * fr)
    if mode == "sinc":
        tables["taps"] = put(np.arange(-window, window + 1, dtype=np.int64)[:, None])
        tables["w"] = put(plan["sinc_w"].astype(np.float32).T)
    return tables


def device_chunk(carry: torch.Tensor, fresh: torch.Tensor, filter_state: torch.Tensor,
                 first_valid: int, plan: dict, tables: dict, out_len: int, mode: str,
                 lowpass: bool, alpha: float, scale_int8: bool, floor_output: bool,
                 interp_clamp, compat_quirks: bool):
    """One chunk of the float32 device twin (``_device_chunk_fn`` of the JAX
    package): gather -> interpolate -> FIR -> scale, in float32 on the
    tensors' device, with ``fma_kernel`` wherever XLA fuses a multiply into
    the add it feeds. -> (out f32[C, out_len], new carry, new filter state)."""
    hist = plan["hist"]
    ext = torch.cat([carry, fresh], dim=-1)
    k = fresh.shape[-1]
    last = ext.shape[-1] - 1
    ffx, frac, exact = (tables[n][:out_len] for n in ("ffx", "frac", "exact"))

    def take(idx):
        return torch.index_select(ext, -1, idx.clamp(0, last))

    def clip_i(v):
        return v if interp_clamp is None else v.clamp(interp_clamp[0], interp_clamp[1])

    if mode == "none":
        s = take(ffx)
    elif mode == "linear":
        p1 = take(ffx)
        p2 = take((ffx + 1).clamp(max=last))
        s = torch.where(exact, p1, clip_i(fma_kernel(p2 - p1, frac, p1)))
    elif mode == "cubic":
        p1 = take(ffx)
        p0 = take((ffx - 1).clamp(min=first_valid))
        p2 = take((ffx + 1).clamp(max=last))
        p3 = take((ffx + 2).clamp(max=last))
        # the polynomial as XLA compiles it: each multiply with one use fuses
        # into the add or subtract it feeds (halves and doubles are exact)
        a1 = fma_kernel(p2, -1.5, fma_kernel(p1, 1.5, -0.5 * p0)) + 0.5 * p3
        a2 = fma_kernel(p1, -2.5, p0) + 2.0 * p2 - 0.5 * p3
        a3 = -0.5 * p0 + 0.5 * p2
        val = fma_kernel(a3, frac, fma_kernel(a1, tables["f3"][:out_len],
                                              a2 * tables["f2"][:out_len])) + p1
        s = torch.where(exact, p1, clip_i(val))
    else:  # sinc: the first tap's product fuses into the add of the second's,
        # every later one into the running sum
        idx = ffx[None, :] + tables["taps"]  # [2W+1, out_len]
        valid = (idx >= first_valid) & (idx < hist + k)
        w = torch.where(valid, tables["w"][:, :out_len], 0.0)
        vals = torch.index_select(ext, -1, idx.clamp(0, last).reshape(-1)).reshape(
            ext.shape[0], *idx.shape)
        acc = fma_kernel(vals[:, 0], w[0], vals[:, 1] * w[1])
        for t in range(2, idx.shape[0]):
            acc = fma_kernel(vals[:, t], w[t], acc)
        s = torch.where(exact, take(ffx), clip_i(acc))
    if lowpass:
        prev = torch.cat([filter_state[:, None], s[:, :-1]], dim=-1)
        out = fma_kernel(s - prev, float(np.float32(alpha)), prev)
        new_fs = torch.zeros_like(filter_state) if compat_quirks else s[:, -1].clone()
    else:
        out, new_fs = s, filter_state
    if scale_int8:
        out = out * torch.where(out < 0, 128.0, 127.0)
    if floor_output:
        out = torch.floor(out)
    if scale_int8:
        out = out.clamp(-128.0, 127.0)
    read = min(k, plan["M"])
    return out, ext[:, read: read + hist].clone(), new_fs


class ChunkResampler:
    """Stateful per-stream chunk pipeline: raw samples in -> scaled chunks out.

    Values flow at the caller's scale ([-1,1] floats for PCM, int8-scale for
    the DFPWM path); ``scale_int8``/``floor_output``/``interp_clamp`` select
    the quantize variant each reference stream.* uses.

    Two backends: numpy float64 (the bit-parity oracle, default) and the
    float32 device twin (``device_chunk``), taken when ``process`` receives a
    torch tensor: the chunks and the carried state stay on its device.
    """

    def __init__(
        self,
        in_rate: int,
        channels: int,
        mode: str | None = None,
        out_rate: int | None = None,
        chunk: int | None = None,
        lowpass: bool = True,
        scale_int8: bool = True,
        floor_output: bool = False,
        interp_clamp: tuple | None = None,
    ):
        from ..config import get_interpolation

        self.mode = get_interpolation(mode)
        self.in_rate = int(in_rate)
        self.out_rate = int(out_rate or CONFIG.output_rate)
        self.chunk = int(chunk or CONFIG.chunk_samples)
        self.channels = channels
        self.window = CONFIG.sinc_window_size
        self.plan = stream_plan(self.in_rate, self.out_rate, self.mode, self.chunk, self.window)
        self.lowpass = lowpass
        self.alpha = fir_alpha(self.in_rate, self.out_rate)
        self.scale_int8 = scale_int8
        self.floor_output = floor_output
        self.interp_clamp = interp_clamp
        hist = self.plan["hist"]
        self.carry = np.zeros((channels, hist), np.float64)
        self.carry_valid = 0
        self.filter_state = np.zeros(channels, np.float64)
        self.first = True
        self.out_count = 0
        self._tables = (None, None)  # (device, the device twin's plan tables there)

    @property
    def samples_needed(self) -> int:
        """Fresh input samples consumed by the next full chunk."""
        extra = 1 if (self.first and self.plan["shift_first"]) else 0
        return self.plan["M"] + extra

    def _interp_clip(self, s):
        if self.interp_clamp is None:
            return s
        return np.clip(s, self.interp_clamp[0], self.interp_clamp[1])

    def _out_len(self, k: int) -> int:
        """Outputs of a chunk given k fresh samples (after the warm-up shift):
        0 ends the stream."""
        plan = self.plan
        warm = (plan["warm_first"] - (1 if plan["shift_first"] else 0) if self.first
                else plan["warm_later"])
        if k < warm:
            return 0
        if k >= plan["M"]:
            return self.chunk
        return int(np.searchsorted(plan["required"], k, side="right"))

    def _advance(self, k: int, out_len: int) -> float:
        self.carry_valid = min(self.carry_valid + min(k, self.plan["M"]), self.plan["hist"])
        self.first = False
        pos = self.out_count / self.out_rate
        self.out_count += out_len
        return pos

    def process(self, fresh):
        """fresh[C, k] raw samples (k <= samples_needed; fewer signals EOF).
        Returns (chunk[C, out_len] float32, position_seconds) or None at end.
        A torch tensor routes through the float32 device twin (the chunk and
        the carried state stay on its device); numpy stays on the host oracle."""
        if isinstance(fresh, torch.Tensor):
            return self._process_device(fresh)
        plan = self.plan
        M, hist = plan["M"], plan["hist"]
        fresh = np.asarray(fresh, np.float64)
        if self.first and plan["shift_first"]:
            # warmup places the first read at position 0 (aukit.lua:2376)
            if fresh.shape[1] == 0:
                return None
            self.carry = np.concatenate([self.carry[:, 1:], fresh[:, :1]], axis=1)
            self.carry_valid = 1
            fresh = fresh[:, 1:]
        k = fresh.shape[1]
        out_len = self._out_len(k)
        if out_len == 0:
            return None
        ext = np.concatenate([self.carry, fresh], axis=1)
        ffx = plan["ffx0"][:out_len] + hist
        frac = plan["frac"][:out_len]
        exact = plan["exact"][:out_len]
        n_ext = ext.shape[1]
        first_valid = hist - self.carry_valid
        read = min(k, M)

        if self.mode in ("none", "linear"):
            from ..native import flacbits as _nb

            if _nb.available():
                # fused native gather+lerp+FIR+scale (bit-identical f64 order)
                out, self.filter_state = _nb.chunk_dsp(
                    ext, ffx, frac, exact, out_len, self.mode, self.interp_clamp,
                    self.lowpass, self.alpha, self.filter_state,
                    CONFIG.compat_quirks, self.scale_int8, self.floor_output)
                self.carry = ext[:, read: hist + read].copy()
                return out.astype(np.float32), self._advance(k, out_len)

        if self.mode == "none":
            s = ext[:, np.clip(ffx, 0, n_ext - 1)]
        elif self.mode == "linear":
            p1 = ext[:, ffx]
            p2 = ext[:, np.minimum(ffx + 1, n_ext - 1)]
            s = np.where(exact, p1, self._interp_clip(p1 + (p2 - p1) * frac))
        elif self.mode == "cubic":
            p1 = ext[:, ffx]
            p0 = ext[:, np.maximum(ffx - 1, first_valid)]
            p2 = ext[:, np.minimum(ffx + 1, n_ext - 1)]
            p3 = ext[:, np.minimum(ffx + 2, n_ext - 1)]
            val = (
                (-0.5 * p0 + 1.5 * p1 - 1.5 * p2 + 0.5 * p3) * frac**3
                + (p0 - 2.5 * p1 + 2.0 * p2 - 0.5 * p3) * frac**2
                + (-0.5 * p0 + 0.5 * p2) * frac
                + p1
            )
            s = np.where(exact, p1, self._interp_clip(val))
        else:  # sinc
            w = plan["sinc_w"][:out_len]
            W = self.window
            acc = np.zeros((self.channels, out_len), np.float64)
            for t in range(2 * W + 1):
                idx = ffx + (t - W)
                valid = (idx >= first_valid) & (idx < hist + k)
                acc += ext[:, np.clip(idx, 0, n_ext - 1)] * (w[:, t] * valid)
            s = np.where(exact, ext[:, np.clip(ffx, 0, n_ext - 1)], self._interp_clip(acc))

        if self.lowpass:
            prev = np.concatenate([self.filter_state[:, None], s[:, :-1]], axis=1)
            out = prev + self.alpha * (s - prev)
            if CONFIG.compat_quirks:
                self.filter_state = np.zeros(self.channels, np.float64)  # quirk Q9
            else:
                self.filter_state = s[:, -1].copy()
        else:
            out = s

        if self.scale_int8:
            out = out * np.where(out < 0, 128.0, 127.0)
        if self.floor_output:
            out = np.floor(out)
        out = np.clip(out, -128.0, 127.0) if self.scale_int8 else out

        self.carry = ext[:, read: hist + read].copy()
        return out.astype(np.float32), self._advance(k, out_len)

    def _process_device(self, fresh: torch.Tensor):
        """Device twin of ``process``: the same plan, warm-up and EOF logic on
        shapes, the chunk's arithmetic in float32 on ``fresh``'s device."""
        plan = self.plan
        fresh = fresh.to(torch.float32)
        dev = fresh.device
        if not isinstance(self.carry, torch.Tensor):  # the host's state, or a checkpoint's
            self.carry = torch.as_tensor(self.carry, dtype=torch.float32).to(dev)
            self.filter_state = torch.as_tensor(self.filter_state, dtype=torch.float32).to(dev)
        if self.first and plan["shift_first"]:
            if fresh.shape[1] == 0:
                return None
            self.carry = torch.cat([self.carry[:, 1:], fresh[:, :1]], dim=1)
            self.carry_valid = 1
            fresh = fresh[:, 1:]
        k = fresh.shape[1]
        out_len = self._out_len(k)
        if out_len == 0:
            return None
        if self._tables[0] != dev:
            self._tables = (dev, device_tables(plan, self.mode, self.window, dev))
        tables = self._tables[1]
        out, self.carry, self.filter_state = device_chunk(
            self.carry, fresh, self.filter_state, plan["hist"] - self.carry_valid, plan,
            tables, out_len, self.mode, self.lowpass, self.alpha, self.scale_int8,
            self.floor_output, self.interp_clamp, CONFIG.compat_quirks)
        return out, self._advance(k, out_len)

    # -- checkpoint / resume: serializable resampler state ----------------------
    def get_state(self) -> dict:
        def host(a):
            return a.cpu().numpy().copy() if isinstance(a, torch.Tensor) else np.asarray(a).copy()

        return {
            "carry": host(self.carry),
            "carry_valid": self.carry_valid,
            "filter_state": host(self.filter_state),
            "first": self.first,
            "out_count": self.out_count,
        }

    def set_state(self, state: dict):
        self.carry = np.array(state["carry"], np.float64)
        self.carry_valid = int(state["carry_valid"])
        self.filter_state = np.array(state["filter_state"], np.float64)
        self.first = bool(state["first"])
        self.out_count = int(state["out_count"])
