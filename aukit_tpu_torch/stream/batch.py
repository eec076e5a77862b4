"""Batched multi-stream decode engine — counterpart of
``aukit_tpu.stream.batch``.

Many independent streams are packed into fixed lanes. Lanes with equal
``LaneSpec`` share a *group*: one decode dispatch and one resample plan per
group per step. Every lane codec of the JAX engine is served (DFPWM, PCM
8/16/24/32 LE and BE, f32, G.711 µ/A-law, IMA and MS ADPCM, QOA); only
DFPWM carries codec state on the device between steps, the block codecs
read theirs from each block header.

 - host side: ``_GroupIO`` staging (bulk-fed groups slice column views of the
   fed arrays; per-lane ``feed()`` buffers jittery network ingestion);
 - device side, per group step: identity-rate DFPWM lanes (48 kHz) run the
   fused decode + normalize + smoothing + gain + int8 + lane-mask CUDA
   kernel (``dfpwm_decode_dsp_kernel``); every other group decodes
   (``batch_codecs.build_decoder``: the DFPWM, IMA, MS ADPCM and QOA CUDA
   kernels, torch ops for the elementwise codecs), then runs ``dsp_chain``
   (resample, FIR, gain, int8) as torch ops;
 - exhausted or unfed lanes are masked, not removed: their output is zeros
   and their state does not advance;
 - heterogeneous engines assemble uniform one-second windows from per-group
   device FIFOs; homogeneous engines emit each decode chunk directly;
 - per-lane checkpoints in the JAX engine's numpy format, so a checkpoint of
   either engine restores into the other;
 - with ``mono=False`` windows keep the decoded channels: ``int8[L, C, T]``
   per-channel chunks (the reference's chunk contract, aukit.lua:2223-2227),
   C the fleet's largest channel count; lanes with fewer channels replicate
   channel 0, the reference's speaker fallback ``chunk[i] or chunk[1]``
   (aukit.lua:1935);
 - per-lane DSP stages, the batched auplay chain at each lane's native rate
   (auplay.lua:20-31): mono toggle -> ``normalize`` gain -> one-pole
   lowpass/highpass (``set_filter``) with chunk-carried filter state. A group
   with any stage set leaves the fused DFPWM kernel for decode + stages +
   ``dsp_chain``, as the JAX engine does;
 - with a ``mesh`` (``parallel.pipeline.make_mesh``) every group pads its
   device lanes to a multiple of the mesh's shards and each shard keeps its
   own rows of the carried state (codec state, FIR, filter carries) and runs
   the group's step, its kernel launches included, on its own device; the
   step's output is gathered in lane order onto the mesh's first device.
   No other operation crosses shards.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..codecs.dfpwm import norm8
from ..config import CONFIG, get_interpolation, require_device
from ..kernels.dfpwm_cuda import dfpwm_decode_dsp_kernel
from ..kernels.fma_cuda import fma_kernel
from ..ops.scan import linear_scan
from ..parallel.mesh import check_mesh, gather_rows, lane_layout, padded_rows
from ..parallel.pipeline import dsp_chain, fir_alpha
from ..utils.trace import span
from .batch_codecs import LaneSpec, _mono, build_decoder, geometry, init_state

__all__ = ["LaneSpec", "BatchStreamEngine", "BatchDfpwmDecoder", "BatchMetrics"]


@dataclasses.dataclass
class BatchMetrics:
    """Per-engine counters, added once a step (never per lane). The
    ``utils.trace`` spans carry their change over each span. Step time is
    what the ``aukit.*.step`` spans measure under a profiler."""

    steps: int = 0
    samples_decoded: int = 0
    underruns: int = 0  # steps where some active lane had no data
    bytes_staged: int = 0  # fed bytes moved into staged matrices
    htod_copies: int = 0  # copies of host arrays onto the engine's device
    htod_bytes: int = 0
    lanes_ready: int = 0  # lane chunks decoded from real bytes
    frames_parsed: int = 0  # FlacFleet: frames committed by the parse
    bytes_parsed: int = 0  # FlacFleet: the committed frames' bytes
    dsp_lanes_device: int = 0  # FlacFleet host route: lanes whose DSP ran in the f64 kernel
    dsp_lanes_host: int = 0  # FlacFleet host route: lanes whose DSP ran in numpy
    # FlacFleet, counted only while a profiler records (``utils.trace``):
    dsp_frames_device: int = 0  # host route: frames of the lanes whose DSP ran in the kernel
    dsp_frames_host: int = 0  # host route: frames of the lanes whose DSP ran in numpy
    dsp_lanes_mixed_asgn: int = 0  # host route: numpy lanes whose frames mix assignments
    dsp_lanes_mixed_asgn_device: int = 0  # host route: kernel lanes whose frames mix them
    frames_asgn_indep: int = 0  # parsed frames of independent channels (mono included)
    frames_asgn_left_side: int = 0  # parsed frames coded left/side
    frames_asgn_side_right: int = 0  # parsed frames coded side/right
    frames_asgn_mid_side: int = 0  # parsed frames coded mid/side


# -- device FIFO helpers ------------------------------------------------------------

def _dev_push(fifo: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return torch.cat([fifo, out], dim=-1)


def _dev_pop(fifo: torch.Tensor, take: int, count: int):
    window = fifo[..., :take]
    if take < count:
        window = F.pad(window, (0, count - take))
    return window, fifo[..., take:]


def _dev_pop_skip(fifo: torch.Tensor, skip: torch.Tensor, take: int, count: int, smax: int):
    """Per-lane-cursor pop: lane l reads columns [skip[l], skip[l]+count) —
    lanes whose cursor rides ahead of the FIFO front (a mid-stream
    seek/reset discarded their stale prefix) deliver their own timeline
    while the group front advances in lockstep. Columns beyond the fill are
    zeros."""
    need = smax + count
    fifo_p = F.pad(fifo, (0, need - fifo.shape[-1])) if fifo.shape[-1] < need else fifo
    idx = skip[:, None] + torch.arange(count, dtype=skip.dtype, device=skip.device)
    if fifo.dim() == 3:
        idx = idx[:, None, :].expand(-1, fifo.shape[1], -1)
    return torch.gather(fifo_p, -1, idx), fifo[..., take:]


def _dev_padch(w: torch.Tensor, cmax: int) -> torch.Tensor:
    """[L, C, T] -> [L, cmax, T]: missing channels replicate channel 0, the
    batched form of the reference's speaker fallback ``chunk[i] or chunk[1]``
    (aukit.lua:1935)."""
    if w.shape[1] == cmax:
        return w
    return torch.cat([w, w[:, :1].expand(-1, cmax - w.shape[1], -1)], dim=1)


def _dev_assemble(windows, inv: torch.Tensor) -> torch.Tensor:
    cat = torch.cat(windows, dim=0) if len(windows) > 1 else windows[0]
    return torch.index_select(cat, 0, inv)


def _concat_cols(parts, n: int, lanes: int):
    """Column-concatenate segments (numpy or torch) and zero-pad to n."""
    if all(isinstance(p, np.ndarray) for p in parts):
        out = np.zeros((lanes, n), np.uint8)
        at = 0
        for p in parts:
            out[:, at : at + p.shape[1]] = p
            at += p.shape[1]
        return out
    cat = torch.cat([torch.as_tensor(p) for p in parts], dim=1)
    if cat.shape[1] < n:
        cat = F.pad(cat, (0, n - cat.shape[1]))
    return cat


def _host_bytes(row) -> bytes:
    if isinstance(row, torch.Tensor):
        row = row.cpu().numpy()
    return np.asarray(row).tobytes()


class _GroupIO:
    """Per-group ingestion buffers.

    Two modes, fixed at first feed:
     - "bulk": whole ``[lanes, bytes]`` matrices (numpy, or torch on any
       device) via feed_bulk; staging slices columns out of the fed arrays;
     - "lane": per-lane byte chunks via feed_lane (network-style ingestion).
    """

    def __init__(self, lanes: int, n: int):
        self.lanes, self.n = lanes, n
        self.mode: str | None = None
        self.segs: collections.deque = collections.deque()  # [L, W] segments
        self.seg_off = 0  # consumed columns of segs[0]
        # lane mode: per-lane deques of fed byte chunks + a consumed-prefix
        # offset into each head chunk, so staging gathers every ready lane's
        # bytes into ONE join + ONE frombuffer + ONE scatter per step
        self.bufs: list[collections.deque] | None = None
        self.offs: list[int] | None = None
        self.sizes: np.ndarray | None = None  # int64[L] buffered bytes
        self.eof = np.zeros(lanes, bool)

    def _lane_mode(self):
        self.mode = "lane"
        self.bufs = [collections.deque() for _ in range(self.lanes)]
        self.offs = [0] * self.lanes
        self.sizes = np.zeros(self.lanes, np.int64)

    # -- feeding -------------------------------------------------------------
    def feed_lane(self, slot: int, data: bytes | None):
        if data is None:
            self.eof[slot] = True
            return
        if self.mode == "bulk":
            raise RuntimeError("group already fed via feed_array; cannot mix with feed()")
        if self.mode is None:
            self._lane_mode()
        if len(data) == 0:
            return
        # snapshot mutable buffers: staged views must not alias caller state
        self.bufs[slot].append(data if isinstance(data, bytes) else bytes(data))
        self.sizes[slot] += len(data)

    def feed_bulk(self, arr, eof: bool):
        if self.mode == "lane":
            raise RuntimeError("group already fed via feed(); cannot mix with feed_array()")
        self.mode = "bulk"
        if isinstance(arr, np.ndarray) and arr.dtype != np.uint8:
            arr = arr.astype(np.uint8)
        if isinstance(arr, torch.Tensor) and arr.dtype != torch.uint8:
            arr = arr.to(torch.uint8)
        if arr.shape[0] != self.lanes:
            raise ValueError(f"feed_array rows {arr.shape[0]} != group lanes {self.lanes}")
        if arr.shape[1]:
            self.segs.append(arr)
        if eof:
            self.eof[:] = True

    # -- queries -------------------------------------------------------------
    def available(self) -> np.ndarray:
        if self.mode == "bulk":
            tot = sum(s.shape[1] for s in self.segs) - self.seg_off
            return np.full(self.lanes, tot, np.int64)
        if self.mode == "lane":
            return self.sizes.copy()
        return np.zeros(self.lanes, np.int64)

    @property
    def exhausted(self) -> bool:
        return bool(self.eof.all()) and not self.available().any()

    def pending_bytes(self, slot: int) -> bytes:
        if self.mode == "bulk":
            parts, off = [], self.seg_off
            for s in self.segs:
                parts.append(_host_bytes(s[slot, off:]))
                off = 0
            return b"".join(parts)
        if self.mode == "lane":
            off = self.offs[slot]
            return b"".join(
                memoryview(c)[off:] if i == 0 and off else c
                for i, c in enumerate(self.bufs[slot]))
        return b""

    def replace_lane(self, slot: int, data: bytes, eof: bool):
        if self.mode == "bulk":
            raise RuntimeError("cannot restore a single lane of a bulk-fed group")
        if self.mode is None:
            self._lane_mode()
        self.bufs[slot] = collections.deque([bytes(data)] if data else [])
        self.offs[slot] = 0
        self.sizes[slot] = len(data)
        self.eof[slot] = eof

    def snapshot(self) -> "_GroupIO":
        """Copy of the ingestion state: cursors and chunk references (numpy
        arrays, torch tensors on any device, or bytes), no byte copies. The
        normalize measuring pass stages from the copy and leaves the live
        buffers untouched."""
        s = _GroupIO(self.lanes, self.n)
        s.mode = self.mode
        s.segs = collections.deque(self.segs)
        s.seg_off = self.seg_off
        if self.bufs is not None:
            s.bufs = [collections.deque(d) for d in self.bufs]
            s.offs = list(self.offs)
            s.sizes = self.sizes.copy()
        s.eof = self.eof.copy()
        return s

    def _take_lane(self, slot: int, need: int, pieces: list):
        """Append exactly ``need`` buffered bytes of one lane to ``pieces``
        (zero-copy memoryviews) and advance the lane's cursor."""
        dq, off = self.bufs[slot], self.offs[slot]
        while need:
            head = dq[0]
            avail = len(head) - off
            if avail <= need:
                pieces.append(memoryview(head)[off:] if off else head)
                dq.popleft()
                off = 0
                need -= avail
            else:
                pieces.append(memoryview(head)[off: off + need])
                off += need
                need = 0
        self.offs[slot] = off

    # -- staging -------------------------------------------------------------
    def stage(self):
        """-> (staged uint8[L, n], ready bool[L], consumed int64[L], underrun)
        or None when no lane can produce. Partial EOF tails are zero-padded
        and decoded in full (the JAX engine's semantics: state advances over
        the padding). Bulk staging is a column view when the chunk falls
        inside one fed segment."""
        n = self.n
        if self.mode == "bulk":
            tot = sum(s.shape[1] for s in self.segs) - self.seg_off
            if tot >= n:
                head = self.segs[0]
                if head.shape[1] - self.seg_off >= n:
                    staged = head[:, self.seg_off : self.seg_off + n]  # view
                    self.seg_off += n
                    if self.seg_off == head.shape[1]:
                        self.segs.popleft()
                        self.seg_off = 0
                else:  # chunk spans segments: assemble once
                    parts = []
                    filled = 0
                    while filled < n:
                        head = self.segs[0]
                        take = min(n - filled, head.shape[1] - self.seg_off)
                        parts.append(head[:, self.seg_off : self.seg_off + take])
                        filled += take
                        self.seg_off += take
                        if self.seg_off == head.shape[1]:
                            self.segs.popleft()
                            self.seg_off = 0
                    staged = _concat_cols(parts, n, self.lanes)
                return staged, np.ones(self.lanes, bool), np.full(self.lanes, n, np.int64), False
            if tot > 0 and self.eof.all():
                parts = []
                while self.segs:
                    head = self.segs.popleft()
                    parts.append(head[:, self.seg_off :])
                    self.seg_off = 0
                staged = _concat_cols(parts, n, self.lanes)
                return staged, np.ones(self.lanes, bool), np.full(self.lanes, tot, np.int64), False
            return None
        if self.mode == "lane":
            sizes = self.sizes
            full = sizes >= n
            partial = self.eof & ~full & (sizes > 0)  # EOF tails, zero-padded
            underrun = bool((~self.eof & ~full).any())
            ready = full | partial
            if not ready.any():
                return None
            consumed = np.where(full, n, np.where(partial, sizes, 0))
            full_idx = np.nonzero(full)[0]
            pieces: list = []
            for slot in full_idx:
                self._take_lane(int(slot), n, pieces)
            sizes[full_idx] -= n
            mat = np.frombuffer(b"".join(pieces), np.uint8)
            if len(full_idx) == self.lanes:
                return (mat.reshape(self.lanes, n), ready,
                        consumed.astype(np.int64), underrun)
            staged = np.zeros((self.lanes, n), np.uint8)
            if len(full_idx):
                staged[full_idx] = mat.reshape(len(full_idx), n)
            for slot in np.nonzero(partial)[0]:  # rare: final EOF tails only
                take = int(sizes[slot])
                tail: list = []
                self._take_lane(int(slot), take, tail)
                staged[slot, :take] = np.frombuffer(b"".join(tail), np.uint8)
                sizes[slot] = 0
            return staged, ready, consumed.astype(np.int64), underrun
        return None


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A fresh contiguous copy of host (numpy) or device bytes on ``device``:
    nothing the caller mutates later can race an asynchronous copy."""
    if isinstance(x, np.ndarray):
        return torch.tensor(x, device=device)
    return x.to(device).contiguous()


def _copy_in(m: BatchMetrics, x, device: torch.device) -> torch.Tensor:
    """``_to_device`` for a step, inside an ``aukit.engine.htod`` span; a
    copy from the host (a numpy array, or a tensor on another device's
    host memory) counts in ``m``'s ``htod_copies`` and ``htod_bytes``."""
    with span("aukit.engine.htod", m):
        out = _to_device(x, device)
    if isinstance(x, np.ndarray) or (x.device.type == "cpu" and out.device.type != "cpu"):
        m.htod_copies += 1
        m.htod_bytes += x.nbytes
    return out


class _Shard:
    """One shard of a group: rows [lo, hi) of its padded device lanes on
    ``device``, with the tensors the group carries across steps for them."""

    def __init__(self, spec: LaneSpec, device: torch.device, lo: int, hi: int,
                 mono: bool, out_ch: int):
        self.device, self.lo, self.hi = device, lo, hi
        rows = hi - lo
        self.fir = torch.zeros((rows,) if mono else (rows, out_ch), dtype=torch.float32,
                               device=device)
        # the one-pole filter's carried y/x (set_filter)
        self.filt_y = torch.zeros_like(self.fir)
        self.filt_x = torch.zeros_like(self.fir)
        self.state = init_state(spec, rows, device)


class _Group:
    """Lanes sharing one LaneSpec: device step + staging + output FIFO."""

    def __init__(self, spec: LaneSpec, slots: np.ndarray, device: torch.device,
                 out_rate: int, mono: bool = True, mode: str = "linear", mesh=None,
                 metrics: BatchMetrics | None = None):
        self.spec = spec
        self.metrics = BatchMetrics() if metrics is None else metrics  # the engine's
        self.slots = slots  # external lane ids, in engine order
        self.lanes = len(slots)
        self.mono = mono
        self.mode = mode  # resample interpolation (dsp_chain, all 4 modes)
        self.out_ch = 1 if mono else spec.channels
        self.decode = build_decoder(spec, mono)
        # in_samples counts per-channel frames, so out_samples holds for both
        # the mono [L, T] and the per-channel [L, C, T] output contract
        self.in_bytes, self.in_samples = geometry(spec)
        self.out_rate = out_rate
        self.out_samples = self.in_samples * out_rate // spec.sample_rate
        # identity-rate DFPWM lanes run the fused decode+DSP kernel unless a
        # DSP stage is set: the float stream never touches device memory.
        # The smoothing carry is the lowpass state, so the fir state is
        # derived, not carried.
        self.fusable = spec.codec == "dfpwm" and spec.sample_rate == out_rate
        self.alpha = fir_alpha(spec.sample_rate, out_rate)
        self.io = _GroupIO(self.lanes, self.in_bytes)
        # a meshed group pads its device lanes to a multiple of the shards so
        # every group shards over the whole mesh; padded lanes are masked off
        # and dropped from the gathered output; host bookkeeping stays at the
        # real lane count. ``device`` is where outputs land (the mesh's first)
        self.device, self.pad, self.rows_per_shard, live = lane_layout(self.lanes, device, mesh)
        self.dlanes = self.lanes + self.pad
        self.shards = [_Shard(spec, dev, lo, hi, mono, self.out_ch) for dev, lo, hi in live]
        # per-lane volume: gain ramps linearly from gain0 to gain1 across each
        # lane's next chunk; gain0 == gain1 == 1 is the ungained stream
        self.gain0 = np.ones(self.dlanes, np.float32)
        self.gain1 = np.ones(self.dlanes, np.float32)
        # per-lane DSP stages at the lane's native rate (auplay.lua:20-31
        # order: mono -> normalize -> one-pole filter), host configuration:
        #  - lp_kind: 0 none, 1 lowpass (aukit.lua:3586), 2 highpass (:3604)
        #  - lp_a: the filter's alpha at the lane's native rate
        #  - norm_gain: whole-file normalize multiplier (``normalize``)
        #  - mono_sel: per-lane mono-mix toggle (mono=False engines)
        # the filter's carried y/x live on the shards' devices;
        # ``filt_started`` marks lanes whose recurrence has run (else
        # y[0] = x[0] on the next chunk)
        self.lp_kind = np.zeros(self.dlanes, np.int32)
        self.lp_a = np.zeros(self.dlanes, np.float32)
        self.norm_gain = np.ones(self.dlanes, np.float32)
        self.mono_sel = np.zeros(self.dlanes, bool)
        self.filt_started = np.zeros(self.dlanes, bool)
        self.samples_in = np.zeros(self.lanes, np.int64)  # input samples consumed
        self.samples_out = np.zeros(self.lanes, np.int64)  # output samples emitted
        # mixed-engine output FIFO (lockstep across the group's lanes).
        # ``spans`` are [start, end, ready_mask] column ranges relative to
        # the current front; ``skip`` is each lane's read cursor — normally
        # 0, set to the live fill by a mid-stream reset/restore so the lane's
        # stale undelivered columns are discarded instead of played
        self.fifo: torch.Tensor | None = None
        self.fill = 0
        self.spans: collections.deque[list] = collections.deque()
        self.skip = np.zeros(self.lanes, np.int64)

    def at(self, slot: int) -> tuple[_Shard, int]:
        """The shard holding a lane, and the lane's row in it."""
        sh = self.shards[slot // self.rows_per_shard]
        return sh, slot - sh.lo

    def _gathered(self, name: str) -> torch.Tensor:
        return gather_rows([getattr(sh, name) for sh in self.shards], self.device, self.lanes)

    # the carried tensors of every lane, gathered (read only: writes go to a shard's rows)
    fir = property(lambda self: self._gathered("fir"))
    filt_y = property(lambda self: self._gathered("filt_y"))
    filt_x = property(lambda self: self._gathered("filt_x"))

    @property
    def with_dsp(self) -> bool:
        """Whether any lane has a DSP stage set (the JAX step's variant key)."""
        return bool(self.lp_kind.any() or self.mono_sel.any() or (self.norm_gain != 1.0).any())

    def _rows(self, sh: _Shard, a: np.ndarray) -> torch.Tensor:
        """A shard's rows of a host per-lane array, on its device: a step's
        counted, traced copy (``_copy_in``)."""
        return _copy_in(self.metrics, a[sh.lo:sh.hi], sh.device)

    def _mix(self, f: torch.Tensor, msel: torch.Tensor) -> torch.Tensor:
        """The per-lane mono toggle of a per-channel block [L, C, T]: toggled
        lanes carry their channel mean on every channel."""
        return torch.where(msel[:, None, None], _mono(f)[:, None, :], f)

    def _stages(self, sh: _Shard, f: torch.Tensor):
        """The batched auplay chain on one shard's decoded floats [l, T] or
        [l, C, T]: mono toggle -> normalize gain -> one-pole filter as a
        linear recurrence (``linear_scan``), in the float operations of the
        JAX step (aukit_tpu/stream/batch.py:511-546). Returns (y, new filter
        y, new filter x) before masking."""
        bl = (slice(None), None) if self.mono else (slice(None), None, None)
        if not self.mono:
            f = self._mix(f, self._rows(sh, self.mono_sel))
        f = f * self._rows(sh, self.norm_gain)[bl]
        kind = self._rows(sh, self.lp_kind)
        a = self._rows(sh, self.lp_a)
        # per-sample-0 quantities broadcast one axis less than f
        wide = (lambda v: v) if self.mono else (lambda v: v[:, None])
        started = self._rows(sh, self.filt_started)
        k1w, k2w, aw, stw = wide(kind == 1), wide(kind == 2), wide(a), wide(started)
        sy, sx = sh.filt_y, sh.filt_x
        x0 = f[..., 0]
        # first-of-stream sample passes through (effects.lowpass / highpass
        # y[0] = x[0]); later chunks chain the carried state
        y0_lp = torch.where(stw, fma_kernel(1.0 - aw, sy, aw * x0), x0)
        y0_hp = torch.where(stw, aw * (sy + x0 - sx), x0)
        b0 = torch.where(k1w, y0_lp, torch.where(k2w, y0_hp, x0))
        kindb, ab = kind[bl], a[bl]
        # one A a lane, broadcast over the samples: the scan never reads
        # A[..., 0] into y (the JAX step zeroes it), so it is left as it is
        A = torch.where(kindb == 1, 1.0 - ab, torch.where(kindb == 2, ab, 0.0)).expand(f.shape)
        B = torch.where(kindb == 1, ab * f, f)
        if (self.lp_kind == 2).any():
            dx = torch.cat([torch.zeros_like(x0)[..., None], torch.diff(f, dim=-1)], dim=-1)
            B = torch.where(kindb == 2, ab * dx, B)
        B[..., 0] = b0
        y = linear_scan(A, B)
        return y, y[..., -1], f[..., -1]

    def _step(self, sh: _Shard, dev: torch.Tensor, ready: torch.Tensor, gain, with_dsp: bool):
        """One device step on one shard: int8[l, out_samples] (per channel
        int8[l, C, out_samples]); updates the shard's fir, filter carries and
        codec state. Masked lanes emit zeros and keep their fir, filter carry
        and codec state."""
        keep = ready if self.mono else ready[:, None]  # broadcasts over the fir's shape
        if self.fusable and not with_dsp:
            out, new_state = dfpwm_decode_dsp_kernel(dev, sh.state, self.alpha,
                                                     mask=ready, gain=gain)
            new_fir = norm8(new_state.lowpass)
            if not self.mono:  # per-channel contract: DFPWM lanes are C == 1
                out, new_fir = out[:, None, :], new_fir[:, None]
        else:
            f, new_state = self.decode(dev, sh.state)  # [l, T] or [l, C, T]
            if with_dsp:
                f, new_y, new_x = self._stages(sh, f)
                sh.filt_y = torch.where(keep, new_y, sh.filt_y)
                sh.filt_x = torch.where(keep, new_x, sh.filt_x)
            if gain is not None and not self.mono:
                gain = (gain[0][:, None], gain[1][:, None])
            out, new_fir = dsp_chain(f, self.spec.sample_rate, self.out_rate,
                                     fir_state=sh.fir, mode=self.mode, gain=gain)
            out = torch.where(keep[..., None], out, 0)
        sh.fir = torch.where(keep, new_fir, sh.fir)
        sh.state = new_state.where(ready, sh.state)
        return out

    def decode_once(self):
        """Stage + dispatch one chunk. Returns (out[lanes, T] on the group's
        device, ready, underrun) or None when no lane could produce."""
        with span("aukit.engine.stage", self.metrics):
            st = self.io.stage()
        if st is None:
            return None
        staged, ready, consumed, underrun = st
        self.metrics.bytes_staged += int(consumed.sum())
        self.metrics.lanes_ready += int(ready.sum())
        return self.dispatch(staged, ready, consumed), ready, underrun

    def dispatch(self, staged, ready: np.ndarray, consumed: np.ndarray) -> torch.Tensor:
        """Run one step of the staged bytes ``uint8[lanes, in_bytes]`` on
        every shard and advance the lanes' input counts; returns the output
        gathered in lane order on the group's device."""
        gain = None
        if (self.gain0 != 1.0).any() or (self.gain1 != 1.0).any():
            # volume ramp: slope per output sample across this chunk's
            # nominal window; once a lane decodes, its ramp completes
            gain = (self.gain0, (self.gain1 - self.gain0) / np.float32(self.out_samples))
        with_dsp = self.with_dsp
        ready_p = np.pad(ready, (0, self.pad)) if self.pad else ready
        outs = []
        for sh in self.shards:
            dev = _copy_in(self.metrics, padded_rows(staged, sh.lo, sh.hi), sh.device)
            ready_dev = self._rows(sh, ready_p)
            gain_dev = None if gain is None else tuple(self._rows(sh, v) for v in gain)
            with span("aukit.engine.launch", self.metrics):
                outs.append(self._step(sh, dev, ready_dev, gain_dev, with_dsp))
        n = self.lanes
        if gain is not None:
            self.gain0[:n] = np.where(ready, self.gain1[:n], self.gain0[:n])
        if with_dsp:
            # only filtered lanes have warmed their recurrence: a lane that
            # merely rode a DSP-active step (normalize-only, say) still gets
            # y[0] = x[0] when a filter is enabled on it later
            self.filt_started[:n] |= ready & (self.lp_kind[:n] != 0)
        self.samples_in += np.where(ready, (consumed * self.in_samples) // self.in_bytes, 0)
        return gather_rows(outs, self.device, n)

    def measure_peaks(self) -> np.ndarray:
        """The normalize measuring pass: decode a snapshot of the buffered
        bytes from a fresh zero codec state, apply the per-lane mono toggle,
        and reduce each ready lane's peak |x| on its shard's device. Returns
        float64[lanes] peaks; the live buffers and state are untouched."""
        io = self.io.snapshot()
        states = [init_state(self.spec, sh.hi - sh.lo, sh.device) for sh in self.shards]
        peaks = [torch.zeros(sh.hi - sh.lo, dtype=torch.float32, device=sh.device)
                 for sh in self.shards]
        while (st := io.stage()) is not None:
            staged, ready, _consumed, _underrun = st
            ready_p = np.pad(ready, (0, self.pad)) if self.pad else ready
            for i, sh in enumerate(self.shards):
                ready_dev = _to_device(ready_p[sh.lo:sh.hi], sh.device)
                f, new_state = self.decode(_to_device(padded_rows(staged, sh.lo, sh.hi),
                                                      sh.device), states[i])
                if not self.mono:
                    f = self._mix(f, _to_device(self.mono_sel[sh.lo:sh.hi], sh.device))
                    m = f.abs().amax(dim=(-2, -1))
                else:
                    m = f.abs().amax(dim=-1)
                peaks[i] = torch.maximum(peaks[i], torch.where(ready_dev, m, 0.0))
                states[i] = new_state.where(ready_dev, states[i])
        return gather_rows(peaks, self.device, self.lanes).cpu().numpy().astype(np.float64)

    # -- mixed-engine FIFO (device-resident) --------------------------------------
    def fifo_push(self, out_dev: torch.Tensor, ready: np.ndarray):
        if self.fifo is None or self.fill == 0:
            self.fifo = out_dev
        else:
            self.fifo = _dev_push(self.fifo, out_dev)
        self.spans.append([self.fill, self.fill + out_dev.shape[-1], ready])
        self.fill += out_dev.shape[-1]

    def silence(self, count: int) -> torch.Tensor:
        """An all-zero window of ``count`` samples in the group's shape."""
        shape = (self.lanes, count) if self.mono else (self.lanes, self.out_ch, count)
        return torch.zeros(shape, dtype=torch.int8, device=self.device)

    def fifo_pop(self, count: int):
        """Pop ``count`` samples (zero-padded if short). Returns
        (int8[L, count] or int8[L, C, count] device tensor, had_real bool[L]
        host). Lane l reads its window at its own cursor
        [skip[l], skip[l]+count)."""
        take = min(count, self.fill)
        smax = int(self.skip.max())
        if take == 0:
            window = self.silence(count)
        elif smax == 0:
            window, self.fifo = _dev_pop(self.fifo, take, count)
        else:
            skip_dev = _copy_in(self.metrics, self.skip, self.device)
            window, self.fifo = _dev_pop_skip(self.fifo, skip_dev, take, count, smax)
        self.fill -= take
        # per-lane real-audio accounting: a span contributes to lane l iff
        # it overlaps the lane's own read range
        had_real = np.zeros(self.lanes, bool)
        lo = self.skip
        for start, end, mask in self.spans:
            had_real |= mask & (lo < end) & (lo + count > start)
        for sp in self.spans:
            sp[0] -= take
            sp[1] -= take
        while self.spans and self.spans[0][1] <= 0:
            self.spans.popleft()
        if self.fill == 0:  # fully drained: rebase every cursor
            self.fifo = None
            self.skip[:] = 0
            self.spans.clear()
        self.samples_out += np.where(had_real, count, 0)
        return window, had_real


def engine_device(device, mesh, use_pallas, who: str) -> torch.device:
    """An engine's device, with the JAX package's ``mesh`` and
    ``use_pallas`` slots. With a mesh (``parallel.pipeline.make_mesh``; any
    other object raises TypeError) the engine's outputs land on the mesh's
    first device, and ``device`` must name that device or its type
    (ValueError). ``use_pallas=False`` (the plain versions) is refused on a
    card."""
    if mesh is not None:
        first = check_mesh(mesh, who).first
        want = torch.device(device)
        if want.type != first.type or want.index not in (None, first.index):
            raise ValueError(f"{who}(device={str(want)!r}) conflicts with the mesh, whose "
                             f"outputs land on {first}")
        device = first
    device = require_device(device, who)
    if use_pallas is False and device.type == "cuda":
        raise ValueError(f"{who}(use_pallas=False): on a card the port launches its CUDA "
                         "kernels; pass device='cpu' for their plain versions")
    return device


class BatchStreamEngine:
    """Fixed-lane batched decoder of any ``LaneSpec`` codec to 48 kHz int8,
    on one device or sharded over a mesh.

    Parameters
    ----------
    specs : one LaneSpec per lane (lanes with equal specs share a group)
    mesh : optional ``parallel.pipeline.make_mesh`` mesh: every group's lanes
        shard over all of it (each group pads to a multiple of its shards),
        each shard steps its rows on its device, and windows are gathered
        on the mesh's first device
    use_pallas : the JAX package's kernel switch; None or True launch the
        CUDA kernels on a card (their plain versions on the CPU), False runs
        the plain versions and is refused on a card
    mono : True (default) mixes every lane to mono windows ``int8[L, T]``;
        False keeps the decoded channels: windows become ``int8[L, C, T]``
        with C the fleet's largest channel count, and lanes with fewer
        channels replicate channel 0
    windowed : None (default) emits uniform 1-second windows only for
        heterogeneous fleets (homogeneous engines emit raw decode chunks);
        True forces the windowed contract even for a single group
    interpolation : resample mode override (none/linear/cubic/sinc); None
        reads CONFIG.default_interpolation at construction
    device : keyword only: torch device the decode runs on; "cuda" (the
        default) raises at construction when no CUDA device is present; with
        a mesh, the type (or the device) of its first device
    """

    def __init__(self, specs: Sequence[LaneSpec], mesh=None, use_pallas: bool | None = None,
                 mono: bool = True, windowed: bool | None = None,
                 interpolation: str | None = None, *, device="cuda"):
        specs = list(specs)
        if not specs:
            raise ValueError("need at least one lane")
        self.device = device = engine_device(device, mesh, use_pallas, "BatchStreamEngine")
        self.mesh = mesh
        self.lanes = len(specs)
        self.specs = specs
        self.mono = mono
        self.out_channels = 1 if mono else max(s.channels for s in specs)
        by_spec: dict[LaneSpec, list[int]] = {}
        for i, s in enumerate(specs):
            by_spec.setdefault(s, []).append(i)
        self.heterogeneous = (len(by_spec) > 1 if windowed is None
                              else bool(windowed) or len(by_spec) > 1)
        if len(by_spec) > 1:
            for s in by_spec:
                if s.chunk_bytes:
                    raise ValueError("chunk_bytes overrides require a homogeneous engine")
        self.interpolation = get_interpolation(interpolation)
        self.metrics = BatchMetrics()
        self.groups = [_Group(s, np.array(slots), device, CONFIG.output_rate,
                              mono=mono, mode=self.interpolation, mesh=mesh,
                              metrics=self.metrics)
                       for s, slots in by_spec.items()]
        self._lane_map: list[tuple[int, int]] = [None] * self.lanes  # lane -> (gi, slot)
        for gi, g in enumerate(self.groups):
            for slot, lane in enumerate(g.slots):
                self._lane_map[lane] = (gi, slot)
        # engine lane -> row in the concat of the groups' windows
        row = np.zeros(self.lanes, np.int64)
        base = 0
        for g in self.groups:
            row[g.slots] = base + np.arange(g.lanes)
            base += g.lanes
        self._inv_perm_dev = torch.tensor(row, device=device)

    # -- ingestion ---------------------------------------------------------------
    def feed(self, lane: int, data: bytes | None):
        """Append bytes to a lane's buffer; None marks end-of-stream."""
        gi, slot = self._lane_map[lane]
        self.groups[gi].io.feed_lane(slot, data)

    def feed_many(self, datas: Sequence[bytes | None]):
        with span("aukit.engine.feed", self.metrics):
            for lane, d in enumerate(datas):
                self.feed(lane, d)

    def feed_array(self, arr, eof: bool = True):
        """Bulk ingestion: ``uint8[L, B]`` rows in engine lane order, numpy or
        a torch tensor (a tensor on the engine's device keeps staging on the
        device). Bulk-fed groups stage chunks as column views."""
        if isinstance(arr, (bytes, bytearray, list, tuple)):
            arr = np.asarray(arr)
        if arr.shape[0] != self.lanes:
            raise ValueError(f"feed_array rows {arr.shape[0]} != lanes {self.lanes}")
        with span("aukit.engine.feed", self.metrics):
            for g in self.groups:
                rows = arr[g.slots] if len(self.groups) > 1 else arr
                if isinstance(rows, np.ndarray):
                    rows = np.ascontiguousarray(rows)
                g.io.feed_bulk(rows, eof)

    def set_volume(self, lane: int, volume: float, ramp: bool = False):
        """Per-lane playback volume: the smoothed float stream scales by
        ``volume`` before the int8 quantize (inside the fused kernel on the
        identity-rate route). With ``ramp=True`` the gain moves linearly from
        its current value to ``volume`` across the lane's next chunk."""
        gi, slot = self._lane_map[lane]
        g = self.groups[gi]
        if not ramp:
            g.gain0[slot] = volume
        g.gain1[slot] = volume

    def get_volume(self, lane: int) -> float:
        gi, slot = self._lane_map[lane]
        return float(self.groups[gi].gain1[slot])

    # -- per-lane DSP stages (the batched auplay chain) -----------------------
    def set_filter(self, lane: int, kind: str | None, cutoff: float = 0.0):
        """Per-lane one-pole filter at the lane's native rate, applied to the
        decoded float stream before the playback resample. The stage order
        is auplay's (mono -> normalize -> filter, auplay.lua:20-31), but
        auplay filters after its 48 kHz resample: here ``cutoff`` is read
        against the lane's native rate, as solo ``effects.lowpass`` at that
        rate would. ``kind`` is "lowpass" (aukit.lua:3586) or "highpass"
        (aukit.lua:3604); None clears the filter. A (re)configured filter
        starts a fresh recurrence: its first sample passes through."""
        gi, slot = self._lane_map[lane]
        g = self.groups[gi]
        rate = g.spec.sample_rate
        if kind is None:
            g.lp_kind[slot], g.lp_a[slot] = 0, 0.0
        elif kind == "lowpass":
            g.lp_kind[slot] = 1
            g.lp_a[slot] = 1.0 - np.exp(-(cutoff / rate) * 2.0 * np.pi)
        elif kind == "highpass":
            g.lp_kind[slot] = 2
            g.lp_a[slot] = 1.0 / (2.0 * np.pi * (cutoff / rate) + 1.0)
        else:
            raise ValueError(f"unknown filter kind {kind!r}")
        g.filt_started[slot] = False
        sh, row = g.at(slot)
        sh.filt_y[row] = 0.0
        sh.filt_x[row] = 0.0

    def set_mono(self, lane: int, on: bool = True):
        """Per-lane mono-mix toggle for ``mono=False`` engines: the lane's
        decoded channels are replaced by their mean on every channel (the
        batched Audio:mono, aukit.lua:685-687). Mono engines' windows are
        already mixed."""
        gi, slot = self._lane_map[lane]
        self.groups[gi].mono_sel[slot] = bool(on)

    def normalize(self, peak: float = 0.8):
        """Whole-file per-lane normalize (the batched effects.normalize(peak),
        aukit.lua:3431; auplay's normalize(0.8) stage): a measuring pass
        decodes a snapshot of the buffered bytes, takes each lane's peak after
        its mono toggle, and sets the lane's gain to ``peak / lane_peak``.
        Buffers, codec state and metrics are untouched. Requires every lane
        fed to EOF and no step taken yet."""
        for g in self.groups:
            if not g.io.eof.all():
                raise ValueError("normalize requires every lane fed to EOF")
            if g.fill or g.samples_in.any():
                raise ValueError("normalize must run before stepping")
        for g in self.groups:
            peaks = g.measure_peaks()
            g.norm_gain[:g.lanes] = np.where(peaks > 0, peak / peaks, 1.0).astype(np.float32)

    @property
    def active(self) -> np.ndarray:
        out = np.zeros(self.lanes, bool)
        for g in self.groups:
            out[g.slots] = ~g.io.eof | (g.io.available() > 0)
        return out

    @property
    def done(self) -> bool:
        return all(g.io.exhausted and g.fill == 0 for g in self.groups)

    # -- the batched step -----------------------------------------------------------
    def step(self):
        """Decode one chunk across all lanes.

        Returns (chunk, mask bool[L], positions float[L]) or None when every
        lane is finished/starved. ``mask`` marks lanes that produced real audio
        this step; ``positions`` are per-lane stream positions in seconds at
        chunk start. ``chunk`` is an int8 tensor on the engine's device:
        [L, out_samples] straight from the dispatch for homogeneous engines,
        [L, output_rate] windows assembled from per-group FIFOs for
        heterogeneous ones; with ``mono=False`` a channel axis rides in
        between ([L, C, ...]). Kernel launches are asynchronous, so staging the
        next chunk overlaps device compute."""
        if self.done:
            return None
        with span("aukit.engine.step", self.metrics):
            r = self._step_mixed() if self.heterogeneous else self._step_single()
            if r is None:
                return None
            chunk, mask, positions, nsamp = r
            self.metrics.steps += 1
            self.metrics.samples_decoded += int(mask.sum()) * nsamp
        return chunk, mask, positions

    def _step_single(self):
        g = self.groups[0]
        positions = g.samples_in / g.spec.sample_rate
        r = g.decode_once()
        if r is None:
            return None
        out, ready, underrun = r
        self.metrics.underruns += int(underrun)
        g.samples_out += np.where(ready, g.out_samples, 0)
        return out, ready, positions, g.out_samples

    def _step_mixed(self):
        out_rate = CONFIG.output_rate
        progressed = False
        for g in self.groups:
            # lanes whose cursor rides ahead (mid-stream reset) need the
            # FIFO to cover skip+window before a pop stays pad-free
            need = out_rate + int(g.skip.max())
            while g.fill < need:
                r = g.decode_once()
                if r is None:
                    break
                out, ready, underrun = r
                self.metrics.underruns += int(underrun)
                with span("aukit.engine.fifo", self.metrics):
                    g.fifo_push(out, ready)
                progressed = True
        if not progressed and all(g.fill == 0 for g in self.groups):
            return None
        mask = np.zeros(self.lanes, bool)
        positions = np.zeros(self.lanes, np.float64)
        windows = []
        with span("aukit.engine.fifo", self.metrics):
            for g in self.groups:
                positions[g.slots] = g.samples_out / out_rate
                need = out_rate + int(g.skip.max())
                if g.fill >= need or (g.io.exhausted and g.fill > 0):
                    got, had_real = g.fifo_pop(out_rate)
                else:
                    # starved (not exhausted): hold the partial FIFO — popping
                    # it now would zero-pad silence into the lane's timeline
                    got = g.silence(out_rate)
                    had_real = np.zeros(g.lanes, bool)
                if not self.mono:
                    got = _dev_padch(got, self.out_channels)
                windows.append(got)
                mask[g.slots] = had_real
            if not mask.any():
                return None
            return _dev_assemble(windows, self._inv_perm_dev), mask, positions, out_rate

    # -- checkpoint / resume ------------------------------------------------------------
    def checkpoint(self, lane: int) -> dict:
        """Serializable per-stream state, in the JAX engine's format (same
        keys, same numpy types): re-feeding bytes from ``byte_offset`` after
        ``restore`` resumes the stream exactly. Heterogeneous engines must
        checkpoint on a window boundary (an empty group FIFO)."""
        gi, slot = self._lane_map[lane]
        g = self.groups[gi]
        if self.heterogeneous and g.fill > 0:
            raise ValueError(
                "heterogeneous checkpoint requires a window boundary: the "
                f"lane's group FIFO holds {g.fill} undelivered samples "
                "(step() until the group drains, or checkpoint a finished lane)")
        sh, row = g.at(slot)
        return {
            "byte_offset": int(g.samples_in[slot] * g.in_bytes // g.in_samples),
            "pending": g.io.pending_bytes(slot),
            "eof": bool(g.io.eof[slot]),
            "codec_state": [np.int32(leaf[row].item()) for leaf in sh.state.leaves()],
            # mono: a float; mono=False: an f32[C] row
            "fir_state": self._row(sh.fir[row]),
            "volume": (float(g.gain0[slot]), float(g.gain1[slot])),
            "dsp": {
                "kind": int(g.lp_kind[slot]), "alpha": float(g.lp_a[slot]),
                "norm_gain": float(g.norm_gain[slot]),
                "mono": bool(g.mono_sel[slot]),
                "started": bool(g.filt_started[slot]),
                "y": self._row(sh.filt_y[row]), "x": self._row(sh.filt_x[row]),
            },
        }

    def _row(self, v: torch.Tensor):
        """A lane's row of a carried tensor: a float (mono) or f32[C]."""
        return float(v) if self.mono else v.cpu().numpy().copy()

    def restore(self, lane: int, ckpt: dict):
        """Restore one lane from a checkpoint of this engine or of the JAX
        engine (``aukit_tpu.stream.batch``). A live restore abandons the
        lane's undelivered group-FIFO columns: they belong to the old
        timeline."""
        gi, slot = self._lane_map[lane]
        g = self.groups[gi]
        g.skip[slot] = g.fill
        g.samples_in[slot] = ckpt["byte_offset"] * g.in_samples // g.in_bytes
        g.io.replace_lane(slot, ckpt["pending"], ckpt["eof"])
        # the lane's shard owns its state, fir and filter tensors (every step
        # makes new ones), so the lane's row is written in place; a stateless
        # codec's state has no leaves
        sh, row = g.at(slot)
        cs = ckpt.get("codec_state")  # None/absent -> zero the lane's state
        for i, leaf in enumerate(sh.state.leaves()):
            leaf[row] = int(cs[i]) if cs is not None else 0
        sh.fir[row] = self._lane_row(ckpt.get("fir_state", 0.0))
        g.gain0[slot], g.gain1[slot] = ckpt.get("volume", (1.0, 1.0))
        dsp = ckpt.get("dsp") or {}
        g.lp_kind[slot] = dsp.get("kind", 0)
        g.lp_a[slot] = dsp.get("alpha", 0.0)
        g.norm_gain[slot] = dsp.get("norm_gain", 1.0)
        g.mono_sel[slot] = dsp.get("mono", False)
        g.filt_started[slot] = dsp.get("started", False)
        sh.filt_y[row] = self._lane_row(dsp.get("y", 0.0))
        sh.filt_x[row] = self._lane_row(dsp.get("x", 0.0))

    @staticmethod
    def _lane_row(v) -> torch.Tensor:
        return torch.tensor(np.asarray(v, np.float32))

    def reset_lane(self, lane: int):
        """Reuse a finished lane for a new stream."""
        zero = {"byte_offset": 0, "pending": b"", "eof": False, "fir_state": 0.0,
                "codec_state": None}
        gi, slot = self._lane_map[lane]
        self.restore(lane, zero)
        self.groups[gi].samples_out[slot] = 0

    def lane_iterator(self, lane: int):
        """Generator of ``(chunk, position_seconds)`` for ONE lane (host numpy
        chunks; [C, T] with ``mono=False``). Iterating advances the WHOLE
        engine; use one consumer thread per engine. Live feeds keep iterating through starved steps until
        ``done``: a feed gap pauses the stream rather than ending it."""
        while True:
            r = self.step()
            if r is None:
                if self.done:
                    return
                time.sleep(0.005)  # starved, not done: await more feeds
                continue
            chunk, mask, pos = r
            if mask[lane]:
                yield chunk[lane].cpu().numpy(), float(pos[lane])


class BatchDfpwmDecoder(BatchStreamEngine):
    """A homogeneous engine over one byte codec: ``lanes`` mono streams of
    ``codec`` ("dfpwm", the default, or any other LaneSpec codec that needs
    no block_align) at ``sample_rate``, ``chunk_bytes`` input bytes per lane
    per step."""

    def __init__(self, lanes: int, sample_rate: int = 48000, chunk_bytes: int = 6000,
                 mesh=None, use_pallas: bool | None = None, codec: str = "dfpwm", *,
                 device="cuda"):
        spec = LaneSpec(codec, sample_rate, 1, chunk_bytes=chunk_bytes)
        super().__init__([spec] * lanes, mesh, use_pallas, device=device)
        self.sample_rate = sample_rate
        self.chunk_bytes = chunk_bytes
        self.codec = codec
