"""Batched multi-stream encoder engine — counterpart of
``aukit_tpu.stream.batch_encode``, the write path (the
reference's encode surface is Audio:pcm / Audio:wav / Audio:dfpwm,
aukit.lua:868-1018, and auconvert's decode -> write pipeline,
auconvert.lua:412-419).

 - **encode lane specs and groups**: every lane declares its target codec and
   channels (``EncodeSpec``: DFPWM, or little-endian WAV-layout PCM
   8/16/24/32); equal specs share one device dispatch per step;
 - **device-to-device glue**: ``encode_windows(windows, mask)`` consumes a
   decode engine's int8 window tensor without leaving device memory
   (``encode_windows_many`` runs several engines' calls side by side on CUDA
   streams: a port-only entry point, the JAX package leaves that to XLA). At gain
   1 the int8 -> target-int conversion is a lookup of the 256-entry table
   ``_int8_lut`` that replicates the solo chain (int8 bytes -> aukit.pcm 8-bit
   loader -> encodePCM in float64 -> trunc), so fleet transcodes are bit-equal
   to the solo writers;
 - **host float ingestion**: ``feed(lane, samples)`` takes [-1, 1] float
   chunks; the conversion to target ints happens at feed time in float64 on
   the host, the solo writers' own path;
 - DFPWM lanes encode through ``dfpwm_encode_kernel`` (the CUDA kernel on a
   CUDA tensor, its plain loop on the CPU) with the encoder state carried on
   the device; PCM lanes pack with torch ops;
 - per-lane serialisable **checkpoints** in the JAX engine's format (encoder
   state, cursors, gain, pending samples), so a checkpoint of either engine
   restores into the other; per-lane **gain** with the decode engine's linear
   ramp, applied in float32 before the target quantise;
 - multichannel lanes interleave frames on the device as the solo
   interleaved writers do: one encoder state per lane, not per channel.

Outputs per step: (bytes uint8[L, Bmax] tensor on the engine's device, nbytes
int64[L] valid bytes per lane, mask bool[L], positions float64[L] seconds at
chunk start). DFPWM lanes emit whole bytes only (aukit.lua:1009).

With a ``mesh`` (``parallel.pipeline.make_mesh``) every group pads its
lanes to a multiple of the mesh's shards, as the decode engine does: each
shard keeps its rows of the encoder state and encodes them on its device
(kernel (c) for DFPWM lanes), a window is split into the shards' rows where
it arrives, and the bytes are gathered on the mesh's first device.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..codecs.dfpwm import DfpwmState
from ..kernels.dfpwm_cuda import dfpwm_encode_kernel
from ..kernels.fma_cuda import fma_kernel
from ..ops.pcmcode import denormalize_pcm
from ..parallel.mesh import gather_rows, lane_layout, padded_rows
from ..utils.trace import span
from .batch import BatchMetrics, _copy_in, _GroupIO, engine_device
from .batch_codecs import NoState

__all__ = ["BatchDfpwmEncoder", "BatchEncodeEngine", "EncodeSpec", "ENCODE_CODECS",
           "encode_windows_many", "transcode_fleet"]


class BatchDfpwmEncoder:
    """Fixed-lane batched PCM8 -> DFPWM encoder.

    Feed signed 8-bit sample bytes per lane (``feed``/``feed_array``, the
    decode engine's ingestion surface, tensors on the device included); every
    ``step()`` consumes ``chunk_samples`` per ready lane and returns (bytes
    uint8[L, chunk_samples//8] on the device, mask, positions_seconds).
    Trailing partials are zero-padded to whole bytes (the reference encoder
    consumes whole bytes, aukit.lua:1009). ``use_pallas`` is the JAX
    package's kernel switch (False, the plain version, is refused on a
    card); ``device`` is keyword only, "cuda" by default.
    """

    def __init__(self, lanes: int, chunk_samples: int = 48000, use_pallas: bool | None = None,
                 *, device="cuda"):
        if chunk_samples % 8:
            raise ValueError("chunk_samples must be a multiple of 8")
        self.device = engine_device(device, None, use_pallas, "BatchDfpwmEncoder")
        self.lanes = lanes
        self.chunk_samples = chunk_samples
        self.io = _GroupIO(lanes, chunk_samples)  # 1 byte per sample (pcm8)
        self.state = DfpwmState.zeros(lanes, self.device)
        self.samples_in = np.zeros(lanes, np.int64)
        self.metrics = BatchMetrics()

    def feed(self, lane: int, data: bytes | None):
        self.io.feed_lane(lane, data)

    def feed_many(self, datas: Sequence[bytes | None]):
        for lane, d in enumerate(datas):
            self.feed(lane, d)

    def feed_array(self, arr, eof: bool = True):
        self.io.feed_bulk(arr, eof)

    @property
    def done(self) -> bool:
        return self.io.exhausted

    def step(self):
        """Encode one chunk across all lanes, or None when finished/starved.
        Returns (dfpwm uint8[L, chunk//8] on the device, mask, positions).
        Masked lanes emit zeros and keep their state."""
        if self.done:
            return None
        m = self.metrics
        with span("aukit.engine.step", m):
            with span("aukit.engine.stage", m):
                st = self.io.stage()
            if st is None:
                return None
            staged, ready, consumed, underrun = st
            m.bytes_staged += int(consumed.sum())
            m.lanes_ready += int(ready.sum())
            positions = self.samples_in / 48000.0
            levels = _copy_in(m, staged, self.device).view(torch.int8)  # signed 8-bit samples
            ready_dev = _copy_in(m, ready, self.device)
            with span("aukit.engine.launch", m):
                enc, new_state = dfpwm_encode_kernel(levels, self.state)
                enc = torch.where(ready_dev[:, None], enc, 0)
                self.state = new_state.where(ready_dev, self.state)
            self.samples_in += np.where(ready, consumed, 0)
            m.steps += 1
            m.samples_decoded += int(ready.sum()) * self.chunk_samples
            m.underruns += int(underrun)
        return enc, ready, positions


# -- the generalised encode engine ---------------------------------------------------

_DEPTH = {"pcm8": 8, "pcm16": 16, "pcm24": 24, "pcm32": 32}
ENCODE_CODECS = ("dfpwm",) + tuple(_DEPTH)


@dataclasses.dataclass(frozen=True)
class EncodeSpec:
    """One encode lane's target format. ``pcm8`` is unsigned (the WAV
    convention, Audio:wav bit_depth=8); pcm16/24/32 are signed little-endian
    (aukit.lua:942 fmt layout). Lanes with equal specs share a group: one
    device dispatch per step."""

    codec: str
    channels: int = 1
    sample_rate: int = 48000  # bookkeeping (positions, WAV headers)

    def __post_init__(self):
        if self.codec not in ENCODE_CODECS:
            raise ValueError(f"unsupported encode codec {self.codec!r}")
        if self.channels < 1:
            raise ValueError("channels must be >= 1")


@functools.lru_cache(maxsize=16)
def _int8_lut(codec: str) -> np.ndarray:
    """int8 window value (+128) -> target int, replicating the solo chain
    exactly: int8 byte -> aukit.pcm 8-bit loader (float64 normalise, float32
    cast; ops/pcmcode.normalize_pcm) -> encodePCM float64 denormalise (the
    unsigned bias before the trunc, pack_pcm's order) -> trunc. The gain-1
    device path looks this table up; callers must not write to it."""
    w = np.arange(-128, 128, dtype=np.float64)
    d = (w / np.where(w < 0, 128.0, 127.0)).astype(np.float32).astype(np.float64)
    return float_to_target_ints(d, codec)


def float_to_target_ints(samples, codec: str) -> np.ndarray:
    """Host-side exact conversion: float [-1, 1] samples -> target ints via
    the solo writers' float64 path (encodePCM aukit.lua:868-874 numerics via
    ops/pcmcode.denormalize_pcm, the one place the unsigned-bias/trunc
    ordering lives; DFPWM levels per Audio:dfpwm, aukit.lua:1005). The
    int64 -> int32 cast wraps, as the reference's does (pcm32's +1.0)."""
    d = np.asarray(samples, dtype=np.float64)
    if codec == "dfpwm":
        scaled = denormalize_pcm(d, 8, "signed")
    else:
        b = _DEPTH[codec]
        scaled = denormalize_pcm(d, b, "unsigned" if b == 8 else "signed")
    return np.trunc(scaled).astype(np.int64).astype(np.int32)


class _EncShard:
    """One shard of an encode group: rows [lo, hi) of its padded lanes on
    ``device``, with their encoder state."""

    def __init__(self, device: torch.device, lo: int, hi: int, stateful: bool):
        self.device, self.lo, self.hi = device, lo, hi
        self.state = DfpwmState.zeros(hi - lo, device) if stateful else NoState()


class _EncGroup:
    """Encode lanes sharing one EncodeSpec: device step + host FIFO."""

    def __init__(self, spec: EncodeSpec, slots: np.ndarray, device: torch.device, chunk: int,
                 mesh=None, metrics: BatchMetrics | None = None):
        self.spec = spec
        self.metrics = BatchMetrics() if metrics is None else metrics  # the engine's
        self.slots = slots
        self.lanes = len(slots)
        self.chunk = chunk
        depth = _DEPTH.get(spec.codec, 8)
        self.bytes_per_frame = (spec.channels if spec.codec == "dfpwm"
                                else spec.channels * depth // 8)
        # one step's output width; DFPWM packs 8 interleaved levels per byte
        lv = chunk * spec.channels
        self.out_bytes = lv // 8 if spec.codec == "dfpwm" else lv * depth // 8
        if spec.codec == "dfpwm" and lv % 8:
            raise ValueError("dfpwm lanes need chunk*channels % 8 == 0")
        self.stateful = spec.codec == "dfpwm"
        # a meshed group pads its lanes to a multiple of the shards (masked
        # off, dropped from the output); ``device`` is where the bytes land
        # (the mesh's first)
        self.device, self.pad, self.rows_per_shard, live = lane_layout(self.lanes, device, mesh)
        self.dlanes = self.lanes + self.pad
        self.shards = [_EncShard(dev, lo, hi, self.stateful) for dev, lo, hi in live]
        # the lookup table on each shard's device; DFPWM levels fit int8,
        # the encode kernel's input type
        lut = torch.tensor(_int8_lut(spec.codec),
                           dtype=torch.int8 if self.stateful else torch.int32)
        self._luts = {t.device: t for t in (lut.to(sh.device) for sh in self.shards)}
        self._lut = lut.to(self.device)
        self.gain0 = np.ones(self.dlanes, np.float32)
        self.gain1 = np.ones(self.dlanes, np.float32)
        self.samples_in = np.zeros(self.lanes, np.int64)
        # host float-feed FIFO: per-lane deques of int32 [C, k] pending vals
        self.pend = [collections.deque() for _ in range(self.lanes)]
        self.sizes = np.zeros(self.lanes, np.int64)
        self.eof = np.zeros(self.lanes, bool)

    def at(self, slot: int) -> tuple[_EncShard, int]:
        """The shard holding a lane, and the lane's row in it."""
        sh = self.shards[slot // self.rows_per_shard]
        return sh, slot - sh.lo

    def codec_state(self, slot: int) -> tuple[tuple[torch.Tensor, ...], int]:
        """The encoder's state leaves holding a lane ((charge, strength,
        previous bit), or ()) and the lane's row in them."""
        sh, row = self.at(slot)
        return sh.state.leaves()[:3], row

    # -- the device step ------------------------------------------------------
    def _encode_core(self, sh: _EncShard, vals: torch.Tensor,
                     ready: torch.Tensor) -> torch.Tensor:
        """vals int [l, C, T] target ints of one shard -> bytes uint8[l, B];
        advances the shard's DFPWM state of ready lanes. Channels interleave
        per frame as in the solo interleaved writers (Audio:wav/Audio:dfpwm,
        aukit.lua:942/1005). Masked lanes emit zeros and keep their state."""
        lanes = vals.shape[0]
        flat = vals.movedim(1, 2).reshape(lanes, -1)  # frame-interleaved
        if self.stateful:
            if flat.dtype != torch.int8:
                # a level beyond int8 decides its bit as the nearest int8
                # level does (the charge stays within [-128, 127]), so the
                # int32 levels of an unclipped float feed narrow by clamping
                flat = flat.clamp(-128, 127).to(torch.int8)
            enc, new_state = dfpwm_encode_kernel(flat.contiguous(), sh.state)
            sh.state = new_state.where(ready, sh.state)
            return torch.where(ready[:, None], enc, 0)
        nb = _DEPTH[self.spec.codec] // 8
        # the low bytes of the two's-complement value, little-endian: pack_pcm
        out = flat.contiguous().view(torch.uint8).reshape(lanes, -1, 4)[..., :nb]
        return torch.where(ready[:, None], out.reshape(lanes, -1), 0)

    def _window_vals(self, x: torch.Tensor, gain) -> torch.Tensor:
        """int8 windows [l, C, T] -> target ints. Without gain: the table
        lookup, bit-equal to the solo writers. With ``gain = (g0, slope)``:
        the float32 path of the JAX engine's jitted step (normalise, the
        per-sample gain line, saturate, denormalise, truncate), with the
        multiply-adds that XLA fuses as ``fma_kernel`` calls: the ramp
        ``g0 + slope*t`` and, for pcm8, the ``d*127 + 128`` bias. The clip
        to [-1, 1] keeps |gain*x| > 1 from wrapping in the int cast."""
        if gain is None:
            return self._luts[x.device][x.to(torch.int32) + 128]
        depth = _DEPTH.get(self.spec.codec, 8)
        mv = 128.0 if self.spec.codec == "dfpwm" else float(1 << (depth - 1))
        top = float(np.float32(mv) - np.float32(1.0))  # 2**31 - 1 rounds to 2**31
        g0, gs = gain
        d = x.to(torch.float32) / torch.where(x < 0, 128.0, 127.0)
        t = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
        d = d * fma_kernel(gs[:, None, None], t, g0[:, None, None])
        d = d.clamp(-1.0, 1.0)
        w = torch.where(d < 0, mv, top)
        scaled = fma_kernel(d, w, mv) if self.spec.codec == "pcm8" else d * w
        # a float -> int32 cast saturates in XLA; torch's is undefined beyond
        # int32, so it goes through int64 (pcm32's +1.0 -> 2**31)
        return scaled.to(torch.int64).clamp(-(1 << 31), (1 << 31) - 1).to(torch.int32)

    def dispatch(self, x, ready: np.ndarray, kind: str) -> torch.Tensor:
        """Run one step on ``x`` [lanes, C, T]: "vals" (host-converted int32)
        or "win" (int8 windows, converted on the device), each shard on its
        rows; returns the bytes gathered on the group's device."""
        gain = None
        if kind == "win" and ((self.gain0 != 1.0).any() or (self.gain1 != 1.0).any()):
            gs = (self.gain1 - self.gain0) / np.float32(x.shape[-1])
            gain = (self.gain0, gs)
        ready_p = np.pad(ready, (0, self.pad)) if self.pad else ready
        outs = []
        m = self.metrics
        for sh in self.shards:
            dev = _copy_in(m, padded_rows(x, sh.lo, sh.hi), sh.device)
            ready_dev = _copy_in(m, ready_p[sh.lo:sh.hi], sh.device)
            # torch.tensor copies the host rows before it returns, so the
            # hand-over of gain0 below cannot race the transfer
            gain_dev = None if gain is None else tuple(_copy_in(m, v[sh.lo:sh.hi], sh.device)
                                                       for v in gain)
            with span("aukit.engine.launch", m):
                if kind == "win":
                    dev = self._window_vals(dev, gain_dev)
                outs.append(self._encode_core(sh, dev, ready_dev))
        if gain is not None:
            n = self.lanes
            self.gain0[:n] = np.where(ready, self.gain1[:n], self.gain0[:n])
        return gather_rows(outs, self.device, self.lanes)

    # -- host float FIFO ------------------------------------------------------
    def feed_lane(self, slot: int, samples):
        if samples is None:
            self.eof[slot] = True
            return
        s = np.atleast_2d(np.asarray(samples))
        if s.shape[0] != self.spec.channels:
            raise ValueError(
                f"lane expects {self.spec.channels} channels, got {s.shape[0]}")
        g = float(self.gain1[slot])
        if g != 1.0:  # host path: instantaneous gain at feed time (no ramp);
            # saturate like the device gain path (ungained feeds stay on the
            # solo writers' unclipped path for bit-equality)
            s = np.clip(s * g, -1.0, 1.0)
        self.pend[slot].append(float_to_target_ints(s, self.spec.codec))
        self.sizes[slot] += s.shape[1]

    def stage(self):
        """-> (vals int32[lanes, C, chunk], ready, consumed, underrun) or
        None. EOF tails zero-pad (DFPWM reports whole real bytes only)."""
        full = self.sizes >= self.chunk
        partial = self.eof & ~full & (self.sizes > 0)
        ready = full | partial
        if not ready.any():
            return None
        underrun = bool((~self.eof & ~full).any())
        staged = np.zeros((self.lanes, self.spec.channels, self.chunk), np.int32)
        consumed = np.zeros(self.lanes, np.int64)
        for slot in np.nonzero(ready)[0]:
            need = int(min(self.chunk, self.sizes[slot]))
            consumed[slot] = need
            at = 0
            dq = self.pend[slot]
            while at < need:
                head = dq[0]
                m = min(head.shape[1], need - at)
                staged[slot, :, at:at + m] = head[:, :m]
                if m == head.shape[1]:
                    dq.popleft()
                else:
                    dq[0] = head[:, m:]
                at += m
            self.sizes[slot] -= need
        return staged, ready, consumed, underrun

    @property
    def exhausted(self) -> bool:
        return bool(self.eof.all()) and not self.sizes.any()


class BatchEncodeEngine:
    """Fixed-lane batched float/int8 -> encoded-bytes engine, on one device
    or sharded over a mesh (see the module docstring).

    Parameters
    ----------
    specs : one EncodeSpec per lane (equal specs share a dispatch)
    chunk_samples : per-channel samples consumed per host-fed step (the
        window length for ``encode_windows`` is taken from the tensor)
    mesh : optional ``parallel.pipeline.make_mesh`` mesh: every group's lanes
        shard over all of it, the bytes are gathered on its first device
    use_pallas : the JAX package's kernel switch; None or True launch the
        CUDA kernels on a card, False runs the plain versions and is refused
        on a card
    device : keyword only: torch device the encode runs on; "cuda" (the
        default) raises at construction when no CUDA device is present
    """

    def __init__(self, specs: Sequence[EncodeSpec], chunk_samples: int = 48000,
                 mesh=None, use_pallas: bool | None = None, *, device="cuda"):
        specs = list(specs)
        if not specs:
            raise ValueError("need at least one lane")
        self.device = engine_device(device, mesh, use_pallas, "BatchEncodeEngine")
        self.mesh = mesh
        self._side_stream = None  # made by encode_windows_many on a CUDA device
        self.specs = specs
        self.lanes = len(specs)
        self.chunk_samples = chunk_samples
        by_spec: dict[EncodeSpec, list[int]] = {}
        for i, s in enumerate(specs):
            by_spec.setdefault(s, []).append(i)
        self.metrics = BatchMetrics()
        self.groups = [_EncGroup(s, np.array(slots), self.device, chunk_samples, mesh,
                                 self.metrics)
                       for s, slots in by_spec.items()]
        self._lane_map: list[tuple[int, int]] = [None] * self.lanes
        for gi, g in enumerate(self.groups):
            for slot, lane in enumerate(g.slots):
                self._lane_map[lane] = (gi, slot)
        row = np.zeros(self.lanes, np.int64)
        base = 0
        for g in self.groups:
            row[g.slots] = base + np.arange(g.lanes)
            base += g.lanes
        self._inv_perm = torch.tensor(row, device=self.device)
        self._slots_dev = [torch.tensor(g.slots, device=self.device) for g in self.groups]

    # -- ingestion ------------------------------------------------------------
    def feed(self, lane: int, samples):
        """Append float [-1, 1] samples ([T] or [C, T]) to a lane; None marks
        end-of-stream. Conversion to target ints happens here, in float64:
        the solo writers' exact path."""
        gi, slot = self._lane_map[lane]
        self.groups[gi].feed_lane(slot, samples)

    def feed_many(self, samples_list):
        for lane, s in enumerate(samples_list):
            self.feed(lane, s)

    def set_volume(self, lane: int, volume: float, ramp: bool = False):
        """Per-lane encode gain. On the window-glue path the gain applies on
        the device (float32, with the decode engine's linear ramp across the
        next window when ``ramp=True``); gain 1.0 keeps the bit-exact lookup.
        Host-fed lanes apply the instantaneous gain at feed time."""
        gi, slot = self._lane_map[lane]
        g = self.groups[gi]
        if not ramp:
            g.gain0[slot] = volume
        g.gain1[slot] = volume

    def get_volume(self, lane: int) -> float:
        gi, slot = self._lane_map[lane]
        return float(self.groups[gi].gain1[slot])

    @property
    def done(self) -> bool:
        return all(g.exhausted for g in self.groups)

    def _assemble(self, outs: list[torch.Tensor]) -> torch.Tensor:
        """Per-group byte rows -> uint8[L, Bmax] in engine lane order; rows of
        narrower groups are zero-padded."""
        bmax = max(out.shape[-1] for out in outs)
        padded = [out if out.shape[-1] == bmax else F.pad(out, (0, bmax - out.shape[-1]))
                  for out in outs]
        if len(padded) == 1:
            return padded[0]
        return torch.index_select(torch.cat(padded, dim=0), 0, self._inv_perm)

    # -- device-to-device glue ------------------------------------------------
    def encode_windows(self, windows, mask):
        """Encode one decode-engine window batch device-to-device: ``windows``
        is int8[L, T] (mono) or int8[L, C, T] in engine lane order (a tensor
        on the engine's device stays there: the decode engine's step output
        feeds straight in), ``mask`` bool[L] marks lanes with real audio.
        Returns (bytes uint8[L, Bmax] on the device, nbytes int64[L], mask,
        positions). Columns beyond a lane's nbytes are zero padding (groups
        differ in output width)."""
        with span("aukit.engine.step", self.metrics):
            mask = np.asarray(mask, bool)
            if not isinstance(windows, torch.Tensor):
                windows = torch.as_tensor(np.asarray(windows))
            if windows.dtype != torch.int8:
                raise ValueError(f"windows must be int8, got {windows.dtype}")
            if windows.dim() == 2:
                windows = windows[:, None, :]
            windows = windows.to(self.device)
            T = windows.shape[-1]
            outs = []
            nbytes = np.zeros(self.lanes, np.int64)
            positions = np.zeros(self.lanes, np.float64)
            for g, slots_dev in zip(self.groups, self._slots_dev):
                if windows.shape[1] != g.spec.channels:
                    raise ValueError(
                        f"window channels {windows.shape[1]} != lane spec "
                        f"channels {g.spec.channels}")
                rows = windows.index_select(0, slots_dev) if len(self.groups) > 1 else windows
                ready = mask[g.slots]
                self.metrics.lanes_ready += int(ready.sum())
                out = g.dispatch(rows, ready, "win")
                outs.append(out)
                lv = T * g.spec.channels
                width = lv // 8 if g.spec.codec == "dfpwm" else out.shape[-1]
                nbytes[g.slots] = np.where(ready, width, 0)
                # positions report the chunk-start second (the decode engines'
                # and step()'s convention), so decode and encode positions align
                positions[g.slots] = g.samples_in / g.spec.sample_rate
                g.samples_in += np.where(ready, T, 0)
            self.metrics.steps += 1
            self.metrics.samples_decoded += int(mask.sum()) * T
            return self._assemble(outs), nbytes, mask, positions

    # -- host-fed step ----------------------------------------------------------
    def step(self):
        """Encode one chunk across all host-fed lanes, or None when
        finished/starved. Returns (bytes uint8[L, Bmax] on the device, nbytes
        int64[L], mask, positions)."""
        if self.done:
            return None
        with span("aukit.engine.step", self.metrics):
            outs, masks = [], np.zeros(self.lanes, bool)
            nbytes = np.zeros(self.lanes, np.int64)
            positions = np.zeros(self.lanes, np.float64)
            any_ready = False
            for g in self.groups:
                positions[g.slots] = g.samples_in / g.spec.sample_rate
                with span("aukit.engine.stage", self.metrics):
                    st = g.stage()
                if st is None:
                    outs.append(torch.zeros((g.lanes, g.out_bytes), dtype=torch.uint8,
                                            device=self.device))
                    continue
                staged, ready, consumed, underrun = st
                any_ready = True
                self.metrics.underruns += int(underrun)
                self.metrics.bytes_staged += (int(consumed.sum()) * g.spec.channels
                                              * staged.itemsize)
                self.metrics.lanes_ready += int(ready.sum())
                outs.append(g.dispatch(staged, ready, "vals"))
                masks[g.slots] = ready
                lv = consumed * g.spec.channels
                nbytes[g.slots] = (lv // 8 if g.spec.codec == "dfpwm"
                                   else lv * g.bytes_per_frame // g.spec.channels)
                g.samples_in += consumed
            if not any_ready:
                return None
            self.metrics.steps += 1
            self.metrics.samples_decoded += int(masks.sum()) * self.chunk_samples
            return self._assemble(outs), nbytes, masks, positions

    # -- checkpoint / resume ------------------------------------------------------
    def checkpoint(self, lane: int) -> dict:
        """Serialisable per-lane state, in the JAX engine's format (same keys,
        same types)."""
        gi, slot = self._lane_map[lane]
        g = self.groups[gi]
        pend = (np.concatenate(list(g.pend[slot]), axis=1)
                if g.pend[slot] else np.zeros((g.spec.channels, 0), np.int32))
        leaves, row = g.codec_state(slot)
        return {
            "samples_in": int(g.samples_in[slot]),
            "codec_state": [int(leaf[row]) for leaf in leaves],
            "volume": (float(g.gain0[slot]), float(g.gain1[slot])),
            "pending": pend,
            "eof": bool(g.eof[slot]),
        }

    def restore(self, lane: int, ckpt: dict):
        """Restore one lane from a checkpoint of this engine or of the JAX
        engine (``aukit_tpu.stream.batch_encode``)."""
        gi, slot = self._lane_map[lane]
        g = self.groups[gi]
        g.samples_in[slot] = ckpt["samples_in"]
        # the lane's shard owns its state tensors (every step makes new
        # ones), so the lane's row is written in place
        leaves, row = g.codec_state(slot)
        cs = ckpt.get("codec_state") or [0] * len(leaves)
        for leaf, v in zip(leaves, cs):
            leaf[row] = int(v)
        g.gain0[slot], g.gain1[slot] = ckpt.get("volume", (1.0, 1.0))
        pend = np.asarray(ckpt.get("pending", np.zeros((g.spec.channels, 0), np.int32)))
        g.pend[slot] = collections.deque([pend] if pend.shape[1] else [])
        g.sizes[slot] = pend.shape[1]
        g.eof[slot] = ckpt.get("eof", False)

    def reset_lane(self, lane: int):
        self.restore(lane, {"samples_in": 0, "codec_state": None,
                            "volume": (1.0, 1.0), "eof": False})


def encode_windows_many(jobs):
    """``engine.encode_windows(windows, mask)`` for every ``(engine, windows,
    mask)`` of ``jobs``, in order -> the list of their results. The engines
    are independent (several encoders fed by one fleet's decode windows:
    mono DFPWM, stereo DFPWM, pcm16), and one engine's DFPWM encode kernel
    fills at most a warp a scheduler at fleet widths, so on a CUDA device each
    engine's work is queued on a side stream of its own, which first waits
    for the current stream; the current stream then waits for every side
    stream, so what the caller queues next sees all results, as after the
    calls in sequence. Bytes and state are the same either way; on the CPU
    the calls simply run in sequence."""
    jobs = list(jobs)
    if len(jobs) < 2 or any(eng.device.type != "cuda" for eng, _w, _m in jobs):
        return [eng.encode_windows(w, m) for eng, w, m in jobs]
    results, sides = [], []
    for eng, windows, mask in jobs:
        current = torch.cuda.current_stream(eng.device)
        if eng._side_stream is None:
            eng._side_stream = torch.cuda.Stream(eng.device)
        side = eng._side_stream
        side.wait_stream(current)
        with torch.cuda.stream(side):
            results.append(eng.encode_windows(windows, mask))
        sides.append((current, side))
    for current, side in sides:
        current.wait_stream(side)
    return results


def transcode_fleet(source, encoder: BatchEncodeEngine, max_steps: int = 1 << 20):
    """Drive a decode engine into a BatchEncodeEngine device-to-device
    (auconvert's decode -> write pipeline, auconvert.lua:333-419): every
    decode window feeds ``encode_windows`` without leaving device memory;
    encoded bytes are fetched once per step. ``source`` is a
    ``BatchStreamEngine`` or a ``Fleet`` (int8 windows) or a ``FlacFleet``,
    whose float int8-range windows quantise with the truncating int8 cast
    of the ``Fleet`` facade (``stream/fleet.py`` ``_dev_merge``). Returns
    per-lane ``bytes``. Final windows are zero-padded to the one-second
    window grid by the decode engines, so outputs may carry encoded trailing
    silence up to one window (the solo writers stop at the exact sample). A
    starved source that is not done is polled again, up to ``max_steps``
    times, as in the reference."""
    outs = [bytearray() for _ in range(encoder.lanes)]
    for _ in range(max_steps):
        if source.done:
            break
        r = source.step()
        if r is None:
            continue
        windows, mask, _pos = r
        if not isinstance(windows, torch.Tensor):
            windows = torch.as_tensor(np.asarray(windows))
        if windows.is_floating_point():
            windows = windows.clamp(-128.0, 127.0).to(torch.int8)
        out, nbytes, m2, _p = encoder.encode_windows(windows, mask)
        host = out.cpu().numpy()
        for i in np.nonzero(m2)[0]:
            outs[i].extend(host[i, : nbytes[i]].tobytes())
    return [bytes(o) for o in outs]
