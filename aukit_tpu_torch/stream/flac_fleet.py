"""Batched FLAC fleet — counterpart of ``aukit_tpu.stream.flac_fleet``: N
concurrent drip-fed FLAC streams decoded to 48 kHz int8-range windows, one
lane-batched LPC restore per step (the reference's network-streaming case,
``aukit.stream.flac``, aukit.lua:3115-3191).

Each step composes, per lane and then across lanes:

 1. **host parse, per lane**: the incremental frame walk (native C++
    ``flac_parse`` with ``end_pos``, else the Python BitReader) commits frames
    as soon as their bytes — including the CRC16 footer — have arrived; only
    the undecodable tail stays buffered, with the solo stream's stall bound;
 2. **one batched LPC restore** over every committed subframe of every lane;
 3. **DSP**: per-block resample with 2-sample history, the recursive
    lowpass chained block by block, the per-lane volume, the int8-range
    scale and (``mono=True``) the channel mean.

Three routes, as in the JAX package:

- **host** (``device_dsp=False``, the default): the native/numpy int64
  restore and float64 DSP, each lane bit-equal to the JAX fleet's host route
  and so to a solo ``stream.flac`` run. It runs no kernel, unless
  ``CONFIG.flac_device_restore_min`` sends a step's restore to kernel (g)
  (``device_restore=None`` on a CUDA ``device``), which gives the same
  samples.
- **staged device DSP** (``device_restore=False, device_dsp=True``): host
  restore, then the resample and the lowpass on the torch device, the
  lowpass through kernel (h) ``iir_zero_kernel``.
- **device resident** (``device_dsp=True`` and ``device_restore`` not
  False): lanes are grouped by geometry, and each uniform group runs the
  restore (kernel (g) ``lpc_restore_kernel``), wasted-bits shift, stereo
  decorrelation, sign wrap, normalise, resample, block lowpass (kernel (h)),
  cross-block chain, gain line and scale on the device, with no host
  transfer in between. Lanes whose frames are not uniform (short final
  frames, a change of block size, depth 32, blocks of 1 sample) take the
  staged or host route.

The device routes run on ``device``: on a card they launch the kernels; on
the CPU the kernels' plain versions run (the JAX package's interpret mode).
With a ``mesh`` (``parallel.pipeline.make_mesh``) the restore rows of a step
(every route, for streams of depth <= 24; an explicit ``device_restore=False``
keeps the host restore) and the block lowpass rows split over its shards,
each launching kernel (g) or (h) on its device with zero collectives; the
rest of a device step runs on the mesh's first device, ``device``.
Their float32 arithmetic follows the JAX package's jitted code as XLA
compiles it, fused multiply-adds included (``fma_kernel``), so their
windows equal the JAX device routes'; they are within 5e-3 of the host
route. Output contract: ``step()`` emits ``float32[L, output_rate]``
one-second windows (``float32[L, channels, output_rate]`` with
``mono=False``) with a per-lane real-audio mask and window start positions;
host arrays, as the JAX fleet returns them.
"""

from __future__ import annotations

import collections
import struct
import time

import numpy as np
import torch

from ..codecs import flac as flac_codec
from ..config import CONFIG, get_interpolation
from ..kernels.flac_cuda import lpc_restore_kernel, order_bucket
from ..kernels.fma_cuda import fma_kernel as fma
from ..kernels.iir_cuda import iir_zero_kernel
from ..ops.resample import block_interp_device
from ..parallel.mesh import Mesh, device_mesh, sharded_rows
from ..parallel.pipeline import fir_alpha
from .batch import BatchMetrics, engine_device
from .engine import block_resample_plan, iir_lowpass_scan, lua_block_resample

__all__ = ["FlacFleet"]

# undecodable bytes a lane may buffer before it is poisoned: the solo
# stream.flac's bound (aukit_tpu/stream/__init__.py _STALL_LIMIT)
_PULL_STALL_LIMIT = 8 << 20


def _fit_channels(arr: np.ndarray, cap: int) -> np.ndarray:
    """[C, T] -> [cap, T]: extra channels truncate, missing channels
    replicate channel 0 (the reference's ``chunk[i] or chunk[1]`` speaker
    fallback, aukit.lua:1935)."""
    C = arr.shape[0]
    if C == cap:
        return arr
    if C > cap:
        return arr[:cap]
    return np.concatenate(
        [arr, np.broadcast_to(arr[:1], (cap - C, arr.shape[1]))])


def _is_identity(n: int, out_len: int, ffx0, exact) -> bool:
    """Identity rate: every mode passes p1 through at exact x (aukit.lua:2397)."""
    return bool(out_len == n and exact.all() and (ffx0 == np.arange(n)).all())


def frames_to_float(restored: torch.Tensor, wasted: torch.Tensor, nsubs: int, asgn: int,
                    depth: int) -> torch.Tensor:
    """The integer stages after the restore, on the device: restored
    subframe rows int32[F * nsubs, n] (frame-major) and their wasted bits
    int32[F * nsubs] -> wasted-bits shift -> stereo decorrelation
    (aukit.lua:479-502) -> one-sided sign wrap -> f32[F, C, n] / 2^depth
    (exact: the integers fit float32's mantissa at depth <= 24)."""
    chans = (restored << wasted[:, None]).reshape(-1, nsubs, restored.shape[1])
    if asgn > 7:
        a, b = chans[:, 0], chans[:, 1]
        if asgn == 8:  # left/side
            b = a - b
        elif asgn == 9:  # side/right
            a = a + b
        else:  # mid/side
            right = a - (b >> 1)
            a, b = right + b, right
        chans = torch.stack([a, b], dim=1)
    half, full = 1 << (depth - 1), 1 << depth
    wrapped = torch.where(chans >= half, chans - full, chans)
    return wrapped.to(torch.float32) * (1.0 / (1 << depth))


def block_iir_scale(res: torch.Tensor, idx: np.ndarray, tvalid: np.ndarray,
                    state: np.ndarray, gains: np.ndarray, alpha: float, out_mode: str,
                    mesh: Mesh):
    """The block lowpass, chain, gain line and scale of one geometry group —
    ``_device_block_iir_scale_fn`` of the JAX package. ``res`` f32[P, C,
    out_len] resampled blocks on the device; ``idx`` int[Lb, m] each lane's
    block rows in time order (padding repeats row 0 and is never read back);
    ``tvalid`` int[Lb] valid samples per lane; ``state`` f32[Lb, C] lowpass
    states; ``gains`` f32[4, Lb] (g0, g1, done, span) per lane. Returns
    (scaled f32[Lb, (C,) m*out_len], new_state f32[Lb, C]) on the device.

    Every block runs the lowpass from zero state in one kernel (h) call a
    shard of ``mesh`` (its channel rows padded to a multiple of the shards;
    ``device_mesh`` for one call on ``res``'s device).
    Block r's incoming state then follows ``s_{r+1} = fin0_r + c^out_len *
    s_r`` (fin0: the zero-state block's last sample; the decay factor is
    usually exactly 0.0 in float32, and the chain a shift), and each block
    adds ``c^(t+1) * s_r``."""
    dev = res.device
    P, C, out_len = res.shape
    Lb, m = idx.shape
    c = np.float32(1.0 - alpha)
    decay = np.cumprod(np.full(out_len, c, dtype=np.float32), dtype=np.float32)  # c^(t+1)
    dN = float(decay[-1])
    y0 = sharded_rows(mesh, lambda rows: iir_zero_kernel(rows, alpha),
                      [res.reshape(P * C, out_len)], P * C).reshape(P, C, out_len)
    idx_t = torch.from_numpy(np.asarray(idx, np.int64)).to(dev)
    yb = y0[idx_t]  # [Lb, m, C, out_len]
    fb = y0[..., -1][idx_t]  # [Lb, m, C]
    s = torch.from_numpy(np.asarray(state, np.float32)).to(dev)
    if dN:
        s_in = []
        for r in range(m):
            s_in.append(s)
            s = fma(dN, s, fb[:, r])
        s_in = torch.stack(s_in, dim=1)
    else:  # c^out_len underflowed: the chain is a shift
        s_in = torch.cat([s[:, None], fb[:, :-1]], dim=1)
    y = fma(torch.from_numpy(decay).to(dev), s_in[..., None], yb)
    x2 = y.permute(0, 2, 1, 3).reshape(Lb, C, m * out_len)
    T = m * out_len
    last = torch.from_numpy(np.clip(np.asarray(tvalid, np.int64) - 1, 0, T - 1)).to(dev)
    new_state = x2.gather(-1, last[:, None, None].expand(Lb, C, 1))[..., 0]
    # volume AFTER the state read: the per-sample line g0 + (g1-g0)*min((done+t)/span, 1);
    # constant lanes carry (g, g, 1, 1), so the line is exactly g
    g0, g1, done, span = (torch.from_numpy(np.asarray(v, np.float32)).to(dev)[:, None]
                          for v in gains)
    t = torch.arange(T, dtype=torch.float32, device=dev)
    frac = torch.clamp_max((done + t) / span, 1.0)
    x2 = x2 * fma(g1 - g0, frac, g0)[:, None, :]
    scaled = torch.clamp(x2 * torch.where(x2 < 0, 128.0, 127.0), -128.0, 127.0)
    if out_mode == "mix":
        scaled = scaled.mean(dim=1)
    elif out_mode == "first":
        scaled = scaled[:, 0]
    return scaled, new_state


class _Lane:
    __slots__ = (
        "buf", "eof", "dirty", "ended", "error", "consumed", "pos",
        "rate", "channels", "depth", "num_samples", "meta", "alpha",
        "last", "ls", "fifo", "fill", "samples_out", "stalled_at", "gain",
        "gain0", "ramp_pos", "ramp_len",
    )

    def __init__(self):
        self.buf = bytearray()
        self.eof = False
        self.dirty = False
        self.ended = False  # no more frames will ever decode
        self.error: str | None = None
        self.consumed = 0  # committed stream bytes (deleted from buf)
        self.pos = 0  # parse offset within buf (fpos until first commit)
        self.rate = None  # header not yet parsed
        self.channels = 0
        self.depth = 0
        self.num_samples = 0
        self.meta: dict = {}
        self.alpha = 0.0
        self.last: np.ndarray | None = None  # [C, 2] f64 resample history
        self.ls: np.ndarray | None = None  # [C] f64 lowpass state
        self.fifo: collections.deque[np.ndarray] = collections.deque()
        self.fill = 0
        self.samples_out = 0
        self.stalled_at: int | None = None
        self.gain = 1.0  # per-lane volume (aukit.lua:1935 analog)
        self.gain0 = 1.0  # ramp start gain (== gain when not ramping)
        self.ramp_pos = 0  # decoded samples into the active ramp
        self.ramp_len = 0  # ramp span in output samples (0 = no ramp)


class FlacFleet:
    """Fixed-lane batched FLAC -> 48 kHz decoder (see module docstring).

    Parameters
    ----------
    lanes : number of concurrent streams
    device_restore : the batched LPC restore on ``device`` through kernel (g)
        (True), on the host (False), or the default (None): on the host and
        staged routes ``CONFIG.flac_device_restore_min`` decides
        (``codecs.flac.restore_flat``: kernel (g) when ``device`` is CUDA and
        a step's batch, subframes x largest block, reaches it; the host
        otherwise, and always at the field's default), on the
        device-resident route the device.
    mesh : optional ``parallel.pipeline.make_mesh`` mesh: the restore and the
        block lowpass rows shard over it (see the module docstring); the
        fleet's device routes run on its first device.
    device_dsp : run the DSP (and, unless ``device_restore=False``, the
        restore) on ``device``; see the module docstring for the routes.
    mono : True mixes windows to one channel; False keeps ``channels``.
    channels : the fleet's channel capacity with ``mono=False``.
    interpolation : resample mode, ``CONFIG.default_interpolation`` when None.
    device : torch device of the device routes. ``"cuda"`` without a card
        raises here when a device route is asked for; with a mesh, the type
        (or the device) of its first device.

    Each lane carries its own format (rate/channels/depth parsed from its own
    ``fLaC`` header), so a fleet may mix files freely; malformed lanes are
    poisoned individually (``lane_error``) and never affect the batch.
    """

    def __init__(self, lanes: int, device_restore: bool | None = None, mesh=None,
                 device_dsp: bool = False, mono: bool = True, channels: int = 2,
                 interpolation: str | None = None, device="cuda"):
        if lanes < 1:
            raise ValueError("need at least one lane")
        if mesh is not None:
            device = engine_device(device, mesh, None, "FlacFleet")
        self.mesh = mesh
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        if (self.device.type == "cuda" and (device_dsp or device_restore)
                and not torch.cuda.is_available()):
            raise RuntimeError("FlacFleet(device='cuda'): no CUDA device is available "
                               "for the device routes; pass device='cpu' for the "
                               "kernels' plain versions")
        self.lanes = lanes
        self.device_restore = device_restore
        # mono=False keeps the decoded channels: windows become
        # f32[L, channels, output_rate] per-channel chunks (the reference
        # contract aukit.lua:2223-2227); lanes with fewer channels replicate
        # channel 0, lanes with more truncate to the fleet capacity.
        self.mono = mono
        self.out_ch = 1 if mono else channels
        self.device_dsp = device_dsp
        self.mode = get_interpolation(interpolation)
        self.out_rate = CONFIG.output_rate
        self._lanes = [_Lane() for _ in range(lanes)]
        self.metrics = BatchMetrics()

    # -- ingestion -----------------------------------------------------------
    def feed(self, lane: int, data: bytes | None):
        """Append bytes to a lane; None marks end-of-stream."""
        ln = self._lanes[lane]
        if data is None:
            ln.eof = True
        else:
            ln.buf.extend(data)
        ln.dirty = True

    def feed_many(self, datas):
        for lane, d in enumerate(datas):
            self.feed(lane, d)

    # -- queries ---------------------------------------------------------------
    @property
    def done(self) -> bool:
        return all(ln.ended and ln.fill == 0 for ln in self._lanes)

    @property
    def active(self) -> np.ndarray:
        return np.array([not ln.ended or ln.fill > 0 for ln in self._lanes])

    def lane_error(self, lane: int) -> str | None:
        """Poison reason for an ended lane (None = healthy)."""
        return self._lanes[lane].error

    def set_volume(self, lane: int, volume: float, ramp: bool = False):
        """Per-lane playback volume (aukit.lua:1935 analog): the smoothed
        stream scales by ``volume`` after the filter-state read, before the
        int8-range scale — on every route. Takes effect from the next decoded
        block; volume 1.0 is bit-exactly the ungained stream.

        With ``ramp=True`` the gain moves linearly from its current
        (instantaneous, mid-ramp included) value to ``volume`` across the
        lane's next second of decoded output."""
        ln = self._lanes[lane]
        if ramp:
            ln.gain0 = self._instant_gain(ln)
            ln.ramp_pos = 0
            ln.ramp_len = self.out_rate
        else:
            ln.gain0 = float(volume)
            ln.ramp_pos = ln.ramp_len = 0
        ln.gain = float(volume)

    def get_volume(self, lane: int) -> float:
        return self._lanes[lane].gain

    @staticmethod
    def _instant_gain(ln: _Lane) -> float:
        if ln.ramp_len == 0 or ln.ramp_pos >= ln.ramp_len:
            return ln.gain
        frac = ln.ramp_pos / ln.ramp_len
        return ln.gain0 + (ln.gain - ln.gain0) * frac

    @staticmethod
    def _gain_params(ln: _Lane):
        """(g0, g1, done, span) describing the lane's gain over its next
        decoded samples: g(t) = g0 + (g1 - g0) * min((done + t) / span, 1).
        Constant lanes fold to (g, g, 1, 1) so the device expression yields
        exactly g (and exactly 1.0 for unity gain)."""
        if ln.ramp_len == 0 or ln.ramp_pos >= ln.ramp_len:
            return ln.gain, ln.gain, 1.0, 1.0
        return ln.gain0, ln.gain, float(ln.ramp_pos), float(ln.ramp_len)

    @staticmethod
    def _gain_vector(ln: _Lane, T: int) -> np.ndarray | float:
        """Per-sample f64 gains for the lane's next T decoded samples (a
        scalar when constant). Callers advance the ramp cursor via
        ``_advance_ramp`` afterwards."""
        g0, g1, done, span = FlacFleet._gain_params(ln)
        if g0 == g1:
            return g1
        t = np.arange(T, dtype=np.float64)
        frac = np.minimum((done + t) / span, 1.0)
        return g0 + (g1 - g0) * frac

    @staticmethod
    def _advance_ramp(ln: _Lane, n: int):
        if ln.ramp_len:
            ln.ramp_pos += int(n)
            if ln.ramp_pos >= ln.ramp_len:
                ln.gain0 = ln.gain
                ln.ramp_pos = ln.ramp_len = 0

    def lane_info(self, lane: int) -> dict | None:
        """(rate, channels, depth, length_seconds, metadata) once the lane's
        header has parsed; None before."""
        ln = self._lanes[lane]
        if ln.rate is None:
            return None
        return {
            "sampleRate": ln.rate, "channels": ln.channels,
            "bitDepth": ln.depth, "metadata": ln.meta,
            "length": ln.num_samples / ln.rate if ln.num_samples else None,
        }

    # -- per-step phases --------------------------------------------------------
    def _parse_header(self, ln: _Lane) -> bool:
        try:
            (ln.rate, ln.channels, ln.depth, ln.num_samples, ln.meta,
             ln.pos) = flac_codec.parse_flac_header(bytes(ln.buf))
        except (IndexError, struct.error):
            ln.rate = None
            if ln.eof:  # stream.flac raises here; a fleet lane is poisoned
                ln.ended, ln.error = True, "unexpected end of FLAC stream"
            return False
        except flac_codec.FlacError as e:
            ln.ended, ln.error = True, str(e)
            return False
        ln.alpha = fir_alpha(ln.rate, self.out_rate)
        ln.last = np.zeros((ln.channels, 2), np.float64)
        ln.ls = np.zeros(ln.channels, np.float64)
        return True

    def _parse_step(self):
        """Incremental frame parse on every dirty lane. Returns
        [(lane_idx, frame_meta, sub, coefs, values), ...] for lanes that
        committed frames this step (stream.flac frames() semantics,
        aukit.lua:3145-3151 + CRC-gated commits)."""
        parsed = []
        for li, ln in enumerate(self._lanes):
            if ln.ended or not ln.dirty:
                continue
            if ln.rate is None and not self._parse_header(ln):
                ln.dirty = False
                continue
            data_now = bytes(ln.buf)
            if ln.eof:
                # final pass: commit the tail frame even without CRC16 bytes
                fm, sub, coefs, values = flac_codec.parse_all_frames(
                    data_now, ln.pos, ln.channels, ln.depth, strict=False)
                end = len(data_now)
                ln.ended = True
            else:
                fm, sub, coefs, values, end = flac_codec.parse_all_frames(
                    data_now, ln.pos, ln.channels, ln.depth,
                    strict=False, incremental=True)
            ln.dirty = False
            if len(fm):
                del ln.buf[:end]
                ln.consumed += end
                ln.pos = 0
                ln.stalled_at = None
                parsed.append((li, fm, sub, coefs, values))
            elif not ln.ended:
                if ln.stalled_at is None:
                    ln.stalled_at = len(ln.buf)
                elif len(ln.buf) - ln.stalled_at > _PULL_STALL_LIMIT:
                    ln.ended, ln.error = True, "undecodable FLAC stream"
        return parsed

    def _device_full_step(self, parsed):
        """Device-resident step for ONE uniform geometry group (every lane's
        frames share rate, channels, depth <= 24, one block size n >= 2 and
        one channel assignment; ``_lane_geometry`` checks it): the JAX
        package's ``_device_decode_fn`` and ``_device_block_iir_scale_fn`` in
        one pass over device tensors — residuals -> restore (kernel g) ->
        wasted-bits shift -> decorrelation -> sign wrap -> normalise ->
        resample -> block lowpass (kernel h) -> chain -> gain -> scale. The
        host hands over parse output and reads back the windows, the lowpass
        states and the 2-sample resample tails. Returns {lane: f32[take]},
        or None when the geometry resamples to no output."""
        dev = self.device
        lanes = [p[0] for p in parsed]
        l0 = self._lanes[lanes[0]]
        rate, C, depth = l0.rate, l0.channels, l0.depth
        n, asgn = int(parsed[0][1][0, 0]), int(parsed[0][1][0, 1])
        out_len, ffx0, frac, exact, w = block_resample_plan(
            n, rate, self.out_rate, self.mode, CONFIG.sinc_window_size)
        if out_len == 0:
            return None
        nsubs = C if asgn <= 7 else 2
        orders = np.concatenate([p[2]["order"] for p in parsed])
        S = len(orders)
        F = S // nsubs

        K = order_bucket(int(orders.max()))
        meta = [np.ascontiguousarray(np.concatenate([p[2][k] for p in parsed]), np.int32)
                for k in ("shift", "wasted")]
        args = [np.concatenate([p[4] for p in parsed]).astype(np.int32).reshape(S, n),
                orders.astype(np.int32), meta[0], np.full(S, n, np.int32),
                np.concatenate([p[3] for p in parsed])[:, :K].astype(np.int32)]
        # one restore a shard; the frames are joined after the gather
        restored = sharded_rows(self.mesh or device_mesh(dev),
                                lambda *a: lpc_restore_kernel(*a, K=K), args, S)
        dec = frames_to_float(restored, torch.from_numpy(meta[1]).to(dev), nsubs, asgn, depth)
        fcounts = [len(p[1]) for p in parsed]
        fstarts = np.concatenate([[0], np.cumsum(fcounts)])
        if _is_identity(n, out_len, ffx0, exact):
            res = dec
        elif self.mode in ("none", "linear"):  # never reads the history columns
            res = block_interp_device(dec, n, 0, ffx0, frac, exact, self.mode, w)
        else:  # cubic / sinc: 2 history columns, the previous frame's tail
            first = np.zeros(F, bool)
            tails0 = np.zeros((F, C, 2), np.float32)
            for i, li in enumerate(lanes):
                first[fstarts[i]] = True
                tails0[fstarts[i]] = self._lanes[li].last
            prev = dec[torch.from_numpy(np.maximum(np.arange(F) - 1, 0)).to(dev), :, n - 2:]
            hist = torch.where(torch.from_numpy(first).to(dev)[:, None, None],
                               torch.from_numpy(tails0).to(dev), prev)
            res = block_interp_device(torch.cat([hist, dec], dim=-1), n, 2, ffx0, frac,
                                      exact, self.mode, w)
        tails = dec[..., n - 2:].cpu().numpy()
        for i, li in enumerate(lanes):
            self._lanes[li].last = tails[fstarts[i + 1] - 1].astype(np.float64)
        rows = {li: list(range(fstarts[i], fstarts[i + 1])) for i, li in enumerate(lanes)}
        return self._lowpass_scale(res, rows, out_len, C, float(l0.alpha))

    def _lowpass_scale(self, res: torch.Tensor, rows: dict, out_len: int, C: int,
                       alpha: float) -> dict:
        """``block_iir_scale`` over one geometry group's resampled blocks
        ``res`` f32[P, C, out_len], ``rows`` {lane: its block rows in time
        order}; updates each lane's lowpass state and volume ramp and
        returns {lane: scaled f32[(C,) T_l]} on the host."""
        lanes = list(rows)
        idx = np.zeros((len(lanes), max(map(len, rows.values()))), np.int64)
        tval = np.zeros(len(lanes), np.int64)
        ls = np.zeros((len(lanes), C), np.float32)
        gains = np.ones((4, len(lanes)), np.float32)
        for i, li in enumerate(lanes):
            idx[i, :len(rows[li])] = rows[li]
            tval[i] = len(rows[li]) * out_len
            ls[i] = self._lanes[li].ls
            gains[:, i] = self._gain_params(self._lanes[li])
        scaled, new_state = block_iir_scale(res, idx, tval, ls, gains, alpha, self._out_mode(C),
                                            self.mesh or device_mesh(self.device))
        scaled, new_state = scaled.cpu().numpy(), new_state.cpu().numpy()
        out = {}
        for i, li in enumerate(lanes):
            ln = self._lanes[li]
            ln.ls = new_state[i].astype(np.float64)
            out[li] = scaled[i][..., : tval[i]]
            self._advance_ramp(ln, int(tval[i]))
        return out

    def _out_mode(self, C: int) -> str:
        """Channel handling for the device scale stage: mono fleets mix
        (C > 1) or squeeze (C == 1); multichannel fleets keep the axis."""
        if not self.mono:
            return "multi"
        return "mix" if C > 1 else "first"

    def _lane_geometry(self, p):
        """(rate, channels, depth, block, chan_asgn) when EVERY frame a lane
        committed this step shares one device-eligible geometry, else None."""
        li, fm, sub = p[0], p[1], p[2]
        ln = self._lanes[li]
        if ln.depth > flac_codec.DEVICE_MAX_DEPTH or len(fm) == 0:
            return None
        n, asgn = int(fm[0, 0]), int(fm[0, 1])
        if n < 2 or not ((fm[:, 0] == n).all() and (fm[:, 1] == asgn).all()):
            return None
        if not (sub["block"] == n).all():
            return None
        return (ln.rate, ln.channels, ln.depth, n, asgn)

    def _decode_step(self, parsed):
        """One fleet-wide LPC restore, then per-lane decorrelate + batched
        rounds of resample/lowpass; scaled output lands in the lane FIFOs."""
        # the device-resident route: lanes partition into per-geometry
        # groups; non-uniform lanes fall back to the staged host path below
        if self.device_dsp and self.device_restore is not False:
            groups: dict[tuple, list] = {}
            residual = []
            for p in parsed:
                key = self._lane_geometry(p)
                if key is None:
                    residual.append(p)
                else:
                    groups.setdefault(key, []).append(p)
            for group in groups.values():
                dev_out = self._device_full_step(group)
                if dev_out is None:
                    residual.extend(group)
                    continue
                for li, samples in dev_out.items():
                    self._push_lane(self._lanes[li], samples)
            if not residual:
                return
            parsed = residual
        sub_all = {k: np.concatenate([p[2][k] for p in parsed])
                   for k in ("order", "shift", "wasted", "block")}
        coefs_all = np.concatenate([p[3] for p in parsed])
        values_all = np.concatenate([p[4] for p in parsed])
        depth_max = max(self._lanes[p[0]].depth for p in parsed)
        restored = flac_codec.restore_flat(
            sub_all, coefs_all, values_all, depth_max, device=self.device_restore,
            mesh=self.mesh if depth_max <= flac_codec.DEVICE_MAX_DEPTH else None, on=self.device)
        voffs = np.concatenate(
            [[0], np.cumsum([int(p[2]["block"].sum()) for p in parsed])])

        # per lane: decorrelate + normalize, then per-block resample extents
        # (history = previous block's tail — decoded data, no sequential dep)
        jobs: dict[tuple, list] = {}  # (n, rate, C) -> [(li, round, ext), ...]
        rounds: dict[int, list] = {}  # lane -> [None per block round]
        for k, (li, fm, sub, _c, _v) in enumerate(parsed):
            ln = self._lanes[li]
            raw = flac_codec.decorrelate_frames(
                fm, sub["block"], restored[voffs[k]:voffs[k + 1]],
                ln.channels, ln.depth)
            dec = raw.astype(np.float64) / (1 << ln.depth)
            sizes = fm[:, 0].astype(np.int64)
            rounds[li] = [None] * len(sizes)
            uniform = bool((sizes == sizes[0]).all()) and sizes[0] >= 2
            if uniform:
                n = int(sizes[0])
                padded = np.concatenate([ln.last, dec], axis=1)
                exts = np.lib.stride_tricks.sliding_window_view(
                    padded, n + 2, axis=1)[:, ::n].transpose(1, 0, 2)
                for r in range(len(sizes)):
                    jobs.setdefault((n, ln.rate, ln.channels), []).append(
                        (li, r, exts[r]))
                ln.last = dec[:, -2:].copy()
            else:
                hist = ln.last
                off = 0
                for r, n in enumerate(map(int, sizes)):
                    blk = dec[:, off:off + n]
                    off += n
                    jobs.setdefault((n, ln.rate, ln.channels), []).append(
                        (li, r, np.concatenate([hist, blk], axis=1)))
                    # stream.flac history rule incl. 1-sample blocks
                    # (aukit.lua:3189 analog)
                    hist = (blk[:, -2:] if n >= 2 else
                            np.concatenate([hist[:, -1:], blk], axis=1)[:, -2:])
                ln.last = hist.copy()

        if self.device_dsp and len(jobs) == 1:
            (n, rate, C), items = next(iter(jobs.items()))
            dev_out = self._device_dsp_step(n, rate, C, items)
            if dev_out is not None:
                for li, samples in dev_out.items():
                    self._push_lane(self._lanes[li], samples)
                return

        # resample every (lane, block) pair, batched per distinct geometry
        for (n, rate, _C), items in jobs.items():
            stk = np.stack([ext for _li, _r, ext in items])
            res = lua_block_resample(stk, 2, n, rate, self.out_rate, self.mode, hist=2)
            for (li, r, _ext), row in zip(items, res):
                rounds[li][r] = row

        # recursive lowpass in rounds: every lane's r-th block together, so
        # per-lane state chains block-by-block exactly like stream.flac
        max_rounds = max(len(v) for v in rounds.values())
        out_parts: dict[int, list] = {li: [] for li in rounds}
        for r in range(max_rounds):
            groups: dict[tuple, list] = {}
            for li, blocks in rounds.items():
                if r < len(blocks) and blocks[r].shape[-1]:
                    ln = self._lanes[li]
                    groups.setdefault((blocks[r].shape, ln.alpha), []).append(li)
            for (_shape, alpha), lis in groups.items():
                x = np.stack([rounds[li][r] for li in lis])
                st = np.stack([self._lanes[li].ls for li in lis])
                y, fs = iir_lowpass_scan(x, alpha, st)
                # per-lane volume AFTER the filter-state read, then the
                # int8-range scale + mono mean, batched over the whole group
                # (scale in f64, mean in f64, then the f32 cast; gain 1.0
                # multiplies exactly). Ramping lanes get a per-sample linear
                # gain line instead of the scalar (set_volume ramp=True).
                T_r = y.shape[-1]
                gv = [self._gain_vector(self._lanes[li], T_r) for li in lis]
                if all(np.isscalar(g) for g in gv):
                    y = y * np.array(gv)[:, None, None]
                else:
                    y = y * np.stack(
                        [np.broadcast_to(np.asarray(g, np.float64), (T_r,))
                         for g in gv])[:, None, :]
                for li in lis:
                    self._advance_ramp(self._lanes[li], T_r)
                scaled = np.clip(y * np.where(y < 0, 128.0, 127.0), -128, 127)
                if self.mono:
                    if scaled.shape[1] > 1:
                        scaled = scaled.mean(axis=1)
                    else:
                        scaled = scaled[:, 0]
                scaled = scaled.astype(np.float32)
                for i, li in enumerate(lis):
                    self._lanes[li].ls = fs[i]
                    out_parts[li].append(scaled[i])

        for li, parts in out_parts.items():
            if not parts:
                continue
            out = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=-1)
            self._push_lane(self._lanes[li], out)

    def _device_dsp_step(self, n: int, rate: int, C: int, items):
        """Single-geometry device DSP (the staged route): one float32
        resample over every (lane, block) pair, then the block lowpass,
        chain, gain and scale (``block_iir_scale``). Returns {lane: scaled
        f32[T_l]} or None when the geometry resamples to no output."""
        out_len, ffx0, frac, exact, w = block_resample_plan(
            n, rate, self.out_rate, self.mode, CONFIG.sinc_window_size)
        if out_len == 0:
            return None
        ext = torch.from_numpy(
            np.stack([e for _li, _r, e in items]).astype(np.float32)).to(self.device)
        if _is_identity(n, out_len, ffx0, exact):
            res = ext[..., 2:2 + out_len].contiguous()
        else:
            res = block_interp_device(ext, n, 2, ffx0, frac, exact, self.mode, w)
        per_lane: dict[int, list[tuple[int, int]]] = {}
        for k, (li, r, _e) in enumerate(items):
            per_lane.setdefault(li, []).append((r, k))
        rows = {li: [k for _r, k in sorted(per_lane[li])] for li in sorted(per_lane)}
        alpha = float(self._lanes[items[0][0]].alpha)  # one geometry -> one rate
        return self._lowpass_scale(res, rows, out_len, C, alpha)

    def _push_lane(self, ln: _Lane, samples: np.ndarray):
        """Append decoded samples to a lane FIFO: 1-D [T] for mono fleets,
        [C, T] fitted to the fleet's channel capacity otherwise."""
        if not self.mono:
            if samples.ndim == 1:
                samples = samples[None]
            samples = _fit_channels(samples, self.out_ch)
        ln.fifo.append(samples)
        ln.fill += samples.shape[-1]

    def _pop(self, ln: _Lane, out: np.ndarray) -> int:
        take = min(ln.fill, out.shape[-1])
        at = 0
        while at < take:
            head = ln.fifo[0]
            m = min(head.shape[-1], take - at)
            out[..., at:at + m] = head[..., :m]
            if m == head.shape[-1]:
                ln.fifo.popleft()
            else:
                ln.fifo[0] = head[..., m:]
            at += m
        ln.fill -= take
        return take

    # -- the batched step ---------------------------------------------------------
    def step(self):
        """Parse + decode newly fed bytes across all lanes, then emit one-second
        windows. Returns (window f32[L, output_rate] int8-range samples —
        f32[L, channels, output_rate] with ``mono=False`` — mask bool[L],
        positions f64[L] seconds at window start) or None when no lane can
        produce a window (starved mid-stream feeds hold their FIFO — audio is
        never zero-padded into a live lane's timeline)."""
        if self.done:
            return None
        t0 = time.perf_counter()
        parsed = self._parse_step()
        if parsed:
            self._decode_step(parsed)
        shape = ((self.lanes, self.out_rate) if self.mono
                 else (self.lanes, self.out_ch, self.out_rate))
        window = np.zeros(shape, np.float32)
        mask = np.zeros(self.lanes, bool)
        positions = np.zeros(self.lanes, np.float64)
        emitted = 0
        for li, ln in enumerate(self._lanes):
            positions[li] = ln.samples_out / self.out_rate
            if ln.fill >= self.out_rate or (ln.ended and ln.fill > 0):
                take = self._pop(ln, window[li])
                ln.samples_out += take
                mask[li] = True
                emitted += take
        self.metrics.steps += 1
        self.metrics.wall_seconds += time.perf_counter() - t0
        if not mask.any():
            self.metrics.underruns += int(not self.done)
            return None
        self.metrics.samples_decoded += emitted
        return window, mask, positions

    # -- checkpoint / resume -----------------------------------------------------
    def checkpoint(self, lane: int) -> dict:
        """Serializable per-stream state (numpy arrays, bytes and scalars,
        the JAX fleet's keys: either package restores the other's). Restore
        into a fresh lane and feed the source from byte ``byte_offset +
        len(pending)`` onward to resume bit-exactly (the FIFO remnant rides
        along, so any step boundary is a valid checkpoint).

        device_dsp carve-out: the device routes compute the resample history
        (``last``) and lowpass state (``ls``) in float32, so a checkpoint
        taken from a ``device_dsp=True`` fleet carries f32-rounded DSP state.
        Restoring it resumes within the device routes' tolerance (~1e-3 in
        int8-range units on the first resumed window), not bit-exactly.
        Host-route checkpoints are bit-exact."""
        ln = self._lanes[lane]
        return {
            "byte_offset": ln.consumed,
            "pending": bytes(ln.buf),
            "pos": ln.pos,
            "eof": ln.eof,
            "ended": ln.ended,
            "error": ln.error,
            "header": None if ln.rate is None else
                (ln.rate, ln.channels, ln.depth, ln.num_samples, dict(ln.meta)),
            "last": None if ln.last is None else ln.last.copy(),
            "ls": None if ln.ls is None else ln.ls.copy(),
            "fifo": np.concatenate(list(ln.fifo), axis=-1) if ln.fill else
                np.zeros(0, np.float32),
            "samples_out": ln.samples_out,
            "stalled_at": ln.stalled_at,
            "gain": ln.gain,
            "ramp": (ln.gain0, ln.ramp_pos, ln.ramp_len),
        }

    def restore(self, lane: int, ckpt: dict):
        ln = _Lane()
        ln.buf = bytearray(ckpt["pending"])
        ln.pos = ckpt["pos"]
        ln.consumed = ckpt["byte_offset"]
        ln.eof = ckpt["eof"]
        ln.ended = ckpt.get("ended", False)
        ln.error = ckpt.get("error")
        ln.dirty = (len(ln.buf) > 0 or ln.eof) and not ln.ended
        ln.stalled_at = ckpt.get("stalled_at")
        if ckpt["header"] is not None:
            ln.rate, ln.channels, ln.depth, ln.num_samples, ln.meta = ckpt["header"]
            ln.alpha = fir_alpha(ln.rate, self.out_rate)
            ln.last = np.array(ckpt["last"], np.float64)
            ln.ls = np.array(ckpt["ls"], np.float64)
        fifo = np.asarray(ckpt["fifo"], np.float32)
        if fifo.shape[-1]:
            ln.fifo.append(fifo.copy())
            ln.fill = fifo.shape[-1]
        ln.samples_out = int(ckpt["samples_out"])
        ln.gain = float(ckpt.get("gain", 1.0))
        ln.gain0, ln.ramp_pos, ln.ramp_len = ckpt.get("ramp", (ln.gain, 0, 0))
        self._lanes[lane] = ln

    def reset_lane(self, lane: int):
        """Reuse a finished lane for a new stream."""
        self._lanes[lane] = _Lane()
