"""One dispatch surface over the batched decode engines — counterpart of
``aukit_tpu.stream.fleet``.

The reference exposes a single stream dispatch: ``aukit.stream.wav`` walks the
container header and hands off to the matching ``stream.*`` decoder
(aukit.lua:2992-2996), so a caller never cares which codec a source uses. The
batched analog is ``Fleet``: stations of any supported source — raw codec
streams, WAV/AIFF/AU/QOA containers, MDFPWM, FLAC — decode concurrently
behind one feed/step/checkpoint/seek/metrics contract with one output dtype.

Internally a Fleet multiplexes the two batched engines:

 - non-FLAC stations become ``BatchStreamEngine`` lanes (container headers map
   through the ``lane_spec_for_*`` bridges; MDFPWM de-interleaves into two
   mono DFPWM lanes that re-merge at the station boundary);
 - FLAC stations become ``FlacFleet`` lanes (incremental parse + one batched
   LPC restore per step).

Output contract: ``step()`` -> (windows int8[N, T] — int8[N, C, T] with
``mono=False`` — mask bool[N], positions f64[N]), uniform one-second windows
across every station. ``windows`` is a tensor on the fleet's device: the
merge (``_dev_merge``: FLAC truncating int8 cast, MDFPWM L/R floor-mean,
channel fit, station permutation, mask) runs as torch ops there, so engine
windows never round-trip through the host.

Semantics notes (as the JAX package):
 - engine-lane stations run the engine DSP (``dsp_chain`` smoothing); MDFPWM
   stations therefore carry the engine's identity-rate smoothing rather than
   solo ``stream.mdfpwm``'s unsmoothed path. MDFPWM tails follow the loader's
   layout (aukit.lua:1430-1441): a final partial 12000-byte pair splits
   <= 6000 bytes to L then the remainder to R, each lane trimmed to
   length//2 bytes; a lane that ends first contributes zeros to the final
   mixed window;
 - container stations must present the full header in their construction
   bytes (aukit.lua:2929); later ``feed()`` bytes continue the same byte
   stream and are clipped to the container's declared data range.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import CONFIG
from ..utils.trace import span
from .batch import BatchMetrics, BatchStreamEngine, _dev_padch, engine_device
from .batch_codecs import (LaneSpec, lane_spec_for_aiff, lane_spec_for_au, lane_spec_for_qoa,
                           lane_spec_for_wav)
from .flac_fleet import FlacFleet

__all__ = ["Fleet"]


def _dev_fitch(w: torch.Tensor, cap: int) -> torch.Tensor:
    """[L, C, T] -> [L, cap, T]: extra channels truncate, missing channels
    replicate channel 0 (the batched ``chunk[i] or chunk[1]`` speaker
    fallback, aukit.lua:1935)."""
    if w.shape[1] > cap:
        return w[:, :cap]
    return _dev_padch(w, cap)


def _dev_merge(ew: torch.Tensor, fw: torch.Tensor, lidx: torch.Tensor, ridx: torch.Tensor,
               perm: torch.Tensor, mask: torch.Tensor, out_ch: int) -> torch.Tensor:
    """Both engines' windows -> station order on the device: FLAC f32
    windows quantize to int8 (clamp, then the truncating cast of the engine's
    ``dsp_chain``), MDFPWM stations floor-mean their L/R DFPWM lanes
    (``(l + r) >> 1``), every source fits the facade's channel capacity, a
    precomputed permutation gathers [engine lanes | FLAC lanes | MDFPWM
    merged] rows into station rows, and unready stations are zeroed.
    ``out_ch == 0`` selects the mono [N, T] layout."""
    fq = fw.clamp(-128.0, 127.0).to(torch.int8)
    if out_ch == 0:
        l = ew.index_select(0, lidx).to(torch.int32)
        r = ew.index_select(0, ridx).to(torch.int32)
        cat = torch.cat([ew, fq, ((l + r) >> 1).to(torch.int8)], dim=0)
        return torch.where(mask[:, None], cat.index_select(0, perm), 0)
    lc = ew[:, 0].index_select(0, lidx)  # DFPWM lanes are C == 1
    rc = ew[:, 0].index_select(0, ridx)
    md = _dev_fitch(torch.stack([lc, rc], dim=1), out_ch)
    cat = torch.cat([_dev_fitch(ew, out_ch), _dev_fitch(fq, out_ch), md], dim=0)
    return torch.where(mask[:, None, None], cat.index_select(0, perm), 0)


_PCM_CODEC = {
    ("signed", 8): "pcm8", ("unsigned", 8): "pcm8u",
    ("signed", 16): "pcm16", ("signed", 24): "pcm24",
    ("signed", 32): "pcm32", ("float", 32): "f32",
}


class _Station:
    __slots__ = ("kind", "lanes", "body_start", "body_end", "fed", "mdf_buf",
                 "mdf_per", "mdf_sent", "info", "src")

    def __init__(self, kind: str):
        self.kind = kind  # "engine" | "flac" | "mdfpwm"
        self.lanes: list[int] = []  # indices into the owning engine
        self.body_start = 0  # absolute stream offset of codec body
        self.body_end: int | None = None  # exclusive; None = unbounded
        self.fed = 0  # absolute bytes seen (incl. header)
        self.mdf_buf = bytearray()  # undelivered interleaved L/R blocks
        self.mdf_per = 0  # bytes per channel (MDFPWM length trim)
        self.mdf_sent = 0  # bytes delivered per lane so far
        self.info: dict = {}
        self.src: bytes | None = None  # retained source (eof stations; seek)


def _detect_station(data: bytes):
    """(kind, spec_or_None, body_start, body_end, info) for one source.

    Detection runs on the real construction bytes: the reference's
    headerless-PCM heuristic probes the head and the true tail
    (aukit.lua:2164-2191), so a PCM source classifies here exactly as
    ``detect_format`` classifies the whole file."""
    from ..containers.detect import detect_format

    kind, depth, dtype = detect_format(bytes(data))
    if kind == "wav":
        spec, off, size = lane_spec_for_wav(data)
        return "engine", spec, off, off + size, {}
    if kind == "aiff":
        spec, off, size = lane_spec_for_aiff(data)
        return "engine", spec, off, off + size, {}
    if kind == "au":
        spec, off, _size = lane_spec_for_au(data)
        return "engine", spec, off, None, {}
    if kind == "qoa":
        spec, off, _size = lane_spec_for_qoa(data)
        return "engine", spec, off, None, {}
    if kind == "flac":
        return "flac", None, 0, None, {}
    if kind == "mdfpwm":
        return "mdfpwm", None, 0, None, {}
    if kind == "dfpwm":
        return "engine", LaneSpec("dfpwm", 48000), 0, None, {}
    if kind == "pcm":
        codec = _PCM_CODEC.get((dtype, depth))
        if codec is None:
            raise ValueError(f"no fleet mapping for pcm {dtype}/{depth}")
        return "engine", LaneSpec(codec, 48000, 1), 0, None, {}
    raise ValueError(f"cannot detect source format ({kind!r})")


class Fleet:
    """Unified batched decoder over mixed sources (see module docstring).

    Parameters
    ----------
    sources : sequence of stations; each is raw ``bytes`` (format
        auto-detected, reference aukit.detect semantics) or an explicit
        ``(LaneSpec, bytes)`` pair. Construction bytes must include the
        container header; body bytes may keep arriving via ``feed``.
    eof : mark every station ended at construction (whole-file fleets);
        with ``eof=False`` call ``feed(i, None)`` per station when its
        source ends
    mono / channels : window channel contract (as BatchStreamEngine /
        FlacFleet: mono [N, T], else per-channel [N, channels, T])
    interpolation : resample mode override (none/linear/cubic/sinc) for both
        the FLAC lanes and the engine DSP
    use_pallas : the JAX package's kernel switch (``BatchStreamEngine``'s):
        None or True launch the CUDA kernels on a card, False runs the plain
        versions and is refused on a card
    device_restore / device_dsp : the FLAC lanes' routes (``FlacFleet``):
        ``device_dsp=True`` runs their restore and DSP on the device
    device : keyword only: torch device of both engines and of the windows;
        "cuda" (the default) raises when no CUDA device is present
    mesh : optional ``parallel.pipeline.make_mesh`` mesh, forwarded to both
        engines (their lanes shard over it); the windows and their merge are
        on its first device, ``device``
    """

    def __init__(self, sources, eof: bool = True, mesh=None, mono: bool = True,
                 channels: int = 2, interpolation: str | None = None,
                 use_pallas: bool | None = None, device_restore: bool | None = None,
                 device_dsp: bool = False, *, device="cuda"):
        self.device = device = engine_device(device, mesh, use_pallas, "Fleet")
        self.mono = mono
        self.out_ch = 1 if mono else channels
        self.out_rate = CONFIG.output_rate
        self.stations: list[_Station] = []
        specs: list[LaneSpec] = []
        initial: list[bytes] = []
        n_flac = 0
        # pass 1: detect formats and lay out lanes (headers only)
        for src in sources:
            if isinstance(src, tuple):
                spec, data = src
                data = bytes(data)
                st = _Station("engine")
                st.lanes = [len(specs)]
                specs.append(spec)
            else:
                data = bytes(src)
                kind, spec, off, end, info = _detect_station(data)
                st = _Station(kind)
                st.body_start, st.body_end, st.info = off, end, info
                if kind == "engine":
                    st.lanes = [len(specs)]
                    specs.append(spec)
                elif kind == "flac":
                    st.lanes = [n_flac]
                    n_flac += 1
                else:  # mdfpwm: two mono DFPWM lanes, merged at the station
                    st.mdf_per = self._mdfpwm_init(data, st)
                    st.lanes = [len(specs), len(specs) + 1]
                    specs.extend([LaneSpec("dfpwm", 48000, 1)] * 2)
            self.stations.append(st)
            initial.append(data)
        self.engine = None
        if specs:
            self.engine = BatchStreamEngine(specs, mesh, use_pallas=use_pallas, mono=mono,
                                            windowed=True, interpolation=interpolation,
                                            device=device)
        self._hop = BatchMetrics()  # the merge's own copies to the device
        self.flac = None
        if n_flac:
            self.flac = FlacFleet(n_flac, device_restore=device_restore, mesh=mesh,
                                  device_dsp=device_dsp, mono=mono, channels=channels,
                                  interpolation=interpolation, device=device)
        # device-merge plan: station i's window lives at row perm[i] of the
        # concat [engine lanes | FLAC lanes | MDFPWM merged]; mdf_l/mdf_r
        # list the engine lanes each MDFPWM station floor-means
        self._n_engine = len(specs)
        self._n_flac = n_flac
        perm = np.zeros(len(self.stations), np.int64)
        mdf_l: list[int] = []
        mdf_r: list[int] = []
        for i, st in enumerate(self.stations):
            if st.kind == "engine":
                perm[i] = st.lanes[0]
            elif st.kind == "flac":
                perm[i] = self._n_engine + st.lanes[0]
            else:
                perm[i] = self._n_engine + n_flac + len(mdf_l)
                mdf_l.append(st.lanes[0])
                mdf_r.append(st.lanes[1])
        self._perm = torch.tensor(perm, device=device)
        self._mdf_l = torch.tensor(mdf_l, dtype=torch.int64, device=device)
        self._mdf_r = torch.tensor(mdf_r, dtype=torch.int64, device=device)
        # pass 2: route every construction byte through the one feed path;
        # eof stations retain their source so seek()/reset_station() can
        # re-position without a rebuild (aukit.lua:2041-2056 Player seek)
        for i, data in enumerate(initial):
            if eof:
                self.stations[i].src = data
            self.feed(i, data)
            if eof:
                self.feed(i, None)

    def _mdfpwm_init(self, data: bytes, st: _Station) -> int:
        from ..containers.mdfpwm import parse_mdfpwm_header

        length, artist, title, album, hdr = parse_mdfpwm_header(data)
        st.body_start = hdr
        st.info = {"artist": artist, "title": title, "album": album, "length": length}
        return length // 2

    # -- ingestion -----------------------------------------------------------
    def feed(self, station: int, data: bytes | None):
        """Append source bytes to a station (None = end-of-stream). Bytes
        continue the same byte stream the construction data started."""
        st = self.stations[station]
        if st.kind == "flac":
            self.flac.feed(st.lanes[0], data)
            if data is not None:
                st.fed += len(data)
            return
        if st.kind == "mdfpwm":
            self._mdfpwm_feed(st, data)
            return
        lane = st.lanes[0]
        if data is None:
            self.engine.feed(lane, None)
            return
        # clip the feed to the container's declared body range
        lo, hi = st.fed, st.fed + len(data)
        st.fed = hi
        a = max(lo, st.body_start)
        b = hi if st.body_end is None else min(hi, st.body_end)
        if b > a:
            self.engine.feed(lane, data[a - lo: b - lo])

    def _mdfpwm_feed(self, st: _Station, data: bytes | None):
        if data is not None:
            lo = st.fed
            st.fed += len(data)
            a = max(lo, st.body_start)  # skip header bytes
            if a < st.fed:
                st.mdf_buf.extend(data[a - lo:])
            pairs = len(st.mdf_buf) // 12000
            if pairs:
                arr = np.frombuffer(bytes(st.mdf_buf[: pairs * 12000]),
                                    np.uint8).reshape(pairs, 2, 6000)
                del st.mdf_buf[: pairs * 12000]
                room = st.mdf_per - st.mdf_sent
                left = arr[:, 0].reshape(-1).tobytes()[:room]
                right = arr[:, 1].reshape(-1).tobytes()[:room]
                st.mdf_sent += len(left)
                if left:
                    self.engine.feed(st.lanes[0], left)
                    self.engine.feed(st.lanes[1], right)
            return
        # EOF: deliver the buffered tail split L/R (reference tail handling,
        # aukit.lua:1436-1441), then end both lanes
        tail = bytes(st.mdf_buf)
        st.mdf_buf.clear()
        room = st.mdf_per - st.mdf_sent
        left, right = tail[:6000], tail[6000:12000]
        if left[:room]:
            self.engine.feed(st.lanes[0], left[:room])
        if right[:room]:
            self.engine.feed(st.lanes[1], right[:room])
        self.engine.feed(st.lanes[0], None)
        self.engine.feed(st.lanes[1], None)

    # -- queries ---------------------------------------------------------------
    @property
    def done(self) -> bool:
        return all(sub is None or sub.done for sub in (self.engine, self.flac))

    @property
    def active(self) -> np.ndarray:
        eng = self.engine.active if self.engine is not None else None
        fl = self.flac.active if self.flac is not None else None
        out = np.zeros(len(self.stations), bool)
        for i, st in enumerate(self.stations):
            src = fl if st.kind == "flac" else eng
            out[i] = any(src[ln] for ln in st.lanes)
        return out

    def station_info(self, station: int) -> dict | None:
        st = self.stations[station]
        if st.kind == "flac":
            return self.flac.lane_info(st.lanes[0])
        return dict(st.info)

    def station_error(self, station: int) -> str | None:
        st = self.stations[station]
        if st.kind == "flac":
            return self.flac.lane_error(st.lanes[0])
        return None

    def station_iterator(self, station: int):
        """Generator of ``(chunk, position_seconds)`` for one station, host
        numpy chunks ([C, T] with ``mono=False``). Iterating advances the
        whole fleet; one consumer per Fleet. Live (eof=False) fleets keep
        iterating through starved steps until ``done``."""
        while True:
            r = self.step()
            if r is None:
                if self.done:
                    return
                time.sleep(0.005)  # starved, not done: await more feeds
                continue
            windows, mask, pos = r
            if mask[station]:
                # fetch only the consumed station's row to the host
                yield windows[station].cpu().numpy(), float(pos[station])

    # -- per-station playback controls ------------------------------------------
    def set_volume(self, station: int, volume: float, ramp: bool = False):
        """Per-station playback volume (aukit.lua:1935 analog). ``ramp=True``
        moves the gain click-free across the station's next second of
        output on every station kind."""
        st = self.stations[station]
        if st.kind == "flac":
            self.flac.set_volume(st.lanes[0], volume, ramp=ramp)
            return
        for ln in st.lanes:
            self.engine.set_volume(ln, volume, ramp=ramp)

    def set_filter(self, station: int, kind: str | None, cutoff: float = 0.0):
        """Per-station one-pole lowpass/highpass at the station's native rate
        (the auplay stage, auplay.lua:20-31); engine-backed stations only.
        FLAC stations raise: their DSP chain has no per-lane filter stage."""
        st = self.stations[station]
        if st.kind == "flac":
            raise ValueError("per-station filters are not supported on FLAC "
                             "stations (decode them via an engine lane, or "
                             "filter the fetched windows)")
        for ln in st.lanes:
            self.engine.set_filter(ln, kind, cutoff)

    def set_mono(self, station: int, on: bool = True):
        """Per-station mono-mix toggle (mono=False fleets); engine-backed
        stations only — FLAC stations raise."""
        st = self.stations[station]
        if st.kind == "flac":
            raise ValueError("per-station mono toggle is not supported on FLAC stations")
        for ln in st.lanes:
            self.engine.set_mono(ln, on)

    def normalize(self, peak: float = 0.8):
        """Whole-file normalize across every engine-backed station (the
        batched auplay normalize(0.8) stage). Fleets with FLAC stations
        raise: their whole-file peak is not measurable without a second
        parse pass."""
        if self.flac is not None:
            raise ValueError("normalize is not supported on fleets with FLAC stations")
        self.engine.normalize(peak)

    @property
    def metrics(self) -> BatchMetrics:
        """Both engines' counters added up (``steps``: the larger count),
        with the merge's copies of the FLAC windows and the station mask in
        ``htod_copies`` and ``htod_bytes``."""
        m = BatchMetrics()
        for sub in (self.engine, self.flac):
            if sub is None:
                continue
            for k, v in vars(sub.metrics).items():
                setattr(m, k, max(m.steps, v) if k == "steps" else getattr(m, k) + v)
        m.htod_copies += self._hop.htod_copies
        m.htod_bytes += self._hop.htod_bytes
        return m

    # -- the batched step ---------------------------------------------------------
    def step(self):
        """One batched step across every station. Returns (windows int8[N, T]
        or int8[N, C, T] on the fleet's device, mask bool[N], positions
        f64[N]) or None when no station can produce."""
        with span("aukit.fleet.step", self._hop):
            r = self._step()
        self._hop.steps += 1
        return r

    def _step(self):
        er = self.engine.step() if self.engine is not None else None
        fr = self.flac.step() if self.flac is not None else None
        if er is None and fr is None:
            return None
        N = len(self.stations)
        mask = np.zeros(N, bool)
        positions = np.zeros(N, np.float64)
        for i, st in enumerate(self.stations):  # host bookkeeping only
            if st.kind == "flac":
                if fr is not None:
                    positions[i] = fr[2][st.lanes[0]]
                    mask[i] = bool(fr[1][st.lanes[0]])
            elif er is not None:
                positions[i] = er[2][st.lanes[0]]
                if st.kind == "engine":
                    mask[i] = bool(er[1][st.lanes[0]])
                else:  # mdfpwm: ready when either L/R lane produced
                    mask[i] = bool(er[1][st.lanes[0]] or er[1][st.lanes[1]])
        if not mask.any():
            return None
        T, dev = self.out_rate, self.device
        if er is not None:
            ew = er[0]  # int8 [Le, T] / [Le, Ce, T] on the device (windowed mode)
        else:
            ce = self.engine.out_channels if self.engine is not None else 1
            ew = torch.zeros((self._n_engine, T) if self.mono else (self._n_engine, ce, T),
                             dtype=torch.int8, device=dev)
        hop = self._hop
        with span("aukit.fleet.htod", hop):
            if fr is not None:
                fw = torch.as_tensor(fr[0]).to(dev)  # the FLAC windows' one hop to the device
                hop.htod_copies += 1
                hop.htod_bytes += fr[0].nbytes
            else:
                fw = torch.zeros((self._n_flac, T) if self.mono
                                 else (self._n_flac, self.out_ch, T),
                                 dtype=torch.float32, device=dev)
            mask_dev = torch.tensor(mask, device=dev)
            hop.htod_copies += 1
            hop.htod_bytes += mask.nbytes
        windows = _dev_merge(ew, fw, self._mdf_l, self._mdf_r, self._perm, mask_dev,
                             0 if self.mono else self.out_ch)
        return windows, mask, positions

    # -- station lifecycle + seek ------------------------------------------------
    def reset_station(self, station: int, source=None, eof: bool = True):
        """Reuse a station's lane slots for a new source without rebuilding
        the fleet (a radio server rotates a finished station live).
        ``source`` is raw bytes or an explicit ``(LaneSpec, bytes)`` pair
        like the constructor; None replays the retained source from the
        start. The new source must keep the station's kind and lane spec."""
        st = self.stations[station]
        if isinstance(source, tuple):
            spec, data = source
            data = bytes(data)
            kind, off, end, info = "engine", 0, None, {}
        elif source is not None:
            data = bytes(source)
            kind, spec, off, end, info = _detect_station(data)
        else:
            if st.src is None:
                raise ValueError("no retained source: pass `source=` (live "
                                 "stations do not retain bytes)")
            data = st.src
            kind, spec, off, end, info = (
                ("engine", None, st.body_start, st.body_end, dict(st.info))
                if st.kind == "engine" else (st.kind, None, 0, None, {}))
        if kind != st.kind:
            raise ValueError(f"station {station} is {st.kind!r}; the new source detects "
                             f"as {kind!r} — lane slots are fixed at construction")
        if kind == "engine":
            lane = st.lanes[0]
            if spec is not None and spec != self.engine.specs[lane]:
                raise ValueError(
                    f"station {station} lane spec is {self.engine.specs[lane]}; the new "
                    f"source needs {spec} — reuse requires a matching spec")
            self.engine.reset_lane(lane)
            st.body_start, st.body_end, st.info = off, end, info
        elif kind == "flac":
            self.flac.reset_lane(st.lanes[0])
        else:  # mdfpwm
            for ln in st.lanes:
                self.engine.reset_lane(ln)
            st.mdf_buf.clear()
            st.mdf_sent = 0
            st.mdf_per = self._mdfpwm_init(data, st)
        st.fed = 0
        st.src = data if eof else None
        self.feed(station, data)
        if eof:
            self.feed(station, None)

    def seek(self, station: int, seconds: float) -> float:
        """Re-position an EOF station to ``seconds`` by the format's
        decodable-boundary math (``stream/seek.py``): FLAC by a validated
        frame-sync walk, block codecs by block math, PCM/G.711 sample-exact,
        QOA by a frame-header walk — their state is in-band, so decode from
        the landing is exact. DFPWM (and MDFPWM) state is not in-band: the
        lane's state is rebuilt by decoding the byte prefix through the
        native ``dfpwm_decode_rows`` on the host, bit-identical to decoding
        from the start. Returns the landing in seconds; the playback
        smoothing rewarms over a few samples at the landing."""
        from . import seek as sk

        st = self.stations[station]
        if st.src is None:
            raise ValueError("seek requires an eof station (retained source)")
        src = st.src
        if st.kind == "flac":
            from ..codecs.flac import parse_flac_header

            ln = st.lanes[0]
            offset, landing = sk.flac_seek(src, seconds)
            fpos = parse_flac_header(src)[5]
            self.flac.reset_lane(ln)
            self.flac.feed(ln, src[:fpos] + src[offset:])
            self.flac.feed(ln, None)
            self.flac._lanes[ln].samples_out = int(round(landing * self.out_rate))
            return landing
        if st.kind == "mdfpwm":
            from .batch_codecs import mdfpwm_to_lanes

            _spec, left, right = mdfpwm_to_lanes(src)
            off = min(int(seconds * 48000) // 8, len(left))
            landing = off * 8 / 48000.0
            for ln, body in zip(st.lanes, (left, right)):
                self._seek_dfpwm_lane(ln, body, off, landing)
            st.mdf_buf.clear()
            st.mdf_sent = st.mdf_per  # lane bytes were fed directly
            st.fed = len(src)
            return landing
        lane = st.lanes[0]
        spec = self.engine.specs[lane]
        body = src[st.body_start: st.body_end]
        codec = spec.codec
        if codec == "dfpwm":
            off = min(int(seconds * spec.sample_rate) // 8, len(body))
            landing = off * 8 / spec.sample_rate
            self._seek_dfpwm_lane(lane, body, off, landing)
            st.fed = len(src)
            return landing
        if codec == "qoa":
            pos, landing = sk.qoa_seek(src[st.body_start - 8:], seconds)
            off = pos - 8
        elif codec in ("ulaw", "alaw"):
            off, landing = sk.g711_seek(seconds, spec.sample_rate, spec.channels)
        elif codec == "ima":
            off, landing = sk.ima_seek(seconds, spec.sample_rate, spec.block_align,
                                       spec.channels)
        elif codec == "msadpcm":
            off, landing = sk.msadpcm_seek(seconds, spec.sample_rate, spec.block_align,
                                           spec.channels)
        else:  # pcm8/8u/16/24/32/f32 (+be)
            depth = {"pcm8": 8, "pcm8u": 8, "pcm16": 16, "pcm24": 24,
                     "pcm32": 32, "f32": 32}[codec.removesuffix("be")]
            off, landing = sk.pcm_seek(seconds, spec.sample_rate, spec.channels, depth)
        off = min(off, len(body))
        self._restore_lane_at(lane, off, landing, None, 0.0)
        self.engine.feed(lane, body[off:])
        self.engine.feed(lane, None)
        st.fed = len(src)
        return landing

    def _seek_dfpwm_lane(self, lane: int, body: bytes, off: int, landing: float):
        """Rebuild a DFPWM lane's exact decoder state at byte ``off`` by
        decoding the prefix on the host (native ``dfpwm_decode_rows``; the
        library is built at first use, and a failed build raises), then feed
        the tail."""
        from ..native.flacbits import dfpwm_decode_rows

        if off:
            prefix = np.frombuffer(body[:off], np.uint8)[None, :]
            samples, state = dfpwm_decode_rows(prefix, np.zeros((5, 1), np.int32))
            cs = [state[i, 0] for i in range(5)]
            last = float(samples[0, -1])
            fir = np.float32(last / (128.0 if last < 0 else 127.0))
        else:
            cs, fir = None, 0.0
        self._restore_lane_at(lane, off, landing, cs, float(fir))
        self.engine.feed(lane, body[off:])
        self.engine.feed(lane, None)

    def _restore_lane_at(self, lane: int, byte_offset: int, landing: float, codec_state,
                         fir: float):
        gi, slot = self.engine._lane_map[lane]
        g = self.engine.groups[gi]
        vol = (float(g.gain0[slot]), float(g.gain1[slot]))
        # seek keeps the lane's DSP configuration (filter kind/alpha,
        # normalize gain, mono toggle) and resets only the transient filter
        # state, which rewarms at the landing like the FIR does
        dsp = {"kind": int(g.lp_kind[slot]), "alpha": float(g.lp_a[slot]),
               "norm_gain": float(g.norm_gain[slot]), "mono": bool(g.mono_sel[slot]),
               "started": False, "y": 0.0, "x": 0.0}
        self.engine.restore(lane, {
            "byte_offset": byte_offset, "pending": b"", "eof": False,
            "codec_state": codec_state, "fir_state": fir, "volume": vol, "dsp": dsp,
        })
        g.samples_out[slot] = int(round(landing * CONFIG.output_rate))

    # -- checkpoint / resume ------------------------------------------------------
    def checkpoint(self, station: int) -> dict:
        """Serializable station state in the JAX Fleet's format (delegates to
        the owning engine; MDFPWM stations carry both lane checkpoints plus
        the de-interleave cursor)."""
        st = self.stations[station]
        if st.kind == "flac":
            return {"kind": "flac", "sub": self.flac.checkpoint(st.lanes[0])}
        if st.kind == "engine":
            return {"kind": "engine", "fed": st.fed, "sub": self.engine.checkpoint(st.lanes[0])}
        return {
            "kind": "mdfpwm", "fed": st.fed,
            "buf": bytes(st.mdf_buf), "sent": st.mdf_sent, "per": st.mdf_per,
            "sub": [self.engine.checkpoint(ln) for ln in st.lanes],
        }

    def restore(self, station: int, ckpt: dict):
        st = self.stations[station]
        if ckpt["kind"] != st.kind:
            raise ValueError(f"checkpoint kind {ckpt['kind']!r} != station kind {st.kind!r}")
        if st.kind == "flac":
            self.flac.restore(st.lanes[0], ckpt["sub"])
            return
        st.fed = ckpt["fed"]
        if st.kind == "engine":
            self.engine.restore(st.lanes[0], ckpt["sub"])
            return
        st.mdf_buf = bytearray(ckpt["buf"])
        st.mdf_sent = ckpt["sent"]
        st.mdf_per = ckpt["per"]
        for ln, sub in zip(st.lanes, ckpt["sub"]):
            self.engine.restore(ln, sub)
