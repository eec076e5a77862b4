"""Driver of the ``radio_fleet`` configuration: one live ``Fleet`` of FLAC,
raw DFPWM and IMA-ADPCM-in-WAV stations, as the repository's mixed radio
server runs it. Each tick every station gets its next bytes at its bitrate
times a jitter, one ``Fleet.step()`` emits every station's window, and a
station whose track has played out (its mask false after its end was fed)
is rotated live onto the next track of its playlist with
``reset_station(i, <first bytes>, eof=False)``.

The output comparison covers every tick of the stations drawn from the seed
(``check_stations`` of each kind), and the masks of every station. The
reference works out from what was fed which chunk of which track each
window should hold (``reference/radio_model.py``) and decodes those chunks
itself: FLAC and IMA ADPCM from the tracks' bytes; DFPWM, whose decoder
state runs through a whole track one sample at a time, tick by tick from the
state the program carried into each chunk (kept after every tick), holding
the state each chunk arrives at to the program's. A track's first chunk
starts from the zero state.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.inputs import stations as ins
from portbench.inputs.stations import IMA_CHUNK_BLOCKS, IMA_OUT, WAV_HEADER, Track, body_bytes
from portbench.reference import dsp, radio_ref
from portbench.reference.radio_model import WINDOW, FlacLaneModel, GroupModel


def control(ints, floats):
    from portbench.reference.radio_control import ControlFleet
    return functools.partial(ControlFleet, dtype=ints, fdtype=floats)


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, spans,
                 engine_factory=None):
        self.cfg, self.traffic, self.seed, self.spans = cfg, traffic, seed, spans
        self.device = torch.device(device)
        self.n = int(cfg["stations"])
        self.kinds = list(cfg["kinds"])
        self.engine_factory = engine_factory
        self.t = 0

    # -- set-up ------------------------------------------------------------------------
    def setup(self):
        from aukit_tpu_torch.stream.batch import LaneSpec
        from aukit_tpu_torch.stream.fleet import Fleet

        tr = self.traffic
        rng = np.random.default_rng([self.seed, 0])
        lo, hi = tr["track_seconds"]
        P = int(self.cfg["track_pool"])
        makers = {"flac": ins.FlacTrack, "dfpwm": ins.DfpwmTrack, "ima": ins.ImaTrack}
        self.pools = {k: [makers[k](rng, s) for s in rng.permutation(np.linspace(lo, hi, P))]
                      for k in self.kinds}
        self.kind = [self.kinds[i % len(self.kinds)] for i in range(self.n)]
        self.playlist = rng.integers(0, P, (self.n, 64))
        self.initial = tr["initial_bytes"]
        self.tracks: list[list[Track]] = [[] for _ in range(self.n)]
        self.jitter_rng = np.random.default_rng([self.seed, 2])
        self.of_kind = {k: np.array([i for i in range(self.n) if self.kind[i] == k])
                        for k in self.kinds}
        jlo, jhi = tr["jitter"]
        self.jitter_set = {k: np.linspace(jlo, jhi, len(v)) for k, v in self.of_kind.items()}
        sources = []
        for k, members in self.of_kind.items():
            # first tracks are joined part way: one of an even spread of
            # fractions each, so they end at ticks spread over the run
            frac = (rng.permutation(len(members)) + 0.5) / len(members)
            for i, f in zip(members, frac):
                pool = self.pools[k][self.playlist[i, 0]]
                self.tracks[i].append(Track(k, pool, int(f * pool.units)))
        self.offset = np.zeros(self.n, np.int64)
        self.eof_fed = np.zeros(self.n, bool)
        self.bps = np.zeros(self.n)
        for i in range(self.n):
            src = self._start(i)
            sources.append((LaneSpec("dfpwm", 48000), src) if self.kind[i] == "dfpwm" else src)
        make = self.engine_factory or functools.partial(Fleet, eof=False)
        self.fleet = make(sources, device=self.device)
        if hasattr(self.fleet, "tracks"):  # the reference in the program's place
            self.fleet.tracks = self.tracks
        if self.engine_factory is None:
            self.fleet.engine.step = self.spans.wrap("engine.step", self.fleet.engine.step)
            self.fleet.flac.step = self.spans.wrap("flac.step", self.fleet.flac.step)
        self.events: list = []  # per tick: (resets, fed bytes, ends)
        self.rotate: list[int] = []
        sample_rng = np.random.default_rng([self.seed, 1])
        self.sample = np.sort(np.concatenate([
            sample_rng.choice(self.of_kind[k], min(int(tr["check_stations"][k]),
                                                  len(self.of_kind[k])), replace=False)
            for k in self.kinds]))
        self.sample_dev = torch.from_numpy(self.sample).to(self.device)
        self.dfpwm_sample = [i for i in self.sample if self.kind[i] == "dfpwm"]
        self.rows, self.masks = [], []
        self.states = [self._dfpwm_state()]
        for _ in range(int(tr.get("warmup_ticks", 2))):
            self.tick()
            self.keep()

    def _start(self, i: int) -> bytes:
        """Begin station ``i``'s newest track: its first bytes."""
        trk = self.tracks[i][-1]
        first = trk.stream[: int(self.initial[self.kind[i]])]
        self.offset[i] = len(first)
        self.eof_fed[i] = False
        self.bps[i] = max(1, len(trk.stream) // max(1, round(trk.track.seconds(trk.first))))
        return first

    # -- the timed path ----------------------------------------------------------------
    def tick_index(self) -> int:
        return self.t

    def tick(self):
        from aukit_tpu_torch.stream.batch import LaneSpec

        fleet = self.fleet
        resets = []
        with self.spans("fleet.rotate"):
            for i in self.rotate:
                k = self.kind[i]
                pool = self.pools[k][self.playlist[i, len(self.tracks[i]) % 64]]
                self.tracks[i].append(Track(k, pool, 0))
                first = self._start(i)
                fleet.reset_station(i, (LaneSpec("dfpwm", 48000), first) if k == "dfpwm"
                                    else first, eof=False)
                resets.append(i)
        mult = np.zeros(self.n)
        for k, members in self.of_kind.items():
            mult[members] = self.jitter_rng.permutation(self.jitter_set[k])
        fed = np.zeros(self.n, np.int64)
        ends = []
        with self.spans("engine.feed"):
            for i in range(self.n):
                if self.eof_fed[i]:
                    continue
                s = self.tracks[i][-1].stream
                off = int(self.offset[i])
                if off < len(s):
                    chunk = s[off: off + int(self.bps[i] * mult[i])]
                    fleet.feed(i, chunk)
                    fed[i] = len(chunk)
                    self.offset[i] = off + len(chunk)
                else:
                    fleet.feed(i, None)
                    self.eof_fed[i] = True
                    ends.append(i)
        self.events.append((resets, fed, ends))
        with self.spans("fleet.step"):
            r = fleet.step()
        self.t += 1
        if r is None:
            self.last, mask = None, np.zeros(self.n, bool)
        else:
            self.last, mask = r[0], np.asarray(r[1], bool)
        self.masks.append(mask)
        self.rotate = [int(i) for i in np.nonzero(self.eof_fed & ~mask)[0]]
        # a station is due a window only while its track plays: between
        # tracks, and while its bytes are late, it has none to give, and the
        # check holds every mask to the reference's
        return int(mask.sum()), int(mask.sum())

    def keep(self):
        if self.last is None:
            self.rows.append(torch.zeros((len(self.sample), WINDOW), dtype=torch.int8,
                                         device=self.device))
        else:
            self.rows.append(self.last.index_select(0, self.sample_dev))
        self.last = None
        self.states.append(self._dfpwm_state())

    def _dfpwm_state(self) -> dict:
        """The sampled DFPWM stations' decoder state and smoothing carry, read
        from the engine's DFPWM group."""
        if hasattr(self.fleet, "carried"):
            return self.fleet.carried(self.dfpwm_sample)
        eng = self.fleet.engine
        lanes = [eng._lane_map[self.fleet.stations[i].lanes[0]] for i in self.dfpwm_sample]
        (gi,) = {g for g, _s in lanes}
        sh = eng.groups[gi].shards[0]
        idx = torch.tensor([s for _g, s in lanes], device=self.device)
        return {"state": torch.stack(sh.state.leaves()).index_select(1, idx),
                "fir": sh.fir.index_select(0, idx)}

    def release(self):
        self.fleet = None
        self.last = None

    # -- the output comparison ------------------------------------------------------------
    def replay(self):
        """The model of every tick run: expected masks of all stations and the
        pieces of each sampled station's windows."""
        groups = {"dfpwm": GroupModel(self.n, 6000, 48000),
                  "ima": GroupModel(self.n, IMA_CHUNK_BLOCKS * ins.IMA_BLOCK, IMA_OUT)}
        flac = FlacLaneModel(self.n)
        count = {i: 0 for i in range(self.n)}  # tracks begun
        pos = np.zeros(self.n, np.int64)

        def begin(i):
            trk = self.tracks[i][count[i]]
            count[i] += 1
            first = min(int(self.initial[self.kind[i]]), len(trk.stream))
            pos[i] = first
            if self.kind[i] == "flac":
                flac.reset(i, trk.offsets[1:], (trk.track.frames - trk.first) * ins.FLAC_BLOCK)
                flac.fed[i] = first
            else:
                groups[self.kind[i]].reset(i, body_bytes(trk, 0, first))

        for i in range(self.n):
            begin(i)
        for g in groups.values():  # construction is no reset: every cursor starts at 0
            g.skip[:] = 0
            g.track[:] = 0
        expect = []
        for resets, fed, ends in self.events:
            for i in resets:
                begin(i)
            for i in np.nonzero(fed)[0]:
                trk = self.tracks[i][count[i] - 1]
                if self.kind[i] == "flac":
                    flac.fed[i] += fed[i]
                else:
                    groups[self.kind[i]].sizes[i] += body_bytes(trk, pos[i], pos[i] + fed[i])
                pos[i] += fed[i]
            for i in ends:
                (flac.eof if self.kind[i] == "flac" else groups[self.kind[i]].eof)[i] = True
            mask = np.zeros(self.n, bool)
            pieces = {}
            for k, g in groups.items():
                mk, pk = g.step(self.sample)
                members = self.of_kind[k]
                mask[members] = mk[members]
                for i, p in zip(self.sample, pk):
                    if self.kind[i] == k:
                        pieces[i] = p
            fm, fidx = flac.step()
            members = self.of_kind["flac"]
            mask[members] = fm[members]
            for i in self.sample:
                if self.kind[i] == "flac":
                    pieces[i] = int(fidx[i]) if fm[i] else None
            expect.append((mask, pieces))
        return expect, groups

    def check(self) -> dict:
        expect, groups = self.replay()
        T = len(expect)
        dev = self.device
        state_off = sum(int((m != e[0]).sum()) for m, e in zip(self.masks, expect))
        want = torch.zeros((len(self.sample), T, WINDOW), dtype=torch.int8, device=dev)
        col = {int(i): c for c, i in enumerate(self.sample)}
        chunks, state_off_d, carry = self._dfpwm_chunks(groups["dfpwm"])
        state_off += state_off_d
        chunks.update(self._ima_chunks(expect))
        flac = self._flac_outputs(expect)
        for t, (mask, pieces) in enumerate(expect):
            for i in self.sample:
                i = int(i)
                if not mask[i]:
                    continue
                if self.kind[i] == "flac":
                    out = flac[(i, self._track_at(i, t))]
                    w = out[pieces[i] * WINDOW:(pieces[i] + 1) * WINDOW]
                    want[col[i], t, :len(w)] = torch.from_numpy(w).to(dev)
                    continue
                for a, b, n, track, chunk in pieces[i]:
                    want[col[i], t, a:a + n] = chunks[(i, track, chunk)][b:b + n]
        got = torch.stack(self.rows, dim=1)
        d = (got.to(torch.int16) - want.to(torch.int16)).abs()
        self.window_max = d.amax(dim=2).reshape(-1).cpu().numpy()
        return {"lsb_max": int(d.max()), "off_ppm": float((d != 0).sum()) * 1e6 / d.numel(),
                "state_off": state_off, "carry_err": carry}

    def _track_at(self, i: int, t: int) -> int:
        """Which of station ``i``'s tracks plays at tick ``t`` (resets happen
        at the start of a tick)."""
        n = 0
        for resets, _f, _e in self.events[: t + 1]:
            n += i in resets
        return n

    def _dfpwm_chunks(self, model: GroupModel):
        """Every chunk a sampled DFPWM station decoded, from the state the
        program carried into it; the states it arrives at held to the
        program's."""
        jobs = []  # (station, track, chunk, tick)
        for t, decoded in enumerate(model.decoded):
            for ready, chunk, track in decoded:
                for i in self.dfpwm_sample:
                    if ready[i]:
                        jobs.append((int(i), int(track[i]), int(chunk[i]), t))
        if not jobs:
            return {}, 0, 0.0
        pos = {int(i): c for c, i in enumerate(self.dfpwm_sample)}
        data = np.zeros((len(jobs), 6000), np.uint8)
        st_in, prev_in, st_out, fir_out = [], [], [], []
        for j, (i, track, chunk, t) in enumerate(jobs):
            s = self.tracks[i][track].stream[chunk * 6000:(chunk + 1) * 6000]
            data[j, :len(s)] = np.frombuffer(s, np.uint8)
            before = self.states[t]  # after tick t-1 (states[0]: before any tick)
            if chunk == 0:
                st_in.append(torch.zeros(5, dtype=torch.int32, device=self.device))
                prev_in.append(torch.zeros((), device=self.device))
            else:
                st_in.append(before["state"][:, pos[i]])
                prev_in.append(before["fir"][pos[i]])
            st_out.append(self.states[t + 1]["state"][:, pos[i]])
            fir_out.append(self.states[t + 1]["fir"][pos[i]])
        out, st, last = radio_ref.dfpwm_chunks(
            torch.from_numpy(data).to(self.device), torch.stack(st_in, dim=1),
            torch.stack(prev_in))
        state_off = int((st != torch.stack(st_out, dim=1)).sum())
        carry = float((last - torch.stack(fir_out)).abs().max())
        return ({(i, track, chunk): out[j] for j, (i, track, chunk, _t) in enumerate(jobs)},
                state_off, carry)

    def _ima_chunks(self, expect):
        """Every chunk of the sampled IMA stations' tracks up to the last one
        a window shows, smoothed in order from the track's start."""
        need: dict = {}
        for _mask, pieces in expect:
            for i, p in pieces.items():
                if self.kind[i] == "ima":
                    for *_x, track, chunk in p:
                        need[(i, track)] = max(need.get((i, track), -1), chunk)
        if not need:
            return {}
        per = IMA_CHUNK_BLOCKS * ins.IMA_BLOCK
        keys, blocks = [], []
        for (i, track), last in need.items():
            body = self.tracks[i][track].stream[WAV_HEADER:]
            for c in range(last + 1):
                b = np.zeros(per, np.uint8)
                s = np.frombuffer(body[c * per:(c + 1) * per], np.uint8)
                b[:len(s)] = s
                blocks.append(b.reshape(IMA_CHUNK_BLOCKS, ins.IMA_BLOCK))
                keys.append((i, track, c))
        s = radio_ref.ima_chunks(np.concatenate(blocks), IMA_CHUNK_BLOCKS, ins.IMA_RATE,
                                 self.device)
        prev = torch.zeros(len(keys), device=self.device)
        for j, (i, track, c) in enumerate(keys):
            if c > 0:
                prev[j] = s[j - 1, -1]
        out = dsp.smooth_int8(s, prev, dsp.smoothing_alpha(ins.IMA_RATE))
        return {k: out[j] for j, k in enumerate(keys)}

    def _flac_outputs(self, expect):
        """Each sampled FLAC station's output over every track it played, up
        to the last window shown."""
        need: dict = {}
        for t, (mask, pieces) in enumerate(expect):
            for i, w in pieces.items():
                if self.kind[i] == "flac" and w is not None:
                    key = (i, self._track_at(i, t))
                    need[key] = max(need.get(key, -1), w)
        outs = {}
        for (i, track), w in need.items():
            trk = self.tracks[i][track]
            frames = min(len(trk.offsets) - 1, -(-(w + 1) * WINDOW // ins.FLAC_BLOCK))
            outs[(i, track)] = radio_ref.flac_output(trk.stream, trk.offsets, frames)
        return outs

    def failed_answers(self, lsb_limit: float) -> int:
        return int((self.window_max > lsb_limit).sum())
