"""Driver of the ``dfpwm_speakers`` configuration: one
``BatchStreamEngine`` of mono DFPWM lanes to 48 kHz int8 windows, every lane
fed its next second of bytes each tick by ``feed_many``, one ``step()`` a
tick, as a server of CC: Tweaked speakers ticks.

The output comparison covers every tick of ``check_lanes`` lanes drawn from
the seed. Decoding a lane from its first byte costs one sequential step a
sample, so the reference follows the program tick by tick: each sampled
lane's codec state and float carries are kept after every tick (a device
gather between ticks), and the reference decodes tick ``t`` from the state
the program carried into it, then holds both the window and the state it
arrives at to the program's. The first tick is decoded from the codec's zero
state and zero carries, made here and not read from the program, so the
chain covers each sampled lane from its first byte: the window of every tick
and each state the program hands from one tick to the next.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.inputs.pools import SpeakerTraffic
from portbench.reference import dfpwm as ref_dfpwm
from portbench.reference import dsp

WINDOW = 48000
CHECK_ROWS = 4096
STATE_BYTES = 5 * 4  # the DFPWM state: five int32 a lane


def control(ints, floats):
    """The engine factory of the control: the plain reference in the
    engine's place, its integer arithmetic in ``ints``, its floats in
    ``floats``."""
    from portbench.reference.speaker_control import ControlEngine
    return functools.partial(ControlEngine, dtype=ints, fdtype=floats)


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, spans,
                 engine_factory=None):
        self.cfg, self.traffic, self.seed, self.spans = cfg, traffic, seed, spans
        self.device = torch.device(device)
        self.lanes = int(cfg["lanes"])
        self.filter = traffic.get("filter")
        self.engine_factory = engine_factory
        self.t = 0

    # -- set-up ----------------------------------------------------------------------
    def setup(self):
        from aukit_tpu_torch.stream.batch import BatchStreamEngine, LaneSpec

        self.gen = SpeakerTraffic(self.traffic, self.lanes, self.seed)
        specs = [LaneSpec("dfpwm", self.gen.lane_rate(lane)) for lane in range(self.lanes)]
        make = self.engine_factory or BatchStreamEngine
        self.eng = make(specs, interpolation=self.traffic.get("interpolation", "linear"),
                        device=self.device)
        if self.filter:
            for lane in range(self.lanes):
                self.eng.set_filter(lane, self.filter["kind"], float(self.filter["cutoff"]))
        rng = np.random.default_rng([self.seed, 1])
        k = min(int(self.traffic["check_lanes"]), self.lanes)
        self.sample = np.sort(rng.choice(self.lanes, k, replace=False))
        self.sample_dev = torch.from_numpy(self.sample).to(self.device)
        self.rows: list[torch.Tensor] = []
        self.states: list[dict] = [self._zero()]  # before the first tick
        for _ in range(int(self.traffic.get("warmup_ticks", 2))):
            self.tick()
            self.keep()

    # -- the timed path --------------------------------------------------------------
    def tick_index(self) -> int:
        return self.t

    def tick(self):
        """Feed every lane its next second, step once. Returns (lane-seconds
        delivered, lane-seconds due)."""
        feeds = self.gen.feeds(self.t)
        with self.spans("engine.feed"):
            self.eng.feed_many(feeds)
        with self.spans("engine.step"):
            r = self.eng.step()
        self.t += 1
        if r is None:
            self.last = None
            return 0, self.lanes
        self.last = r[0]
        return int(np.count_nonzero(r[1])), self.lanes

    def keep(self):
        """What the check compares, kept between ticks: the sampled lanes'
        window rows and the state each carries into the next tick."""
        if self.last is None:
            self.rows.append(torch.zeros((len(self.sample), WINDOW), dtype=torch.int8,
                                         device=self.device))
        else:
            self.rows.append(self.last.index_select(0, self.sample_dev))
        self.last = None
        self.states.append(self._carried())

    def _zero(self) -> dict:
        """The state every lane starts from: DFPWM1a's zero state, zero
        smoothing and filter carries, no filter started."""
        k = len(self.sample)
        z = torch.zeros(k, dtype=torch.float32, device=self.device)
        return {"state": ref_dfpwm.initial_state(k, self.device), "fir": z, "filt_y": z,
                "filt_x": z, "started": torch.zeros(k, dtype=torch.bool, device=self.device)}

    def _carried(self) -> dict:
        """The sampled lanes' carried state, read from the engine's groups:
        the DFPWM state (int32[5, k]), the smoothing carry ``fir``, the filter
        carries ``filt_y``/``filt_x`` and whether each lane's filter has
        started, in sample order."""
        eng = self.eng
        if hasattr(eng, "carried"):  # the reference put in the program's place
            return eng.carried(self.sample)
        out = {k: [] for k in ("state", "fir", "filt_y", "filt_x")}
        started = np.zeros(len(self.sample), bool)
        order = []
        for gi, g in enumerate(eng.groups):
            pos = [i for i, lane in enumerate(self.sample) if eng._lane_map[lane][0] == gi]
            if not pos:
                continue
            slots = [eng._lane_map[self.sample[i]][1] for i in pos]
            sh = g.shards[0]
            idx = torch.tensor(slots, device=self.device)
            out["state"].append(torch.stack(sh.state.leaves()).index_select(1, idx))
            for name in ("fir", "filt_y", "filt_x"):
                out[name].append(getattr(sh, name).index_select(0, idx))
            started[pos] = g.filt_started[slots]
            order += pos
        inv = torch.from_numpy(np.argsort(order)).to(self.device)
        res = {"state": torch.cat(out["state"], dim=1).index_select(1, inv)}
        for name in ("fir", "filt_y", "filt_x"):
            res[name] = torch.cat(out[name]).index_select(0, inv)
        res["started"] = torch.from_numpy(started).to(self.device)
        return res

    def release(self):
        self.eng = None
        self.last = None

    def shape(self) -> dict:
        """Per tick: lanes and compressed bytes of each rate, the int8 window,
        the state bytes a lane reads and writes."""
        lanes = {r: len(range(g, self.lanes, self.gen.n_groups))
                 for g, r in enumerate(self.gen.rates)}
        carry = 4 + (8 if self.filter else 0)
        return {"lanes": self.lanes, "in_bytes": sum(n * r // 8 for r, n in lanes.items()),
                "window_bytes": self.lanes * WINDOW,
                "state_bytes": self.lanes * (STATE_BYTES + carry)}

    # -- the output comparison ---------------------------------------------------------
    def check(self) -> dict:
        """Hold every kept tick of every sampled lane to the reference. Returns
        the numbers compared: ``lsb_max`` (largest int8 difference),
        ``off_ppm`` (differing samples a million), ``state_off`` (carried
        integer state and filter flags that differ) and ``carry_err`` (largest
        difference of a float carry). The float work runs ``CHECK_ROWS``
        (lane, tick) pairs at a time."""
        T = len(self.rows)
        rows = torch.stack(self.rows, dim=1)  # [k, T, W]
        self.rows = []
        st = self.states
        lsb = off = n = state_off = 0
        carry = 0.0
        window_max = []
        for g, rate in enumerate(self.gen.rates):
            pos = np.nonzero(self.gen.group_of(self.sample) == g)[0]
            if not len(pos):
                continue
            lanes = np.repeat(self.sample[pos], T)
            ticks = np.tile(np.arange(T), len(pos))
            pidx = torch.from_numpy(np.repeat(pos, T)).to(self.device)
            tidx = torch.from_numpy(ticks).to(self.device)

            def pairs(name, after=False):
                stk = torch.stack([s[name] for s in (st[1:] if after else st[:-1])], dim=-1)
                return stk[..., pidx, tidx]  # [..., k, T] -> the (lane, tick) pairs

            data = torch.from_numpy(self.gen.chunk_array(lanes, ticks)).to(self.device)
            raw, state_out = ref_dfpwm.decode(data, pairs("state"))
            del data
            state_off += int((state_out != pairs("state", True)).sum())
            started_in, started_out = pairs("started"), pairs("started", True)
            if self.filter:
                state_off += int((started_out != torch.ones_like(started_out)).sum())
            else:
                state_off += int((started_out != started_in).sum())
            fir_in, fir_out = pairs("fir"), pairs("fir", True)
            y_in, y_out, x_out = pairs("filt_y"), pairs("filt_y", True), pairs("filt_x", True)
            prog = rows[pidx, tidx]
            for a in range(0, len(lanes), CHECK_ROWS):
                sl = slice(a, a + CHECK_ROWS)
                s = dsp.norm8(raw[sl])
                if self.filter:
                    cut = float(self.filter["cutoff"])
                    alpha = float(np.float32(1.0 - np.exp(-(cut / rate) * 2.0 * np.pi)))
                    y, y_last = dsp.onepole_lowpass(s, alpha, y_in[sl], started_in[sl])
                    carry = max(carry, _maxabs(y_last, y_out[sl]), _maxabs(s[:, -1], x_out[sl]))
                    s = y
                s = dsp.resample_linear(s, rate, WINDOW)
                out = dsp.smooth_int8(s, fir_in[sl], dsp.smoothing_alpha(rate))
                carry = max(carry, _maxabs(s[:, -1], fir_out[sl]))
                d = (prog[sl].to(torch.int16) - out.to(torch.int16)).abs()
                wmax = d.amax(dim=1)
                window_max.append(wmax.cpu().numpy())
                lsb = max(lsb, int(wmax.max()))
                off += int((d != 0).sum())
                n += d.numel()
        self.window_max = np.concatenate(window_max) if window_max else np.zeros(0)
        return {"lsb_max": lsb, "off_ppm": off * 1e6 / max(n, 1), "state_off": state_off,
                "carry_err": carry}

    def failed_answers(self, lsb_limit: float) -> int:
        return int((self.window_max > lsb_limit).sum())


def _maxabs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) if a.numel() else 0.0
