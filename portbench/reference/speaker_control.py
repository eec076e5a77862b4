"""The control of the ``dfpwm_speakers`` comparison: the plain reference put
in the engine's place, computed one precision below the one the
configuration states (int16 for the DFPWM state's int32 arithmetic, bfloat16
for the float32 DSP). A run with it in the program's place has to come out
not correct; ``portbench/readings.py`` reads its numbers on the card.

It takes the engine calls the driver makes (``feed_many``, ``step``,
``set_filter``) and hands the driver the state it carries (``carried``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import dfpwm as ref_dfpwm
from . import dsp

WINDOW = 48000


class ControlEngine:
    def __init__(self, specs, interpolation: str = "linear", *, device="cuda",
                 dtype=torch.int16, fdtype=torch.bfloat16):
        if interpolation != "linear":
            raise ValueError("the control resamples linearly")
        self.device = torch.device(device)
        self.rates = np.array([s.sample_rate for s in specs])
        self.lanes = len(specs)
        self.dtype, self.fdtype = dtype, fdtype
        L = self.lanes
        self.state = torch.zeros((5, L), dtype=torch.int32, device=self.device)
        z = torch.zeros(L, dtype=torch.float32, device=self.device)
        self.fir, self.filt_y, self.filt_x = z.clone(), z.clone(), z.clone()
        self.started = torch.zeros(L, dtype=torch.bool, device=self.device)
        self.cutoff = np.zeros(L)
        self.feeds = None

    def set_filter(self, lane: int, kind: str, cutoff: float):
        if kind != "lowpass":
            raise ValueError("the control filters with the lowpass only")
        self.cutoff[lane] = cutoff

    def feed_many(self, datas):
        self.feeds = list(datas)

    def step(self):
        out = torch.zeros((self.lanes, WINDOW), dtype=torch.int8, device=self.device)
        for rate in np.unique(self.rates):
            lanes = np.nonzero(self.rates == rate)[0]
            idx = torch.from_numpy(lanes).to(self.device)
            data = np.frombuffer(b"".join(self.feeds[i] for i in lanes),
                                 np.uint8).reshape(len(lanes), -1)
            raw, st = ref_dfpwm.decode(torch.from_numpy(data.copy()).to(self.device),
                                       self.state[:, idx], self.dtype)
            f = dsp.norm8(raw, self.fdtype)
            cut = self.cutoff[lanes]
            if cut.any():
                a = float(np.float32(1.0 - np.exp(-(cut[0] / rate) * 2.0 * np.pi)))
                y, y_last = dsp.onepole_lowpass(f, a, self.filt_y[idx], self.started[idx],
                                                self.fdtype)
                self.filt_y[idx] = y_last.to(torch.float32)
                self.filt_x[idx] = f[:, -1].to(torch.float32)
                self.started[idx] = True
                f = y.to(self.fdtype)
            s = dsp.resample_linear(f, int(rate), WINDOW, self.fdtype)
            out[idx] = dsp.smooth_int8(s, self.fir[idx], dsp.smoothing_alpha(int(rate)),
                                       self.fdtype)
            self.fir[idx] = s[:, -1].to(torch.float32)
            self.state[:, idx] = st
        return out, np.ones(self.lanes, bool), np.zeros(self.lanes)

    def carried(self, sample: np.ndarray) -> dict:
        idx = torch.from_numpy(sample).to(self.device)
        return {"state": self.state[:, idx].clone(), "fir": self.fir[idx].clone(),
                "filt_y": self.filt_y[idx].clone(), "filt_x": self.filt_x[idx].clone(),
                "started": self.started[idx].clone()}
