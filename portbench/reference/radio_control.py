"""The control of the ``radio_fleet`` comparison: the plain reference put in
the Fleet's place, computed one precision below the one the configuration
states (int16 for the int32 state of DFPWM and IMA ADPCM and int32 for the
FLAC restore's int64; bfloat16 for the engine lanes' float32 DSP and float32
for the FLAC lanes' float64). A run with it in the program's place has to
come out not correct; ``portbench/readings.py`` reads its numbers on the card.

It takes the calls the driver makes (``feed``, ``step``, ``reset_station``),
schedules each station's chunks and windows by ``radio_model``, decodes what
a step emits with the reference's decoders, and hands the driver its DFPWM
state (``carried``). It finds each station's track among the driver's
(``tracks``), as the reference does: the input maker's frame offsets.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.inputs.stations import IMA_CHUNK_BLOCKS, IMA_OUT, WAV_HEADER, body_bytes

from . import dsp, radio_ref
from .radio_model import WINDOW, FlacLaneModel, GroupModel

class ControlFleet:
    def __init__(self, sources, *, device="cuda", dtype=torch.int16, fdtype=torch.bfloat16):
        self.device = torch.device(device)
        self.dtype, self.fdtype = dtype, fdtype
        self.n = len(sources)
        self.kind = ["dfpwm" if isinstance(s, tuple) else
                     "flac" if bytes(s[:4]) == b"fLaC" else "ima" for s in sources]
        self.groups = {"dfpwm": GroupModel(self.n, 6000, 48000),
                       "ima": GroupModel(self.n, IMA_CHUNK_BLOCKS * 256, IMA_OUT)}
        self.flac = FlacLaneModel(self.n)
        self.state = torch.zeros((5, self.n), dtype=torch.int32, device=self.device)
        self.fir = torch.zeros(self.n, dtype=torch.float32, device=self.device)
        self.ima_fir = torch.zeros(self.n, dtype=torch.float32, device=self.device)
        self.pos = np.zeros(self.n, np.int64)
        self.count = np.zeros(self.n, np.int64)
        self.chunks: dict = {}
        self.flac_out: dict = {}
        self.tracks = None  # the driver's tracks, set after construction
        self.started = False
        self.init_len = [len(s[1]) if isinstance(s, tuple) else len(s) for s in sources]

    def _begin(self, i: int, first: int):
        trk = self.tracks[i][self.count[i]]
        self.count[i] += 1
        self.pos[i] = first
        if self.kind[i] == "flac":
            self.flac.reset(i, trk.offsets[1:], (trk.track.frames - trk.first) * 4096)
            self.flac.fed[i] = first
            self.flac_out[i] = np.zeros(0, np.int8)
        else:
            self.groups[self.kind[i]].reset(i, body_bytes(trk, 0, first))
            if self.kind[i] == "dfpwm":
                self.state[:, i] = 0
                self.fir[i] = 0.0
            else:
                self.ima_fir[i] = 0.0

    def _start(self):
        for i in range(self.n):
            self._begin(i, self.init_len[i])
        for g in self.groups.values():
            g.skip[:] = 0
            g.track[:] = 0
        self.started = True

    def feed(self, i: int, data):
        if not self.started:
            self._start()
        if data is None:
            (self.flac.eof if self.kind[i] == "flac" else self.groups[self.kind[i]].eof)[i] = True
            return
        trk = self.tracks[i][self.count[i] - 1]
        if self.kind[i] == "flac":
            self.flac.fed[i] += len(data)
        else:
            self.groups[self.kind[i]].sizes[i] += body_bytes(trk, self.pos[i],
                                                                self.pos[i] + len(data))
        self.pos[i] += len(data)

    def reset_station(self, i: int, source, eof: bool = False):
        if not self.started:
            self._start()
        data = source[1] if isinstance(source, tuple) else source
        self._begin(i, len(data))

    def step(self):
        if not self.started:
            self._start()
        out = torch.zeros((self.n, WINDOW), dtype=torch.int8, device=self.device)
        mask = np.zeros(self.n, bool)
        everyone = np.arange(self.n)
        for kind, g in self.groups.items():
            members = np.array([i for i in everyone if self.kind[i] == kind])
            mk, pieces = g.step(members)
            self._decode(kind, g.decoded[-1])
            mask[members] = mk[members]
            for i, p in zip(members, pieces):
                if not mk[i]:
                    continue
                for a, b, n, track, chunk in p:
                    out[i, a:a + n] = self.chunks[(int(i), track, chunk)][b:b + n]
        fm, fidx = self.flac.step()
        self._flac(fm, fidx)
        for i in np.nonzero(fm)[0]:
            w = self.flac_out[i][fidx[i] * WINDOW:(fidx[i] + 1) * WINDOW]
            out[i, :len(w)] = torch.from_numpy(w).to(self.device)
        mask[fm] = True
        return out, mask, np.zeros(self.n)

    def _decode(self, kind: str, decoded):
        for ready, chunk, track in decoded:
            lanes = np.nonzero(ready)[0]
            if not len(lanes):
                continue
            if kind == "dfpwm":
                data = np.zeros((len(lanes), 6000), np.uint8)
                for j, i in enumerate(lanes):
                    s = self.tracks[i][track[i]].stream[chunk[i] * 6000:(chunk[i] + 1) * 6000]
                    data[j, :len(s)] = np.frombuffer(s, np.uint8)
                idx = torch.from_numpy(lanes).to(self.device)
                o, st, last = radio_ref.dfpwm_chunks(
                    torch.from_numpy(data).to(self.device), self.state[:, idx], self.fir[idx],
                    self.dtype, self.fdtype)
                self.state[:, idx] = st
                self.fir[idx] = last.to(torch.float32)
            else:
                per = IMA_CHUNK_BLOCKS * 256
                blocks = np.zeros((len(lanes), per), np.uint8)
                for j, i in enumerate(lanes):
                    body = self.tracks[i][track[i]].stream[WAV_HEADER:]
                    s = np.frombuffer(body[chunk[i] * per:(chunk[i] + 1) * per], np.uint8)
                    blocks[j, :len(s)] = s
                s = radio_ref.ima_chunks(blocks.reshape(-1, 256), IMA_CHUNK_BLOCKS,
                                         16000, self.device, self.fdtype, np.int16
                                         if self.dtype == torch.int16 else np.int32)
                idx = torch.from_numpy(lanes).to(self.device)
                o = dsp.smooth_int8(s, self.ima_fir[idx], dsp.smoothing_alpha(16000), self.fdtype)
                self.ima_fir[idx] = s[:, -1].to(torch.float32)
            for j, i in enumerate(lanes):
                self.chunks[(int(i), int(track[i]), int(chunk[i]))] = o[j]

    def _flac(self, fm, fidx):
        """Decode what each FLAC station's emitted window needs."""
        runs, keys = [], []
        for i in np.nonzero(fm)[0]:
            trk = self.tracks[i][self.count[i] - 1]
            need = min(len(trk.offsets) - 1, -(-(int(fidx[i]) + 1) * WINDOW // 4096))
            have = len(self.flac_out[i]) // 4096
            if need > have:
                # a few frames before for the lowpass to settle, as the reference
                lo = max(0, have - 1)
                runs.append((trk.stream, trk.offsets[lo:need + 1]))
                keys.append((i, lo, have))
        if not runs:
            return
        from . import flac as ref_flac
        idt = np.int32 if self.dtype == torch.int16 else np.int64
        for (i, lo, have), x in zip(keys, ref_flac.decode_frames(runs, dtype=idt)):
            fdt = np.float64 if self.fdtype == torch.float32 else np.float32
            y = radio_ref.flac_dsp(x.reshape(-1), 16, 48000, fdt)
            self.flac_out[i] = np.concatenate([self.flac_out[i], y[(have - lo) * 4096:]])

    def carried(self, sample) -> dict:
        idx = torch.tensor(list(sample), dtype=torch.int64, device=self.device)
        return {"state": self.state[:, idx].clone(), "fir": self.fir[idx].clone()}
