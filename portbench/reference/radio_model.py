"""Where each second of a live Fleet's output comes from, as the system
states it, worked out from what the harness fed: which chunk of which track
fills which columns of each station's window at each tick, and whether the
station's mask is set. With it the reference builds the window each sampled
station should get from the chunks it decodes itself.

Stations on engine lanes (``BatchStreamEngine``, windowed) share one group
per lane format. Each step, while a group's FIFO holds less than a window
plus the largest read cursor, it decodes one chunk of every lane that is
ready (a whole chunk buffered, or an ended lane's zero-padded tail), lanes
not ready adding silence; then it pops one window, each lane reading from its
own cursor, masked when no real chunk of the lane overlaps what it read. A
lane reset mid-FIFO reads from the fill at the reset, so that what was queued
before is dropped. FLAC stations (``FlacFleet``) commit each frame once all
of its bytes, the CRC-16 included, have arrived (an ended stream commits its
tail), and emit one window a step once a window's worth is queued or the
stream has ended, the last window zero-padded.
"""

from __future__ import annotations

import numpy as np

WINDOW = 48000


class GroupModel:
    """One engine group of ``lanes`` lanes, each chunk ``in_bytes`` bytes in
    and ``out`` samples out. Lanes are the harness's indices into the group."""

    def __init__(self, lanes: int, in_bytes: int, out: int):
        self.in_bytes, self.out = in_bytes, out
        self.sizes = np.zeros(lanes, np.int64)
        self.eof = np.zeros(lanes, bool)
        self.skip = np.zeros(lanes, np.int64)
        self.chunk = np.zeros(lanes, np.int64)  # next chunk of the lane's track
        self.track = np.zeros(lanes, np.int64)  # the lane's track count
        self.fill = 0
        self.spans: list = []  # [start, end, ready, chunk, track]
        self.decoded: list = []  # per step: [(ready, chunk, track)] decoded this step

    def reset(self, lane: int, initial: int):
        self.skip[lane] = self.fill
        self.sizes[lane] = initial
        self.eof[lane] = False
        self.chunk[lane] = 0
        self.track[lane] += 1

    def step(self, sample: np.ndarray):
        """One engine step. Returns (mask bool[lanes], pieces per sampled
        lane: [(window offset, chunk offset, length, track, chunk)])."""
        need = WINDOW + int(self.skip.max())
        decoded = []
        while self.fill < need:
            full = self.sizes >= self.in_bytes
            partial = self.eof & ~full & (self.sizes > 0)
            ready = full | partial
            if not ready.any():
                break
            self.sizes[full] -= self.in_bytes
            self.sizes[partial] = 0
            self.spans.append([self.fill, self.fill + self.out, ready, self.chunk.copy(),
                               self.track.copy()])
            decoded.append((ready, self.chunk.copy(), self.track.copy()))
            self.chunk[ready] += 1
            self.fill += self.out
        self.decoded.append(decoded)
        lanes = len(self.sizes)
        if self.fill < need:  # starved: the group holds its FIFO
            return np.zeros(lanes, bool), [[] for _ in sample]
        mask = np.zeros(lanes, bool)
        lo = self.skip
        for start, end, ready, _c, _t in self.spans:
            mask |= ready & (lo < end) & (lo + WINDOW > start)
        pieces = []
        for lane in sample:
            a, got = int(self.skip[lane]), []
            for start, end, ready, chunk, track in self.spans:
                s, e = max(start, a), min(end, a + WINDOW)
                if e > s and ready[lane]:
                    got.append((s - a, s - start, e - s, int(track[lane]), int(chunk[lane])))
            pieces.append(got)
        for sp in self.spans:
            sp[0] -= WINDOW
            sp[1] -= WINDOW
        while self.spans and self.spans[0][1] <= 0:
            self.spans.pop(0)
        self.fill -= WINDOW
        if self.fill == 0:
            self.skip[:] = 0
            self.spans.clear()
        return mask, pieces


class FlacLaneModel:
    """The FLAC stations: each one's committed samples and popped windows."""

    def __init__(self, lanes: int, block: int = 4096):
        self.block = block
        self.fed = np.zeros(lanes, np.int64)  # bytes of the track's stream fed
        self.eof = np.zeros(lanes, bool)
        self.ended = np.zeros(lanes, bool)
        self.decoded = np.zeros(lanes, np.int64)  # samples committed
        self.popped = np.zeros(lanes, np.int64)  # samples emitted (windows * WINDOW)
        self.total = np.zeros(lanes, np.int64)  # the track's samples
        self.ends: list = [None] * lanes  # each frame's end in the track's stream

    def reset(self, lane: int, frame_ends: np.ndarray, total: int):
        self.fed[lane] = 0
        self.eof[lane] = self.ended[lane] = False
        self.decoded[lane] = self.popped[lane] = 0
        self.total[lane] = total
        self.ends[lane] = frame_ends

    def step(self):
        """Returns (mask, window index within the track of each lane)."""
        for lane in range(len(self.fed)):
            if self.ended[lane] or self.ends[lane] is None:
                continue
            if self.eof[lane]:
                self.decoded[lane] = self.total[lane]
                self.ended[lane] = True
            else:
                frames = int(np.searchsorted(self.ends[lane], self.fed[lane], side="right"))
                self.decoded[lane] = frames * self.block
        fill = self.decoded - self.popped
        mask = (fill >= WINDOW) | (self.ended & (fill > 0))
        index = self.popped // WINDOW
        self.popped = np.where(mask, self.popped + np.minimum(fill, WINDOW), self.popped)
        return mask, index
