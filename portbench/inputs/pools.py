"""The speakers' traffic, made from the seed: every lane is fed the next
chunk of a seeded byte pool each tick.

A traffic file lists ``groups`` (each a ``rate``: lane ``l`` belongs to group
``l % len(groups)``), the ``pool_chunks`` of each group's pool, and an
optional per-lane ``filter``. Each group's pool holds ``pool_chunks`` chunks
of one second of DFPWM at its rate (``rate // 8`` bytes) of seeded random
bytes, which DFPWM decodes as any stream. Lane ``l`` reads chunk
``(start[l] + tick * stride[l]) % pool_chunks`` of its group's pool, with a
seeded start and an odd stride: with a power-of-two pool every lane walks
the whole pool before it repeats, and lanes sharing a start part at once.
Every seed gives the same sizes and the same arrivals: only the bytes move.
"""

from __future__ import annotations

import numpy as np


class SpeakerTraffic:
    def __init__(self, traffic: dict, lanes: int, seed: int):
        rng = np.random.default_rng(seed)
        self.rates = [int(g["rate"]) for g in traffic["groups"]]
        self.n_groups = len(self.rates)
        self.lanes = lanes
        self.chunks = int(traffic["pool_chunks"])
        if self.chunks & (self.chunks - 1):
            raise ValueError("pool_chunks must be a power of two")
        self.pools = [rng.integers(0, 256, (self.chunks, r // 8), dtype=np.uint8)
                      for r in self.rates]
        self.pool_bytes = [[row.tobytes() for row in p] for p in self.pools]
        self.start = rng.integers(0, self.chunks, lanes, dtype=np.int64)
        self.stride = rng.integers(0, self.chunks // 2, lanes, dtype=np.int64) * 2 + 1

    def group_of(self, lane) -> np.ndarray:
        return np.asarray(lane) % self.n_groups

    def lane_rate(self, lane: int) -> int:
        return self.rates[lane % self.n_groups]

    def chunk_ids(self, tick: int) -> np.ndarray:
        return (self.start + tick * self.stride) % self.chunks

    def feeds(self, tick: int) -> list:
        """The bytes each lane gets at ``tick``, in lane order."""
        ids = self.chunk_ids(tick)
        out = [None] * self.lanes
        for g in range(self.n_groups):
            pool = self.pool_bytes[g]
            out[g::self.n_groups] = [pool[i] for i in ids[g::self.n_groups].tolist()]
        return out

    def chunk_array(self, lanes: np.ndarray, ticks: np.ndarray) -> np.ndarray:
        """uint8[len(lanes), bytes] of the chunks lane ``lanes[i]`` got at
        ``ticks[i]`` (lanes of one rate)."""
        g = self.group_of(lanes)
        if len(set(g.tolist())) > 1:
            raise ValueError("lanes of one rate at a time")
        ids = (self.start[lanes] + ticks * self.stride[lanes]) % self.chunks
        return self.pools[int(g[0])][ids]
