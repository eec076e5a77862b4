"""Multi-process backend on ``torch.distributed`` — counterpart of
``aukit_tpu.parallel.distributed``.

Every process ingests its own streams and runs them as the lane shards of
its own mesh (``global_mesh``); lanes are independent, so a step needs no
other process, and the group's only collectives are the two host-scalar
reductions of the layer: the global peak of the flagship step's normalize
(``all_reduce(MAX)``) and ``MultiHostEngine.global_done``'s flag
(``all_reduce(MIN)``). They run on the gloo backend: NCCL refuses two ranks
on one GPU, and a scalar costs the same either way.

Usage (the same program in every process):

    from aukit_tpu_torch.parallel import distributed as dist
    dist.init_distributed("host0:1234", num_processes=N, process_id=i)
    mesh = dist.global_mesh()
    step, to_global = dist.multihost_pipeline_step(mesh, lanes, nbytes)
    g_bytes, g_state = to_global(local_bytes)   # this process's shards
    out, *new_state = step(g_bytes, *g_state)   # each a list of shards

torch has no global array: a process holds and returns its own lanes only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as tdist

from ..config import CONFIG, get_interpolation
from ..stream.batch import _Group, engine_device
from .mesh import Mesh, check_mesh, make_mesh
from .pipeline import place_rows, shard_pipeline_fn

__all__ = ["init_distributed", "global_mesh", "multihost_pipeline_step", "MultiHostEngine"]


def init_distributed(coordinator_address: str, num_processes: int, process_id: int, **kw):
    """Join the process group: ``init_process_group`` on the gloo backend at
    ``tcp://coordinator_address`` (host:port, the rank-0 process listens
    there). ``kw`` passes on (``timeout``, say)."""
    tdist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                             world_size=num_processes, rank=process_id, **kw)


def _rank_world() -> tuple[int, int]:
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def global_mesh(axes=("dp", "sp"), *, device="cuda", local_devices: int | None = None) -> Mesh:
    """This process's lane shards: ``make_mesh(local_devices, axes,
    device=device)`` (None: one shard a visible device of that type), with
    the process's rank and the group's world size recorded
    (``process_index``, ``process_count``; 0 and 1 outside a group). Every
    process of a group holds the same number of shards."""
    mesh = make_mesh(local_devices, axes, device=device)
    mesh.process_index, mesh.process_count = _rank_world()
    return mesh


def _all_reduce(value: torch.Tensor, op) -> torch.Tensor:
    """A scalar reduced over the group on the host (gloo), back on its device."""
    host = value.to("cpu").clone()
    if _rank_world()[1] > 1:
        tdist.all_reduce(host, op=op)
    return host.to(value.device)


def multihost_pipeline_step(mesh: Mesh, lanes_per_process: int, nbytes: int,
                            in_rate: int = 48000):
    """(step_fn, to_global) for the flagship DFPWM step with every process's
    lanes sharded over its own mesh. ``to_global(local_bytes
    uint8[lanes_per_process, nbytes], state=None)`` places this process's
    bytes and state (zeros when None) as its shards, on their devices;
    ``step_fn(bytes, *state)`` runs one step in lockstep with the other
    processes (kernel (a) on each shard; the batch peak is the local
    shards' max, all-reduced over the group) and returns (int8 out, state)
    as lists of this process's shards."""
    mesh = check_mesh(mesh, "multihost_pipeline_step")
    if lanes_per_process % mesh.size:
        raise ValueError(f"{lanes_per_process} lanes do not split over the process's "
                         f"{mesh.size} shards")
    step_fn = shard_pipeline_fn(in_rate, 0.9,
                                lambda peak: _all_reduce(peak, tdist.ReduceOp.MAX))

    def to_global(local_bytes, state=None):
        local_bytes = np.ascontiguousarray(local_bytes, np.uint8)
        if local_bytes.shape != (lanes_per_process, nbytes):
            raise ValueError(f"local bytes {local_bytes.shape} != "
                             f"{(lanes_per_process, nbytes)}")
        if state is None:
            leaves = [np.zeros(lanes_per_process, np.int32)] * 5
        else:
            leaves = [torch.as_tensor(leaf).to("cpu", torch.int32) for leaf in state.leaves()]
        return place_rows(mesh, local_bytes), [place_rows(mesh, leaf) for leaf in leaves]

    return step_fn, to_global


class MultiHostEngine:
    """One spec group of ``BatchStreamEngine`` lanes split over PROCESSES.

    Each process owns ``lanes_per_process`` contiguous lanes of the group:
    it feeds their bytes (``feed``/``feed_many``) and steps them as the lane
    shards of its mesh, each shard on its device with the group's kernels;
    codec state and FIR carries stay on the shards' devices.

    Contract (the JAX engine's):
      - every process calls ``step()`` in lockstep; a process whose lanes
        are all starved or finished still steps, fully masked, its lanes'
        state preserved;
      - ``step()`` returns (this process's int8 chunk [lanes_per_process, T]
        or [lanes_per_process, C, T], on its mesh's first device; local ready
        mask; local positions f64 at chunk start). torch has no global
        array, so the chunk holds this process's rows only, and
        ``local_rows(chunk)`` is that chunk on the host;
      - ``global_done()`` is one ``all_reduce(MIN)`` of the local done flag.

    ``use_pallas``: None or True launch the kernels on a card (their plain
    versions on the CPU); False, the JAX engine's default, runs the plain
    versions and is refused on a card.
    """

    def __init__(self, spec, lanes_per_process: int, mesh: Mesh | None = None,
                 use_pallas: bool | None = None, mono: bool = True,
                 interpolation: str | None = None):
        self.pid, self.npr = _rank_world()
        self.lanes_local = int(lanes_per_process)
        self.lanes = self.lanes_local * self.npr
        self.mesh = global_mesh() if mesh is None else check_mesh(mesh, "MultiHostEngine")
        ndev = self.mesh.size * self.npr
        if self.lanes % ndev:
            raise ValueError(f"total lanes {self.lanes} must divide the {ndev}-device "
                             "mesh (pad lanes_per_process)")
        device = engine_device(self.mesh.first.type, self.mesh, use_pallas, "MultiHostEngine")
        self._g = _Group(spec, np.arange(self.lanes_local), device, CONFIG.output_rate,
                         mono=mono, mode=get_interpolation(interpolation), mesh=self.mesh)
        self._io = self._g.io

    # -- ingestion (this process's lanes only) -------------------------------
    def feed(self, local_lane: int, data: bytes | None):
        self._io.feed_lane(local_lane, data)

    def feed_many(self, datas):
        for lane, d in enumerate(datas):
            self._io.feed_lane(lane, d)

    @property
    def local_done(self) -> bool:
        return self._io.exhausted

    def global_done(self) -> bool:
        """True when EVERY process's lanes are exhausted (one all-reduce; call
        in lockstep like ``step()``)."""
        flag = torch.tensor(int(self._io.exhausted), dtype=torch.int32)
        if self.npr > 1:
            tdist.all_reduce(flag, op=tdist.ReduceOp.MIN)
        return bool(flag.item())

    # -- the lockstep step ----------------------------------------------------
    def step(self):
        """One step of this process's lanes. Returns (local chunk on the
        mesh's first device, local ready bool[L_local], local positions
        f64[L_local] at chunk start)."""
        g = self._g
        st = self._io.stage()
        if st is None:
            staged = np.zeros((self.lanes_local, g.in_bytes), np.uint8)
            ready = np.zeros(self.lanes_local, bool)
            consumed = np.zeros(self.lanes_local, np.int64)
        else:
            staged, ready, consumed, _under = st
        positions = g.samples_in / g.spec.sample_rate
        out = g.dispatch(staged, ready, consumed)
        g.samples_out += np.where(ready, g.out_samples, 0)
        return out, ready, positions

    @staticmethod
    def local_rows(chunk: torch.Tensor) -> np.ndarray:
        """This process's rows of a chunk, on the host."""
        return chunk.cpu().numpy()
