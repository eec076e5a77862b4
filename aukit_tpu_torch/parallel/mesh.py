"""Lane shards over devices — the port's counterpart of a ``jax.sharding.Mesh``
with lanes sharded over every axis.

Lanes are embarrassingly parallel (decode, DSP and masking are all per
lane), so a mesh here is a list of lane shards placed on devices: shard i
holds the i-th contiguous block of a batch's rows on ``devices.flat[i]`` and
runs the batch's step on them with its own kernel launches. Nothing crosses
shards but what a caller gathers: outputs onto the mesh's first device, and
the two reductions of the layer (a batch peak, a done flag). More shards
than devices go round-robin over the devices, so one card holds several
shards (``make_mesh(4)`` on a one-card machine: four shards on ``cuda:0``),
as the JAX tests run on eight virtual CPU devices.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import require_device


class Mesh:
    """Devices of the lane shards, shaped ``(dp, sp)``: ``devices`` is a numpy
    object array of ``torch.device`` and ``axis_names`` names its axes, as on
    ``jax.sharding.Mesh``. A multi-process mesh (``distributed.global_mesh``)
    holds this process's shards and records its rank and the world size."""

    def __init__(self, devices: np.ndarray, axis_names=("dp", "sp"),
                 process_index: int = 0, process_count: int = 1):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_index = process_index
        self.process_count = process_count

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self) -> torch.device:
        """The device that gathered outputs land on."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def device_mesh(device) -> Mesh:
    """The one-shard mesh on ``device``: a sharded call over it is the
    unsharded call on that device."""
    return Mesh(np.full((1, 1), torch.device(device), object))


def mesh_shape(n: int) -> tuple[int, int]:
    """The near-square ``(dp, sp)`` factorisation of ``n`` shards (the JAX
    package's rule: ``dp`` the largest divisor of ``n`` at most sqrt(n))."""
    dp = next(c for c in range(int(np.sqrt(n)), 0, -1) if n % c == 0)
    return dp, n // dp


def make_mesh(n_devices: int | None = None, axes=("dp", "sp"), *, device="cuda") -> Mesh:
    """A mesh of ``n_devices`` lane shards on devices of ``device``'s type:
    every visible device when None ("cpu" has one), round-robin when there
    are more shards than devices; a device with an index ("cuda:1") holds
    every shard. "cuda" without a card raises."""
    device = require_device(device, "make_mesh")
    if device.type == "cuda" and device.index is None:
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        visible = [device]
    n = len(visible) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    devices = np.empty(n, dtype=object)
    for i in range(n):
        devices[i] = visible[i % len(visible)]
    return Mesh(devices.reshape(mesh_shape(n)), axes)


def check_mesh(mesh, who: str) -> Mesh:
    """``mesh`` itself when it is this package's ``Mesh``; else TypeError (a
    ``jax.sharding.Mesh`` places nothing on a torch device)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{who}(mesh=...) takes an aukit_tpu_torch mesh "
                        f"(parallel.pipeline.make_mesh), got {type(mesh).__name__}")
    return mesh


def shard_bounds(rows: int, shards: int) -> list[tuple[int, int]]:
    """Each shard's row range [lo, hi) of ``rows`` padded rows (a multiple of
    ``shards``)."""
    if rows % shards:
        raise ValueError(f"{rows} rows do not split into {shards} equal shards")
    w = rows // shards
    return [(i * w, (i + 1) * w) for i in range(shards)]


def lane_layout(lanes: int, device: torch.device, mesh: Mesh | None):
    """How a group of ``lanes`` lanes lies on ``mesh`` (or on ``device``
    alone): (the device outputs land on, padded lanes, lanes a shard,
    [(device, lo, hi)] of each shard that holds a real lane). The lanes are
    padded to a multiple of the shards; a shard of padding only has nothing
    to step and is left out."""
    devices = [device] if mesh is None else list(mesh.devices.flat)
    pad = (-lanes) % len(devices)
    per = (lanes + pad) // len(devices)
    shards = [(dev, i * per, (i + 1) * per) for i, dev in enumerate(devices) if i * per < lanes]
    return devices[0], pad, per, shards


def padded_rows(x, lo: int, hi: int):
    """Rows [lo, hi) of ``x`` (numpy or torch), zero rows past its end."""
    n = x.shape[0]
    if lo == 0 and hi == n:
        return x
    part = x[lo:min(hi, n)]
    extra = hi - max(lo, n)
    if extra <= 0:
        return part
    if isinstance(x, np.ndarray):
        return np.concatenate([part, np.zeros((extra,) + x.shape[1:], x.dtype)])
    return F.pad(part, (0, 0) * (x.dim() - 1) + (0, extra))


def gather_rows(parts, device: torch.device, rows: int | None = None) -> torch.Tensor:
    """Shards' outputs concatenated in lane order on ``device``, cut to the
    first ``rows`` (the real lanes) when given. One shard's output on that
    device is returned as it is (``to`` copies nothing then)."""
    out = parts[0].to(device) if len(parts) == 1 else torch.cat([p.to(device) for p in parts])
    return out if rows is None or rows == out.shape[0] else out[:rows]


def sharded_rows(mesh: Mesh, fn, args, rows: int) -> torch.Tensor:
    """``fn`` on each shard's rows of ``args`` (row-major tensors or numpy
    arrays sharing their first axis, ``rows`` long): the rows are padded with
    zeros to a multiple of the shards, each shard's block goes to its
    device, ``fn(*block)`` runs there (its kernel launches on that device's
    current stream), and the outputs are gathered in row order on the mesh's
    first device, cut to ``rows``. A shard of padding only has nothing to
    compute and is skipped. Rows are independent and the padding only ever
    follows the last real row, so work that spans rows (a FLAC frame's
    subframes) runs after the gather, on the real rows. Over a one-shard
    mesh (``device_mesh``) this is ``fn(*args)`` on that device."""
    padded = rows + (-rows) % mesh.size
    outs = []
    for dev, (lo, hi) in zip(mesh.devices.flat, shard_bounds(padded, mesh.size)):
        if lo < rows:
            outs.append(fn(*(torch.as_tensor(padded_rows(a, lo, hi)).to(dev) for a in args)))
    return gather_rows(outs, mesh.first, rows)
