"""FLAC LPC restore kernel: CUDA C++ for Hopper (``csrc/flac.cu``) and its
plain PyTorch version — counterpart of ``aukit_tpu.kernels.flac_pallas``
(``lpc_restore_grouped`` and its wrappers ``lpc_restore_pallas``,
``lpc_restore_scan`` and ``lpc_restore_sharded``).

The wrapper takes the JAX flat-lane wrapper's layout: warmup + residuals
``int32[S, T]``, one row per subframe, with per-row order, shift and block
length ``int32[S]`` and coefficients ``int32[S, >= K]`` (coefficient j
multiplies ``v[i-1-j]``). Both versions accumulate in int64: inside the
Pallas limb kernel's exactness domain (``|v| < 2^25``, ``|c| <= 2^15``:
every stream of depth <= 24) they equal it bit for bit; outside it they
follow the int64 host restore, with each restored sample stored as int32,
and report in ``wrapped`` (int32[S], where given) the rows whose int32
store differs from the int64 restore. Rows given as int64 are restored in
int64 (the kernel's wide entry point): what a caller does with the rows
reported wrapped, so that a malformed stream restores as the host's int64
restore does, on the same device. A tensor on the CPU goes to the plain
version; a tensor on a CUDA device goes to the kernel, or the wrapper
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import check_mesh, sharded_rows
from . import _build
from ._wrap import check_lane_vector, check_rows, stream_of

ORDER_BUCKETS = (4, 8, 16, 32)


def order_bucket(max_order: int) -> int:
    """Tap count compiled for a batch: its maximum order rounded up to 4, 8,
    16 or 32 (``flac_pallas._order_bucket``)."""
    return next((k for k in ORDER_BUCKETS if max_order <= k), 32)


def _check(vals, orders, shifts, blocks, coefs, K, wrapped=None):
    check_rows("vals", vals, torch.int64 if vals.dtype == torch.int64 else torch.int32)
    if wrapped is not None:
        if vals.dtype != torch.int32:
            raise ValueError("wrapped is reported for int32 rows only")
        check_lane_vector("wrapped", wrapped, torch.int32, vals)
    for name, t in (("orders", orders), ("shifts", shifts), ("blocks", blocks)):
        check_lane_vector(name, t, torch.int32, vals)
    if coefs.dtype != torch.int32 or coefs.dim() != 2 or coefs.shape[0] != vals.shape[0] \
            or coefs.device != vals.device:
        raise ValueError(f"coefs must be int32[S, K] on {vals.device}, "
                         f"got {coefs.dtype}{list(coefs.shape)} on {coefs.device}")
    if K is None:
        K = order_bucket(int(orders.max()) if orders.numel() else 1)
    if K not in ORDER_BUCKETS or coefs.shape[1] < K:
        raise ValueError(f"K must be one of {ORDER_BUCKETS} and at most coefs' "
                         f"{coefs.shape[1]} columns, got {K}")
    return K


def lpc_restore_ref(vals, orders, shifts, blocks, coefs, K: int | None = None,
                    wrapped=None) -> torch.Tensor:
    """The restore as a torch loop over time, the rows vectorised in int64:
    ``v[i] += (sum_j c[j] v[i-1-j] << max(-shift, 0)) >> max(shift, 0)``
    where ``0 < order <= i < block``. int32 rows store each result wrapped
    to int32 (and set ``wrapped[row]`` to whether any differs from its
    int64 value); int64 rows keep it."""
    lpc_restore_ref.calls += 1
    K = _check(vals, orders, shifts, blocks, coefs, K, wrapped)
    out = vals.clone()
    S, T = out.shape
    bad = torch.zeros(S, dtype=torch.bool, device=vals.device)
    if S and T:
        c = coefs[:, :K].to(torch.int64)
        left = (-shifts).clamp(0, 63).to(torch.int64)
        right = shifts.clamp(0, 63).to(torch.int64)
        live = orders > 0
        for i in range(1, T):
            o = min(i, K)
            window = out[:, i - o: i].flip(1).to(torch.int64)  # newest first
            pred = ((window * c[:, :o]).sum(1) << left) >> right
            upd = live & (i >= orders) & (i < blocks)
            full = out[:, i].to(torch.int64) + pred
            stored = full.to(out.dtype)
            bad |= upd & (stored.to(torch.int64) != full)
            out[:, i] = torch.where(upd, stored, out[:, i])
    if wrapped is not None:
        wrapped.copy_(bad.to(torch.int32))
    return out


lpc_restore_ref.calls = 0


def lpc_restore_kernel(vals, orders, shifts, blocks, coefs, K: int | None = None,
                       wrapped=None) -> torch.Tensor:
    """int32[S, T] warmup + residuals -> int32[S, T] restored samples. The
    CUDA kernel ``aukit_lpc_restore`` replaces ``lpc_restore_grouped``
    (aukit_tpu/kernels/flac_pallas.py:131). ``K`` is the tap count (4, 8,
    16 or 32, at least the batch's maximum order); without it the wrapper
    reads the orders, which on a card waits for the device. ``wrapped``
    (int32[S]): the kernel writes 1 for each row whose int32 store differs
    from its int64 restore, else 0. int64 rows -> int64 rows, restored by
    the wide entry point ``aukit_lpc_restore_wide``."""
    if vals.device.type == "cpu":
        return lpc_restore_ref(vals, orders, shifts, blocks, coefs, K, wrapped)
    K = _check(vals, orders, shifts, blocks, coefs, K, wrapped)
    if not vals.is_contiguous():
        raise ValueError("vals must be contiguous")
    S, T = vals.shape
    out = torch.empty_like(vals)
    if S == 0 or T == 0:
        if wrapped is not None:
            wrapped.zero_()
        return out
    taps = coefs[:, :K].contiguous()
    lib = _build.load()
    with torch.cuda.device(vals.device):
        if vals.dtype == torch.int64:
            name = "aukit_lpc_restore_wide"
            rc = lib.aukit_lpc_restore_wide(
                vals.data_ptr(), orders.data_ptr(), shifts.data_ptr(), blocks.data_ptr(),
                taps.data_ptr(), out.data_ptr(), S, T, K, stream_of(vals))
        else:
            name = "aukit_lpc_restore"
            rc = lib.aukit_lpc_restore(
                vals.data_ptr(), orders.data_ptr(), shifts.data_ptr(), blocks.data_ptr(),
                taps.data_ptr(), out.data_ptr(), None if wrapped is None else wrapped.data_ptr(),
                S, T, K, stream_of(vals))
    _build.check(rc, name)
    lpc_restore_kernel.launches += 1
    if vals.dtype == torch.int64:
        lpc_restore_kernel.wide_launches += 1
    return out


lpc_restore_kernel.launches = 0
lpc_restore_kernel.wide_launches = 0  # of them, the int64 rows' (malformed streams only)


def lpc_restore_sharded(vals, orders, shifts, blocks, coefs, mesh,
                        use_pallas: bool | None = None) -> torch.Tensor:
    """The batched restore with its subframe rows split over a mesh
    (``parallel.pipeline.make_mesh``), zero collectives: rows are padded to a
    multiple of the mesh's shards (order 0: nothing restored), and each
    shard restores its rows on its device by ``lpc_restore_kernel`` (the
    CUDA kernel on a card, its plain version on the CPU), with fault 3.3's
    wrapped-row flags: the rows whose int32 store wrapped are restored again
    in int64 by the wide entry point, on the same shard. ``vals`` int32[S,
    T], ``orders``/``shifts``/``blocks`` int32[S], ``coefs`` int32[S, >= K]
    (numpy or tensors); the tap count K is the whole batch's order bucket.
    ``use_pallas`` is the JAX package's switch: False runs the plain version
    and is refused on a card. Returns the restored rows as int64[S, T] on
    the mesh's first device (``lpc_restore_sharded`` of
    aukit_tpu/kernels/flac_pallas.py:225, which returns int32 rows)."""
    mesh = check_mesh(mesh, "lpc_restore_sharded")
    if use_pallas is False and mesh.first.type == "cuda":
        raise ValueError("lpc_restore_sharded(use_pallas=False): on a card the port "
                         "launches its CUDA kernel; use a CPU mesh for the plain version")
    restore = lpc_restore_ref if use_pallas is False else lpc_restore_kernel

    def i32(a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(torch.int32)
        return torch.from_numpy(np.ascontiguousarray(a, np.int32))

    args = [i32(a) for a in (vals, orders, shifts, blocks)]
    S = args[0].shape[0]
    K = order_bucket(int(args[1].max()) if S else 1)
    args.append(i32(coefs[:, :K]))

    def shard(v, o, sh, b, cf):
        wrapped = torch.empty(v.shape[0], dtype=torch.int32, device=v.device)
        out = restore(v.contiguous(), o, sh, b, cf.contiguous(), K, wrapped=wrapped)
        out = out.to(torch.int64)
        rows = torch.nonzero(wrapped).flatten()
        if rows.numel():
            out[rows] = restore(v[rows].to(torch.int64), o[rows], sh[rows], b[rows],
                                cf[rows].contiguous(), K)
        return out

    return sharded_rows(mesh, shard, args, S)

KERNELS = (lpc_restore_kernel,)
PLAIN = (lpc_restore_ref,)
