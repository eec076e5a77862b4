"""Plain DFPWM1a decoder: PyTorch integer ops on any device, one step a bit,
the streams vectorised.

Written from the codec's description (CC: Tweaked ``cc.audio.dfpwm``, with the
constants the system states: PREC 10, strength slewing by one between a floor
of 2**(PREC-7) and 2**PREC - 1, the antijerk average on bit flips, the output
low-pass of 140/256), not from the program. ``dtype`` is the integer type of
the arithmetic: the codec needs int32 (a product reaches 1023 * 255); the
benchmark's control passes int16, the precision below.

State is ``int32[5, N]``: charge, strength, previous bit, previous charge and
the low-pass output, in that order. On a card the same per-bit operations
are recorded once into a CUDA graph of ``GRAPH_BITS`` steps and replayed, so
that the loop is not bound by the launch of each small operation.
"""

from __future__ import annotations

import torch

PREC = 10
STRENGTH_MAX = (1 << PREC) - 1
STRENGTH_MIN = 1 << (PREC - 7)
LOWPASS_NUM = 140
FIELDS = ("charge", "strength", "previous_bit", "previous_charge", "lowpass")
GRAPH_BITS = 64


def initial_state(n: int, device="cpu") -> torch.Tensor:
    """A fresh decoder's state: every field zero, as the codec starts."""
    return torch.zeros((len(FIELDS), n), dtype=torch.int32, device=device)


def bit_planes(data: torch.Tensor) -> torch.Tensor:
    """uint8[N, B] -> bool[8B, N] bits, time-major, least significant bit of
    each byte first."""
    n, nbytes = data.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    b = data.t().contiguous()
    return ((b[:, None, :] >> shifts[None, :, None]) & 1).reshape(nbytes * 8, n).bool()


def _consts(dtype, device):
    return {k: torch.tensor(v, dtype=dtype, device=device) for k, v in (
        ("hi", 127), ("lo", -128), ("one", 1), ("neg", -1), ("half", 1 << (PREC - 1)),
        ("lp_num", LOWPASS_NUM), ("lp_round", 0x80))}


def _bit(b, st, k, out_row):
    """One bit of every stream: ``st`` is [charge, strength, previous bit
    (bool), previous charge, low-pass], updated in place; the low-pass
    output goes to ``out_row``."""
    q, s, lb, pq, lp = st
    target = torch.where(b, k["hi"], k["lo"])
    nq = q + ((s * (target - q) + k["half"]) >> PREC)
    nq = torch.where((nq == q) & (nq != target), nq + torch.where(b, k["one"], k["neg"]), nq)
    same = b == lb
    s.copy_(torch.where(same, (s + 1).clamp_(STRENGTH_MIN, STRENGTH_MAX),
                        (s - 1).clamp_min_(STRENGTH_MIN)))
    jerk = torch.where(same, nq, (nq + pq + 1) >> 1)
    lp.add_(((jerk - lp) * k["lp_num"] + k["lp_round"]) >> 8)
    q.copy_(nq)
    pq.copy_(nq)
    lb.copy_(b)
    out_row.copy_(lp)


def decode(data: torch.Tensor, state: torch.Tensor, dtype=torch.int32):
    """uint8[N, B] bytes and int32[5, N] state -> (int8[N, 8B] decoded
    samples, int32[5, N] state after the last bit)."""
    bits = bit_planes(data)
    T, n = bits.shape
    dev = data.device
    k = _consts(dtype, dev)
    st = [state[i].to(dtype).clone() for i in range(5)]
    st[2] = state[2] != 0
    out = torch.empty((T, n), dtype=torch.int8, device=dev)
    if dev.type == "cuda" and T % GRAPH_BITS == 0 and T > GRAPH_BITS:
        _decode_graph(bits, st, k, out)
    else:
        for i in range(T):
            _bit(bits[i], st, k, out[i])
    st[2] = st[2].to(dtype)
    return out.t().contiguous(), torch.stack(st).to(torch.int32)


def _decode_graph(bits, st, k, out):
    """The bit loop as replays of one CUDA graph of ``GRAPH_BITS`` steps:
    each replay reads its bits from a fixed buffer and leaves its samples in
    another; the state lives in ``st`` throughout."""
    sbits = torch.empty((GRAPH_BITS, bits.shape[1]), dtype=torch.bool, device=bits.device)
    sout = torch.empty((GRAPH_BITS, bits.shape[1]), dtype=torch.int8, device=bits.device)
    start = [x.clone() for x in st]

    def steps():
        for j in range(GRAPH_BITS):
            _bit(sbits[j], st, k, sout[j])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up before capture, as CUDA graphs want
        sbits.copy_(bits[:GRAPH_BITS])
        steps()
    torch.cuda.current_stream().wait_stream(side)
    for x, x0 in zip(st, start):
        x.copy_(x0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        steps()
    for t0 in range(0, bits.shape[0], GRAPH_BITS):
        sbits.copy_(bits[t0:t0 + GRAPH_BITS])
        graph.replay()
        out[t0:t0 + GRAPH_BITS].copy_(sout)
    torch.cuda.synchronize()
