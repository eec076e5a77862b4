"""Plain FLAC decoder for the benchmark's stations: NumPy only, written from
the FLAC format description (https://xiph.org/flac/format.html), not from the
program.

It reads the STREAMINFO header, and the frames at byte offsets the caller
gives (the input maker knows where each frame it wrote starts): each frame's
header and subframe header in Python, then the Rice-coded residuals and the
LPC or fixed-predictor restore with the frames vectorised. It decodes mono
streams with CONSTANT, VERBATIM, FIXED and LPC subframes whose residual is
Rice-coded in any partition order (method 0 or 1, no escaped partition),
what the benchmark's writer makes, and refuses anything else. Each frame is
checked to end where the next begins.
"""

from __future__ import annotations

import numpy as np

FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


class BitReader:
    def __init__(self, data: bytes, pos: int):
        self.data, self.bit = data, pos * 8

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.bit >> 3]
            v = (v << 1) | ((byte >> (7 - (self.bit & 7))) & 1)
            self.bit += 1
        return v

    def s(self, n: int) -> int:
        v = self.u(n)
        return v - (1 << n) if v >> (n - 1) else v


def streaminfo(stream: bytes):
    """(rate, channels, depth, total samples, offset of the first frame)."""
    if stream[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    info = None
    while True:
        last, kind = stream[pos] >> 7, stream[pos] & 0x7F
        size = int.from_bytes(stream[pos + 1: pos + 4], "big")
        if kind == 0:
            r = BitReader(stream, pos + 4 + 10)
            rate, ch, depth, total = r.u(20), r.u(3) + 1, r.u(5) + 1, r.u(36)
            info = (rate, ch, depth, total)
        pos += 4 + size
        if last:
            return (*info, pos)


def _frame_layout(stream: bytes, pos: int, depth: int) -> dict:
    r = BitReader(stream, pos)
    if r.u(14) != 0x3FFE:
        raise ValueError(f"no frame sync at byte {pos}")
    r.u(2)
    bcode, rcode, chan, _ss, _ = r.u(4), r.u(4), r.u(4), r.u(3), r.u(1)
    if chan != 0:
        raise ValueError("the reference decodes mono streams")
    lead = r.u(8)
    extra = 0
    while lead & (0x80 >> extra) and extra < 7:
        extra += 1
    for _ in range(max(0, extra - 1)):
        r.u(8)
    if bcode == 1:
        block = 192
    elif 2 <= bcode <= 5:
        block = 576 << (bcode - 2)
    elif bcode == 6:
        block = r.u(8) + 1
    elif bcode == 7:
        block = r.u(16) + 1
    elif bcode >= 8:
        block = 256 << (bcode - 8)
    else:
        raise ValueError("reserved block size")
    if rcode == 12:
        r.u(8)
    elif rcode in (13, 14):
        r.u(16)
    r.u(8)  # CRC-8
    if r.u(1):
        raise ValueError("bad subframe padding")
    kind = r.u(6)
    if r.u(1):
        raise ValueError("the reference decodes no wasted bits")
    lay = {"block": block, "pos": pos}
    if kind == 0:
        lay.update(kind="constant", value=r.s(depth))
        lay["end"] = r.bit
        return lay
    if kind == 1:
        lay.update(kind="verbatim", values=[r.s(depth) for _ in range(block)])
        lay["end"] = r.bit
        return lay
    if 8 <= kind <= 12:
        order = kind - 8
        warm = [r.s(depth) for _ in range(order)]
        coefs, shift, precision = FIXED_COEFS[order], 0, 0
    elif kind >= 32:
        order = kind - 31
        warm = [r.s(depth) for _ in range(order)]
        precision = r.u(4) + 1
        shift = r.s(5)
        coefs = [r.s(precision) for _ in range(order)]
    else:
        raise ValueError(f"reserved subframe type {kind}")
    method, porder = r.u(2), r.u(4)
    if method > 1:
        raise ValueError(f"reserved residual coding method {method}")
    if block % (1 << porder) or (block >> porder) < order:
        raise ValueError("the Rice partitions do not fit the block")
    lay.update(kind="lpc", order=order, warm=warm, coefs=coefs, shift=shift,
               precision=precision, pbits=4 if method == 0 else 5, porder=porder,
               res_bit=r.bit)
    return lay


def _rice(ones: np.ndarray, win: np.ndarray, start: np.ndarray, pbits: np.ndarray,
          psize: np.ndarray, order: int, count: int):
    """Rice residuals of many frames at once: ``count`` each, from bit
    ``start[f]``, in partitions of ``psize[f]`` samples (the first less the
    ``order`` warm-up samples), each led by its parameter in ``pbits[f]``
    bits; ``ones`` lists the positions of the set bits and ``win[i]`` holds
    the 16 bits from bit ``i`` on. Returns (int64[F, count], the bit after
    each frame's last residual)."""
    pos = start.copy()
    param = np.zeros(len(pos), np.int64)
    escape = (1 << pbits) - 1
    out = np.empty((len(pos), count), np.int64)
    for i in range(count):
        lead = ((i + order) % psize == 0) | (i == 0)
        if lead.any():
            got = win[pos] >> (16 - pbits)
            if (lead & (got == escape)).any():
                raise ValueError("the reference decodes no escaped partition")
            param = np.where(lead, got, param)
            pos = np.where(lead, pos + pbits, pos)
        one = ones[np.searchsorted(ones, pos)]
        low = np.where(param > 0, win[one + 1] >> (16 - param), 0)
        u = ((one - pos) << param) | low
        out[:, i] = (u >> 1) ^ -(u & 1)
        pos = one + 1 + param
    return out, pos


def decode_frames(runs, depth: int = 16, dtype=np.int64, batch_bytes: int = 8 << 20):
    """Frames of several streams at once: ``runs`` is a list of (stream
    bytes, frame offsets), the frames starting at ``offsets[:-1]`` and the
    last ending at ``offsets[-1]``. Returns each run's int64[F, block]
    samples. The restore's arithmetic is in ``dtype`` (int64 holds it; the
    benchmark's control passes int32, the precision below). Runs are decoded
    a batch of about ``batch_bytes`` at a time."""
    out, batch, size = [], [], 0
    for run in runs:
        batch.append(run)
        size += int(run[1][-1] - run[1][0])
        if size >= batch_bytes:
            out += _decode_batch(batch, depth, dtype)
            batch, size = [], 0
    if batch:
        out += _decode_batch(batch, depth, dtype)
    return out


def _decode_batch(runs, depth: int, dtype) -> list[np.ndarray]:
    parts, shifted, base = [], [], 0
    for stream, offsets in runs:
        offsets = np.asarray(offsets, np.int64)
        parts.append(stream[offsets[0]: offsets[-1]])
        shifted.append(offsets - offsets[0] + base)
        base += int(offsets[-1] - offsets[0])
    buf = b"".join(parts)
    starts = np.concatenate([o[:-1] for o in shifted])
    nexts = np.concatenate([o[1:] for o in shifted])
    lays = [_frame_layout(buf, int(p), depth) for p in starts]
    blocks = {lay["block"] for lay in lays}
    if len(blocks) != 1:
        raise ValueError("the reference decodes one block size at a time")
    n = blocks.pop()
    out = np.zeros((len(lays), n), np.int64)
    lpc = [i for i, lay in enumerate(lays) if lay["kind"] == "lpc"]
    for i, lay in enumerate(lays):
        if lay["kind"] == "constant":
            out[i] = lay["value"]
        elif lay["kind"] == "verbatim":
            out[i] = lay["values"]
    ends = np.array([lay.get("end", 0) for lay in lays], np.int64)
    if lpc:
        orders = {lays[i]["order"] for i in lpc}
        if len(orders) != 1:
            raise ValueError("the reference restores one predictor order at a time")
        order = orders.pop()
        raw = np.frombuffer(buf, np.uint8)
        ones = np.nonzero(np.unpackbits(raw))[0]
        padded = np.concatenate([raw, np.zeros(3, np.uint8)]).astype(np.int64)
        idx = np.arange(len(raw) * 8 + 1, dtype=np.int64)
        b3 = (padded[idx >> 3] << 16) | (padded[(idx >> 3) + 1] << 8) | padded[(idx >> 3) + 2]
        win = (b3 >> (8 - (idx & 7))) & 0xFFFF
        start = np.array([lays[i]["res_bit"] for i in lpc], np.int64)
        pbits = np.array([lays[i]["pbits"] for i in lpc], np.int64)
        psize = np.array([n >> lays[i]["porder"] for i in lpc], np.int64)
        res, endbits = _rice(ones, win, start, pbits, psize, order, n - order)
        ends[lpc] = endbits
        x = np.zeros((len(lpc), n), dtype)
        x[:, :order] = [lays[i]["warm"] for i in lpc]
        rev = np.array([lays[i]["coefs"] for i in lpc], dtype)[:, ::-1]
        shift = np.array([lays[i]["shift"] for i in lpc], dtype)
        res = res.astype(dtype)
        with np.errstate(over="ignore"):
            for t in range(order, n):
                pred = np.einsum("fj,fj->f", x[:, t - order:t], rev)
                x[:, t] = res[:, t - order] + (pred >> shift)
        out[lpc] = x.astype(np.int64)
    # every frame ends byte-aligned, then its CRC-16, where the next begins
    if not np.array_equal(((ends + 7) >> 3) + 2, nexts):
        raise ValueError("a frame does not end where the next begins")
    cuts = np.cumsum([len(o) - 1 for o in shifted])[:-1]
    return np.split(out, cuts)
