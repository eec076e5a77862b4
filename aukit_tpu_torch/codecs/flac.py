"""FLAC decoder, host side — counterpart of ``aukit_tpu.codecs.flac``: the
bitstream parse (copied), the int64 LPC-restore oracle, the flat restore
entry point the FLAC fleet calls, and the stereo decorrelation.

Reference: the embedded Simple-FLAC port in aukit.lua:311-619 (itself derived
from Project Nayuki's simple FLAC implementation). Parity targets that
implementation exactly, including its quirks:
 - CRC8/CRC16 are read and ignored.
 - samples are normalized by 2^sampleDepth (NOT 2^(depth-1)), i.e. the loader
   emits half-scale floats in [-0.5, 0.5) (aukit.lua:524-526).
 - the one-sided sign wrap ``if s >= 2^(d-1) then s -= 2^d`` is applied after
   stereo decorrelation (aukit.lua:522-524).
 - LPC shift is read as a *signed* 5-bit value (aukit.lua:434).

The variable-length bitstream walk (frame headers, Rice residuals) is
sequential and data-dependent, so it runs on the host (native C++ when it
builds, else the Python BitReader); the LPC restore is batched across every
subframe of every frame and stream (``restore_flat``), on the card through
``kernels.flac_cuda.lpc_restore_kernel``.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..config import CONFIG, require_device

FIXED_COEFFS = [[], [1], [2, -1], [3, -3, 1], [4, -6, 4, -1]]

FLAC_METADATA_KEYS = {
    "tracknumber": "trackNumber", "encoded-by": "encodedBy",
    "sourcemedia": "sourceMedia", "labelno": "labelNumber",
    "discnumber": "discNumber", "partnumber": "partNumber",
    "productnumber": "productNumber", "catalognumber": "catalogNumber",
    "release date": "releaseDate", "source medium": "sourceMedium",
    "source artist": "sourceArtist", "guest artist": "guestArtist",
    "source work": "sourceWork", "disctotal": "discCount",
    "tracktotal": "trackCount", "parttotal": "partCount", "tcm": "composer",
}

# the card's restore is exact for streams of at most this depth (the JAX
# package's limb kernel's domain); deeper streams restore on the host in int64
DEVICE_MAX_DEPTH = 24


class FlacError(ValueError):
    pass


class BitReader:
    """Bit-level reader over bytes (reference BitInputStream, aukit.lua:342-378).
    ``read_uint`` returns None at clean EOF (mid-read EOF raises FlacError)."""

    __slots__ = ("data", "pos", "buf", "n")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.buf = 0
        self.n = 0

    def align_to_byte(self):
        drop = self.n % 8
        self.n -= drop
        self.buf &= (1 << self.n) - 1

    def read_uint(self, bits: int):
        if bits == 0:
            return 0
        while self.n < bits:
            if self.pos >= len(self.data):
                return None
            self.buf = (self.buf << 8) | self.data[self.pos]
            self.pos += 1
            self.n += 8
        self.n -= bits
        res = self.buf >> self.n
        self.buf &= (1 << self.n) - 1
        return res

    def require_uint(self, bits: int) -> int:
        v = self.read_uint(bits)
        if v is None:
            raise FlacError("unexpected end of FLAC stream")
        return v

    def read_signed(self, bits: int) -> int:
        v = self.require_uint(bits)
        if bits and v >= 1 << (bits - 1):
            v -= 1 << bits
        return v

    def read_unary(self) -> int:
        q = 0
        while True:
            if self.n == 0:
                if self.pos >= len(self.data):
                    raise FlacError("unexpected end of FLAC stream")
                self.buf = self.data[self.pos]
                self.pos += 1
                self.n = 8
            if self.buf == 0:
                q += self.n
                self.n = 0
                continue
            top = self.buf.bit_length()
            q += self.n - top
            self.n = top - 1
            self.buf &= (1 << self.n) - 1
            return q

    def read_rice_signed(self, param: int) -> int:
        val = (self.read_unary() << param) | self.require_uint(param)
        if val & 1:
            return -(val >> 1) - 1
        return val >> 1


def decode_residuals(inp: BitReader, warmup: int, block_size: int, result: list):
    """Rice-partitioned residuals (aukit.lua:380-409)."""
    method = inp.require_uint(2)
    if method >= 2:
        raise FlacError(f"Reserved residual coding method {method}")
    param_bits = 4 if method == 0 else 5
    escape = 0xF if method == 0 else 0x1F
    partition_order = inp.require_uint(4)
    num_partitions = 1 << partition_order
    if block_size % num_partitions != 0:
        raise FlacError("Block size not divisible by number of Rice partitions")
    partition_size = block_size // num_partitions
    for i in range(num_partitions):
        start = i * partition_size + (warmup if i == 0 else 0)
        end = (i + 1) * partition_size
        param = inp.require_uint(param_bits)
        if param < escape:
            rr = inp.read_rice_signed
            for j in range(start, end):
                result[j] = rr(param)
        else:
            num_bits = inp.require_uint(5)
            rs = inp.read_signed
            for j in range(start, end):
                result[j] = rs(num_bits)


def decode_subframe(inp: BitReader, sample_depth: int, block_size: int):
    """One subframe (aukit.lua:443-470) -> dict with pre-restore samples."""
    inp.require_uint(1)
    stype = inp.require_uint(6)
    shift_w = inp.require_uint(1)
    if shift_w == 1:
        while inp.require_uint(1) == 0:
            shift_w += 1
    depth = sample_depth - shift_w
    sub = {"wasted": shift_w, "order": 0, "coefs": [], "shift": 0}
    if stype == 0:
        c = inp.read_signed(depth)
        sub["values"] = [c] * block_size
    elif stype == 1:
        rs = inp.read_signed
        sub["values"] = [rs(depth) for _ in range(block_size)]
    elif 8 <= stype <= 12:
        order = stype - 8
        # order may exceed block_size on crafted input: the reference's Lua
        # tables grow past block_size during warmup and the frame still emits
        # block_size samples — allocate the max, truncate after
        vals = [0] * max(block_size, order)
        for i in range(order):
            vals[i] = inp.read_signed(depth)
        decode_residuals(inp, order, block_size, vals)
        sub.update(values=vals[:block_size], order=order,
                   coefs=list(FIXED_COEFFS[order]), shift=0)
    elif 32 <= stype <= 63:
        order = stype - 31
        vals = [0] * max(block_size, order)
        for i in range(order):
            vals[i] = inp.read_signed(depth)
        precision = inp.require_uint(4) + 1
        shift = inp.read_signed(5)
        coefs = [inp.read_signed(precision) for _ in range(order)]
        decode_residuals(inp, order, block_size, vals)
        sub.update(values=vals[:block_size], order=order, coefs=coefs, shift=shift)
    else:
        raise FlacError("Reserved subframe type")
    return sub


def decode_frame_header(inp: BitReader):
    """Frame header walk (aukit.lua:510-553). Returns (block_size, chan_asgn)
    or None at clean EOF."""
    temp = inp.read_uint(8)
    if temp is None:
        return None
    sync = temp * 64 + inp.require_uint(6)
    if sync != 0x3FFE:
        raise FlacError("Sync code expected")
    inp.require_uint(2)
    block_size_code = inp.require_uint(4)
    sample_rate_code = inp.require_uint(4)
    chan_asgn = inp.require_uint(4)
    inp.require_uint(4)
    temp = inp.require_uint(8)
    t2 = -1
    for i in range(7, -1, -1):
        if not (temp & (1 << i)):
            break
        t2 += 1
    for _ in range(t2):
        inp.require_uint(8)
    if block_size_code == 1:
        block_size = 192
    elif 2 <= block_size_code <= 5:
        block_size = 576 << (block_size_code - 2)
    elif block_size_code == 6:
        block_size = inp.require_uint(8) + 1
    elif block_size_code == 7:
        block_size = inp.require_uint(16) + 1
    elif 8 <= block_size_code <= 15:
        block_size = 256 << (block_size_code - 8)
    else:
        raise FlacError("Reserved block size")
    if sample_rate_code == 12:
        inp.require_uint(8)
    elif sample_rate_code in (13, 14):
        inp.require_uint(16)
    inp.require_uint(8)  # CRC8, ignored (parity with aukit.lua:553)
    return block_size, chan_asgn


def parse_flac_header(data: bytes):
    """Magic + metadata blocks (aukit.lua:569-607). Returns
    (sample_rate, channels, depth, num_samples, metadata, frame_start_pos)."""
    if data[:4] != b"fLaC":
        raise FlacError("Invalid magic string")
    pos = 4
    sample_rate = channels = depth = num_samples = None
    meta: dict = {}
    last = False
    while not last:
        head = data[pos]
        pos += 1
        last = bool(head & 0x80)
        btype = head & 0x7F
        length = int.from_bytes(data[pos: pos + 3], "big")
        pos += 3
        if btype == 0:  # STREAMINFO
            p = pos + 10
            sr16 = int.from_bytes(data[p: p + 2], "big")
            sample_rate = sr16 * 16 + (data[p + 2] >> 4)
            channels = ((data[p + 2] >> 1) & 7) + 1
            depth = (data[p + 2] & 1) * 16 + (data[p + 3] >> 4) + 1
            num_samples = (int.from_bytes(data[p + 4: p + 8], "big")
                           + (data[p + 3] & 15) * (1 << 32))
            pos += length
        elif btype == 4:  # Vorbis comment
            (vlen,) = struct.unpack_from("<I", data, pos)
            p = pos + 4 + vlen
            meta["vendor"] = data[pos + 4: p].decode("utf-8", "replace")
            (ncomments,) = struct.unpack_from("<I", data, p)
            p += 4
            for _ in range(ncomments):
                (slen,) = struct.unpack_from("<I", data, p)
                s = data[p + 4: p + 4 + slen].decode("utf-8", "replace")
                # reference squashes to latin-1 with '?' for >0xFF (utf8decode)
                s = "".join(ch if ord(ch) <= 0xFF else "?" for ch in s)
                p += 4 + slen
                if "=" in s:
                    k, v = s.split("=", 1)
                    if k:
                        meta[FLAC_METADATA_KEYS.get(k.lower(), k.lower())] = v
            pos += length
        else:
            pos += length
    if sample_rate is None:
        raise FlacError("Stream info metadata block absent")
    if depth % 8 != 0:
        raise FlacError("Sample depth not supported")
    return sample_rate, channels, depth, num_samples, meta, pos


def restore_lpc_batch(values: np.ndarray, coefs: np.ndarray, shifts: np.ndarray,
                      orders: np.ndarray):
    """Batched LPC restore (aukit.lua:411-419): values[L, T] int64 containing
    warmup+residuals, coefs[L, 32] (coef j at column j), shifts[L], orders[L].
    In-place over a copy; time sequential, lanes vectorized.

    result[i] += floor(sum_j result[i-1-j]*coefs[j] / 2^shift) for i >= order.
    Negative shift (signed 5-bit field) multiplies instead.
    """
    out = values.astype(np.int64)
    L, T = out.shape
    max_order = int(orders.max()) if L else 0
    if max_order == 0 or T == 0:
        return out
    coefs = coefs.astype(np.int64)
    pos_shift = np.maximum(shifts, 0).astype(np.int64)
    neg_shift = np.maximum(-shifts, 0).astype(np.int64)
    active_from = orders  # lane updates only for i >= order (and order >= 1)
    has_pred = orders >= 1
    for i in range(1, T):
        o = min(i, 32)
        window = out[:, i - o: i]  # oldest..newest
        c = coefs[:, :o]  # coef j multiplies result[i-1-j] => reverse window
        s = np.einsum("lk,lk->l", window[:, ::-1], c, dtype=np.int64)
        pred = (s << neg_shift) >> pos_shift
        upd = has_pred & (i >= active_from)
        out[:, i] = np.where(upd, out[:, i] + pred, out[:, i])
    return out


def parse_all_frames(data: bytes, pos: int, channels: int, depth: int,
                     use_native: bool | None = None, strict: bool = True,
                     incremental: bool = False):
    """Parse every frame -> flat arrays:
    (frame_meta int32[F,2] (block_size, chan_asgn),
     sub_meta {order, shift, wasted, block} int64[S],
     coefs int64[S,32], values_flat int64[sum(block)]).

    With ``incremental=True`` a fifth element is returned — the byte offset
    just past the last committed frame — and a tail frame whose CRC16 bytes
    are absent is NOT committed (streaming: more bytes are coming).

    Uses the native C++ parser (native/flacbits.cpp) when available, else the
    pure-Python BitReader path; both are bit-identical.
    """
    from ..native import flacbits as _nb

    if use_native is None:
        use_native = _nb.available()
    if use_native:
        return _nb.parse_frames(data, pos, channels, depth, strict, incremental)
    inp = BitReader(data, pos)
    fbs, fca = [], []
    orders, shifts, wasted, blocks = [], [], [], []
    coefs_rows = []
    values = []
    end_pos = pos
    while True:
        try:
            hdr = decode_frame_header(inp)
            if hdr is None:
                break
            block_size, chan_asgn = hdr
            subs = []
            if 0 <= chan_asgn <= 7:
                for _ in range(channels):
                    subs.append(decode_subframe(inp, depth, block_size))
            elif 8 <= chan_asgn <= 10:
                subs.append(decode_subframe(inp, depth + (1 if chan_asgn == 9 else 0), block_size))
                subs.append(decode_subframe(inp, depth + (0 if chan_asgn == 9 else 1), block_size))
            else:
                raise FlacError("Reserved channel assignment")
        except FlacError:
            if strict:
                raise
            break
        inp.align_to_byte()
        crc = inp.read_uint(16)  # CRC16 footer, ignored (may hit clean EOF)
        if incremental and crc is None:
            break  # tentative tail frame: commit once its CRC bytes arrive
        fbs.append(block_size)
        fca.append(chan_asgn)
        end_pos = inp.pos - inp.n // 8
        for s in subs:
            orders.append(s["order"])
            shifts.append(s["shift"])
            wasted.append(s["wasted"])
            blocks.append(block_size)
            row = np.zeros(32, np.int64)
            if s["order"]:
                row[: s["order"]] = s["coefs"]
            coefs_rows.append(row)
            values.extend(s["values"])
    frame_meta = (np.stack([np.array(fbs, np.int32), np.array(fca, np.int32)], axis=1)
                  if fbs else np.zeros((0, 2), np.int32))
    sub = {
        "order": np.array(orders, np.int64),
        "shift": np.array(shifts, np.int64),
        "wasted": np.array(wasted, np.int64),
        "block": np.array(blocks, np.int64),
    }
    coefs = np.stack(coefs_rows) if coefs_rows else np.zeros((0, 32), np.int64)
    if incremental:
        return frame_meta, sub, coefs, np.array(values, np.int64), end_pos
    return frame_meta, sub, coefs, np.array(values, np.int64)


def restore_flat(sub, coefs, values_flat, depth: int, device: bool | None = None,
                 mesh=None, *, on="cpu"):
    """Batched LPC restore (+ wasted-bits shift) over a FLAT subframe batch:
    one contiguous span of warmup+residuals per subframe (the parser layout).
    Returns restored_flat int64[sum(block)].

    The batch may span many independent streams (the FLAC fleet): subframes
    are independent lanes, so the whole fleet restores in one call.
    ``device=None`` decides as the JAX package does: the device route when
    ``on`` is a CUDA device (the JAX package's TPU backend) and the batch,
    ``S * T_max``, is at least ``CONFIG.flac_device_restore_min``; the host
    route otherwise. A route to CUDA without a card raises, as
    ``require_device`` does. With
    ``device=True`` the rows are staged as int32[S, T_max] and restored on
    the torch device ``on`` by ``lpc_restore_kernel`` (``lpc_restore_sharded``
    over that one device): the CUDA kernel on a card, its plain version on
    the CPU (the JAX package's interpret mode). ``depth`` must be the batch's maximum: a batch deeper than 24 bits
    stays on the host, as in the JAX package, and so does a malformed batch
    whose warm-up or residuals leave int32 (one host check of their minimum
    and maximum before staging). A malformed stream whose unstable predictor
    drives restored samples out of int32 is restored on ``on`` all the same:
    the kernel reports the rows whose int32 store wrapped, and those rows
    are restored again in int64 rows by the kernel's wide entry point, on
    the same device, as the JAX package's host restore keeps them in int64.
    With a ``mesh`` (``parallel.pipeline.make_mesh``) the rows are split
    over its shards instead, each restored on its device
    (``lpc_restore_sharded``, wrapped rows included), unless ``device`` is
    an explicit False: the host opt-out wins over the mesh, as in the JAX
    package. Otherwise (the host route) the native C++ in-place restore
    runs, else the numpy batch."""
    S = len(sub["order"])
    if S == 0:
        return np.zeros(0, np.int64)
    offs = np.concatenate([[0], np.cumsum(sub["block"])])
    T_max = int(sub["block"].max())
    keep = np.arange(T_max)[None, :] < np.asarray(sub["block"])[:, None]
    host_forced = device is False  # an explicit opt-out beats the mesh
    if device is None:
        device = (torch.device(on).type == "cuda"
                  and S * T_max >= CONFIG.flac_device_restore_min)
    routed = not host_forced and (device or mesh is not None)
    if routed and depth <= DEVICE_MAX_DEPTH and _fits_int32(values_flat):
        from ..kernels.flac_cuda import lpc_restore_sharded
        from ..parallel.mesh import device_mesh

        if mesh is None:
            require_device(on, "restore_flat")
        # staging scatters the flat values in one masked assignment
        # (row-major order == the parser's span order)
        vals = np.zeros((S, T_max), np.int32)
        vals[keep] = values_flat
        restored = lpc_restore_sharded(vals, sub["order"], sub["shift"], sub["block"], coefs,
                                       device_mesh(on) if mesh is None else mesh).cpu().numpy()
        restored <<= sub["wasted"][:, None]
        return restored[keep]
    from ..native import flacbits as _nb

    if _nb.available():
        return _nb.restore_lpc_flat(
            values_flat, offs[:-1], sub["block"], sub["order"], sub["shift"],
            sub["wasted"], coefs)
    vals = np.zeros((S, T_max), np.int64)
    vals[keep] = values_flat
    restored = restore_lpc_batch(vals, coefs, sub["shift"], sub["order"])
    restored <<= sub["wasted"][:, None]
    return restored[keep]


def _fits_int32(values: np.ndarray) -> bool:
    """Whether every warm-up and residual value fits the int32 rows kernel
    (g) restores: one host pass over the batch's minimum and maximum."""
    return values.size == 0 or (int(values.min()) >= -(1 << 31)
                                and int(values.max()) < (1 << 31))


def restore_and_decorrelate(frame_meta, sub, coefs, values_flat, channels: int, depth: int,
                            device="cuda"):
    """Batched LPC restore across all subframes on ``device`` (kernel (g);
    a stream deeper than 24 bits stays on the host, as in the JAX package),
    then per-frame stereo decorrelation + sign wrap on the host. Returns
    int64[C, N] raw samples."""
    device = require_device(device, "restore_and_decorrelate")
    if len(sub["order"]) == 0:
        return np.zeros((channels, 0), np.int64)
    restored_flat = restore_flat(sub, coefs, values_flat, depth, device=True, on=device)
    return decorrelate_frames(frame_meta, sub["block"], restored_flat, channels, depth)


def decorrelate_frames(frame_meta, blocks, restored_flat, channels: int, depth: int):
    """Per-frame stereo decorrelation + sign wrap over restored samples.
    ``blocks`` is the per-subframe block-length array (parser order); returns
    int64[C, N]. The typical uniform file (constant block size + one stereo
    mode, short final frame at most) decorrelates in one vectorized reshape
    pass."""
    if len(frame_meta) == 0:
        return np.zeros((channels, 0), np.int64)
    offs = np.concatenate([[0], np.cumsum(blocks)])
    half = 1 << (depth - 1)
    full = 1 << depth
    fbs = frame_meta[:, 0].astype(np.int64)
    fca = frame_meta[:, 1].astype(np.int64)
    uniform = (fbs == fbs[0]) & (fca == fca[0])
    F0 = int(np.argmin(uniform)) if not uniform.all() else len(frame_meta)
    parts = []
    idx = 0
    if F0:
        block_size, chan_asgn = int(fbs[0]), int(fca[0])
        nsubs = channels if chan_asgn <= 7 else 2
        rows = restored_flat[: F0 * nsubs * block_size].reshape(F0, nsubs, block_size)
        chans = decorrelate(np.moveaxis(rows, 1, 0), chan_asgn)
        out = np.zeros((channels, F0, block_size), np.int64)
        for c in range(min(channels, len(chans))):
            out[c] = chans[c]
        out = np.where(out >= half, out - full, out)
        parts.append(out.reshape(channels, -1))
        idx = F0 * nsubs
    out_chunks = [[] for _ in range(channels)]
    for block_size, chan_asgn in frame_meta[F0:]:
        block_size = int(block_size)
        nsubs = channels if chan_asgn <= 7 else 2
        rows = np.stack([
            restored_flat[offs[idx + c]: offs[idx + c] + block_size]
            for c in range(nsubs)
        ])
        idx += nsubs
        chans = decorrelate(rows, int(chan_asgn))
        for c in range(channels):
            s = chans[c] if c < len(chans) else np.zeros(block_size, np.int64)
            s = np.where(s >= half, s - full, s)
            out_chunks[c].append(s)
    if out_chunks[0]:
        parts.append(np.stack([np.concatenate(ch) for ch in out_chunks]))
    return np.concatenate(parts, axis=1) if parts else np.zeros((channels, 0), np.int64)


def decorrelate(rows: np.ndarray, chan_asgn: int):
    """Stereo decorrelation (aukit.lua:479-502)."""
    if 0 <= chan_asgn <= 7:
        return [rows[c] for c in range(rows.shape[0])]
    a, b = rows[0].copy(), rows[1].copy()
    if chan_asgn == 8:  # left/side
        b = a - b
    elif chan_asgn == 9:  # side/right
        a = a + b
    else:  # mid/side
        side = b
        right = a - (side >> 1)
        b = right
        a = right + side
    return [a, b]


def decode_flac(data: bytes, head: bool = False, use_native: bool | None = None, *,
                device="cuda"):
    """Full decode -> (float32[C, N] in [-0.5, 0.5) (numpy), sample_rate,
    meta, depth): the host parse (native C++ when it builds), the LPC
    restore of every subframe at once on ``device`` (kernel (g)), the stereo
    decorrelation on the host, and the float64 normalise by 2^depth (the
    JAX package's staged path, its parity oracle). ``use_native``: None parses
    natively when the library builds; False parses in Python; True runs
    the JAX package's native route: one fused C++ pass on the host (parse,
    restore, decorrelation and normalise: ``flacbits.decode_full``; no
    kernel), and raises when the library does not build."""
    device = require_device(device, "decode_flac")
    sample_rate, channels, depth, num_samples, meta, pos = parse_flac_header(data)
    if head:
        return np.zeros((channels, 0), np.float32), sample_rate, meta, depth
    if use_native:
        from ..native import flacbits as _nb

        return _nb.decode_full(data, pos, channels, depth), sample_rate, meta, depth
    frame_meta, sub, coefs, values = parse_all_frames(data, pos, channels, depth, use_native)
    arr = restore_and_decorrelate(frame_meta, sub, coefs, values, channels, depth, device)
    norm = (arr.astype(np.float64) / (1 << depth)).astype(np.float32)
    return norm, sample_rate, meta, depth


def decode_flac_audio(data: bytes, head: bool = False, device="cuda"):
    """reference aukit.flac (aukit.lua:1657): an Audio on ``device``."""
    from ..audio import new_audio

    device = require_device(device, "decode_flac_audio")
    arr, sample_rate, meta, depth = decode_flac(data, head, device=device)
    return new_audio(arr, sample_rate, meta, {"bitDepth": depth, "dataType": "signed"}, device)
