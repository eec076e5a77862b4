"""Stream-level seek, copied from ``aukit_tpu.stream.seek``: map a target
time to a decodable byte boundary (SURVEY.md §5.4: "seek = re-init from
nearest block boundary; ADPCM/QOA blocks are self-contained; FLAC needs
frame-boundary scan; DFPWM needs decode-from-start or saved state").

``seek_point`` returns (byte_offset, landing_seconds): feed the stream from
``byte_offset`` into the matching ``stream.*`` decoder (or a batch-engine
lane) and audio resumes at ``landing_seconds`` — bit-identical to having
decoded from the start, because these codecs carry their state in-band.

FLAC seeks by a validated frame-sync walk (``flac_seek``): scan for the
14-bit 0x3FFE sync code, check the header's reserved bits / block-size and
rate codes / UTF-8 coded number / CRC8 (the fields the reference's frame
walk reads, aukit.lua:514-553), and land on the last frame starting at or
before the target — FLAC frames carry their warmup in-band, so decode from
a frame boundary is exact.

DFPWM is intentionally absent: its decoder state is NOT in-band, so exact
seek requires either decode-from-start (``Fleet.seek`` decodes the prefix
through the native ``dfpwm_decode_rows``) or a saved checkpoint
(BatchStreamEngine.checkpoint)."""

from __future__ import annotations

import struct


def pcm_seek(seconds: float, sample_rate: int, channels: int = 1,
             bit_depth: int = 16) -> tuple[int, float]:
    """Raw PCM: sample-exact."""
    frame = channels * (bit_depth // 8)
    n = int(seconds * sample_rate)
    return n * frame, n / sample_rate


def g711_seek(seconds: float, sample_rate: int, channels: int = 1) -> tuple[int, float]:
    n = int(seconds * sample_rate)
    return n * channels, n / sample_rate


def ima_seek(seconds: float, sample_rate: int, block_align: int,
             channels: int = 1) -> tuple[int, float]:
    """WAV-layout IMA ADPCM: nearest preceding block boundary (every block
    header re-seeds predictor+step index, aukit.lua:1511)."""
    spb = (block_align - 4 * channels) * 2 // channels
    block = int(seconds * sample_rate) // spb
    return block * block_align, block * spb / sample_rate


def msadpcm_seek(seconds: float, sample_rate: int, block_align: int,
                 channels: int = 1) -> tuple[int, float]:
    """MS ADPCM: block boundary (header carries s1/s2/delta, aukit.lua:1543)."""
    spb = (block_align - 7 * channels) * 2 // channels + 2
    block = int(seconds * sample_rate) // spb
    return block * block_align, block * spb / sample_rate


def qoa_seek(data: bytes, seconds: float) -> tuple[int, float]:
    """QOA: walk the length-prefixed frame headers (LMS state is in-band per
    frame, aukit.lua:1713). ``data`` must start at the 8-byte file header;
    the returned offset points at a frame, so feed ``header + data[off:]``
    or use it with stream.qoa's incremental source."""
    if data[:4] != b"qoaf":
        raise ValueError("Not a QOA file")
    (file_samples,) = struct.unpack_from(">I", data, 4)
    channels = data[8]
    sample_rate = int.from_bytes(data[9:12], "big")
    target = int(seconds * sample_rate)
    pos, sample_pos = 8, 0
    n = len(data)
    while pos + 16 * channels + 8 <= n and sample_pos < min(target, file_samples):
        samples, frame_size = struct.unpack_from(">HH", data, pos + 4)
        if frame_size > n - pos - 8 or sample_pos + samples > target:
            break
        sample_pos += samples
        pos += frame_size
    return pos, sample_pos / sample_rate if sample_rate else 0.0


def _flac_crc8(data) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _flac_utf8(data: bytes, i: int):
    """FLAC's UTF-8-style coded number at data[i] -> (value, next_index) or
    None on malformed coding (used to reject false sync matches)."""
    b0 = data[i]
    if b0 < 0x80:
        return b0, i + 1
    if b0 & 0x40 == 0:  # 10xxxxxx: continuation byte cannot lead
        return None
    count = 0
    mask = 0x40
    while b0 & mask:
        count += 1
        mask >>= 1
    if count > 6 or i + count >= len(data):
        return None
    val = b0 & (mask - 1)
    for k in range(count):
        b = data[i + 1 + k]
        if b & 0xC0 != 0x80:
            return None
        val = (val << 6) | (b & 0x3F)
    return val, i + 1 + count


_BLOCK_FROM_CODE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                    13: 8192, 14: 16384, 15: 32768}


def _flac_frame_header(data: bytes, i: int):
    """Validate a candidate frame header at data[i]. Returns
    (start_is_sample, coded_number, block_size) or None. Checks sync, the
    reserved bits, block-size/rate codes, the coded number's UTF-8 shape and
    the header CRC8 (aukit.lua:514-553 reads these same fields; the byte it
    discards at :553 is this CRC)."""
    try:
        if data[i] != 0xFF or data[i + 1] >> 2 != 0x3E or data[i + 1] & 2:
            return None
        variable = bool(data[i + 1] & 1)
        bs_code, sr_code = data[i + 2] >> 4, data[i + 2] & 0xF
        if bs_code == 0 or sr_code == 15:
            return None
        if data[i + 3] >> 4 > 10 or data[i + 3] & 1:
            return None
        num = _flac_utf8(data, i + 4)
        if num is None:
            return None
        coded, p = num
        if bs_code == 6:
            block = data[p] + 1
            p += 1
        elif bs_code == 7:
            block = (data[p] << 8 | data[p + 1]) + 1
            p += 2
        else:
            block = _BLOCK_FROM_CODE[bs_code]
        if sr_code == 12:
            p += 1
        elif sr_code in (13, 14):
            p += 2
        if _flac_crc8(data[i:p]) != data[p]:
            return None
        return variable, coded, block
    except IndexError:
        return None


def _flac_next_frame(data: bytes, i: int, nominal: int, scanned: list,
                     end: int | None = None):
    """First VALIDATED frame header at or after ``i`` (sync search bounded
    at ``end``): (offset, start_sample, block) or None. ``scanned``
    accumulates probe cost."""
    n = len(data)
    stop = n - 4 if end is None else min(end, n - 4)
    while True:
        j = data.find(b"\xff", i, stop)
        if j < 0:
            return None
        scanned[0] += j - i + 1
        hdr = _flac_frame_header(data, j)
        if hdr is None:
            i = j + 1
            continue
        variable, coded, block = hdr
        return j, (coded if variable else coded * nominal), block


def flac_seek(data: bytes, seconds: float) -> tuple[int, float]:
    """FLAC: estimated-position seek with a validated frame-sync walk.
    ``data`` is the whole file (or its head through the target); returns the
    offset of the last frame starting at or before ``seconds``. Resume by
    feeding ``data[:frame_start] + data[offset:]`` (metadata header + frames
    from the landing) to ``stream.flac`` or ``aukit.flac``.

    When STREAMINFO declares the total sample count, the walk starts from a
    byte-rate first guess (target/total of the audio bytes) and backs off in
    doubling hops until a validated frame at or before the target is found —
    O(probe) instead of O(file) on long streams (the reference has no seek
    at all; frames carry their warmup in-band so landing on any validated
    frame boundary is exact, aukit.lua:514-553). ``flac_seek.last_scanned``
    reports the bytes the probe actually touched (test hook)."""
    from ..codecs.flac import parse_flac_header

    sample_rate, _ch, _depth, num_samples, _meta, fpos = parse_flac_header(data)
    # fixed-blocksize streams code the FRAME INDEX: the constant block size
    # converts it to a sample start. Take it from the stream's own first
    # frame (authoritative — every non-final frame carries it), falling back
    # to STREAMINFO's max-blocksize field for unparseable heads
    h0 = _flac_frame_header(data, fpos)
    nominal = h0[2] if h0 is not None else int.from_bytes(data[10:12], "big")
    target = int(seconds * sample_rate)
    if num_samples:
        target = min(target, num_samples)
    n = len(data)
    scanned = [0]
    best, best_start = fpos, 0
    if num_samples and target > 0 and n - fpos > (1 << 16):
        frac = min(target / num_samples, 1.0)
        guess = fpos + int((n - fpos) * frac)
        step = 1 << 16
        lo = guess
        limit = None  # shrink each probe to the unproven region: beyond it
        # the first frame is either known to overshoot or known absent, so
        # re-scanning there would make a frameless suffix cost O(n log n)
        while lo > fpos:
            lo = max(fpos, lo - step)
            hit = _flac_next_frame(data, lo, nominal, scanned, limit)
            if hit is None:
                limit = lo  # [lo, limit) proven frameless
            elif hit[1] <= target:
                best, best_start = hit[0], hit[1]
                break
            else:
                limit = hit[0]  # first frame from lo overshoots the target
            step *= 2  # overshot (or tail garbage): double the back-off
    # forward walk: last validated frame starting at or before the target
    i = best if best > fpos else fpos
    while True:
        hit = _flac_next_frame(data, i, nominal, scanned)
        if hit is None:
            break
        j, start, _block = hit
        if start > target:
            break
        if start >= best_start:  # frames arrive in order; reject stale hits
            best, best_start = j, start
        i = j + 4
    flac_seek.last_scanned = scanned[0]
    return best, best_start / sample_rate


def wav_data_seek(fmt_code: int, seconds: float, sample_rate: int, channels: int,
                  bit_depth: int, block_align: int) -> tuple[int, float]:
    """Offset within a WAV data chunk for the given fmt code (1/3 PCM float,
    6/7 G.711, 0x11 IMA, 2 MS-ADPCM)."""
    if fmt_code in (1, 3):
        return pcm_seek(seconds, sample_rate, channels, bit_depth)
    if fmt_code in (6, 7):
        return g711_seek(seconds, sample_rate, channels)
    if fmt_code == 0x11:
        return ima_seek(seconds, sample_rate, block_align, channels)
    if fmt_code == 2:
        return msadpcm_seek(seconds, sample_rate, block_align, channels)
    raise ValueError(f"no seek support for fmt code {fmt_code:#x}")
