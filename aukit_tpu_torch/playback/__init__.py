"""Playback engines (reference aukit.play / aukit.player, aukit.lua:1890-2134)
— counterpart of ``aukit_tpu.playback``.

``play`` is the synchronous engine: a decode thread (the reference's producer
coroutine) fills a bounded queue while the main thread drains chunks to the
sinks, splitting >96000-sample chunks into 48000-sample pieces and retrying on
sink back-pressure — the same overlap of decode and playback the reference
builds from coroutines (SURVEY.md §2.4: its pipeline-parallelism analog).

``player`` is the asynchronous engine with pause/play/seek/stop/live position
(reference Player class, aukit.lua:2007-2134): a loader thread appends decoded
chunks to a growing buffer; a player thread slices 48000-sample windows at the
current position.

``play_fleet`` drains a batched source (``Fleet``, ``FlacFleet``,
``BatchStreamEngine``) to per-station sinks.

Chunks and windows may be torch tensors, on the card too (``stream.pcm``'s
device twin yields CUDA chunks; ``Fleet.step`` returns its windows on the
fleet's device): each is brought to the host once (``_host``), a chunk at a
time, and a fleet window once a step for all its stations, never once a
station. The sinks receive host numpy arrays.
"""

from __future__ import annotations

import bisect
import queue
import threading
import time

import numpy as np
import torch

from .sink import BufferSink, FileSink, NullSink, SinkBase  # noqa: F401


def _host(x) -> np.ndarray:
    """A chunk or window as a host numpy array: one copy of a tensor (a
    device-to-host copy on the card), numpy and lists as they are."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _split_chunks(chunk: np.ndarray):
    """Split chunks >96000 samples into 48000-sample pieces (aukit.lua:1917)."""
    n = chunk.shape[-1]
    if n < 96000:
        return [chunk]
    return [chunk[:, i : i + 48000] for i in range(0, n, 48000)]


def play(iterator, *sinks, progress=None, volume: float | None = None):
    """Drain a stream iterator to one or more sinks (reference aukit.play,
    aukit.lua:1890). Sink i receives channel i (falling back to channel 1,
    aukit.lua:1935). Decode overlaps playback via a producer thread."""
    if not sinks:
        raise ValueError("expected at least one sink")
    q: queue.Queue = queue.Queue(maxsize=8)
    stop = threading.Event()

    def producer():
        try:
            for item in iterator if hasattr(iterator, "__iter__") else iter(iterator, None):
                if stop.is_set():
                    break
                q.put(item)
        finally:
            q.put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            chunk, pos = item
            if progress is not None:
                progress(pos)
            chunk = np.atleast_2d(_host(chunk))
            for piece in _split_chunks(chunk):
                for i, sink in enumerate(sinks):
                    ch = piece[i] if i < piece.shape[0] else piece[0]
                    while not sink.play_audio(ch, volume):
                        sink.wait_drain(timeout=1.0)
    except BaseException:
        # a sink or the progress callback raised: the same exception as the
        # JAX package's play, but the decode thread is stopped and joined
        # first rather than left blocked on a full queue
        stop.set()
        while q.get() is not None:
            pass
        raise
    finally:
        t.join()


def play_fleet(source, sinks, volume=None, progress=None, drop: bool = False,
               queue_windows: int = 4):
    """Drain a BATCHED decode source to per-station sinks concurrently —
    the fleet-scale analog of ``aukit.play``'s producer/consumer pair
    (aukit.lua:1906-1942) applied to the whole batch.

    Parameters
    ----------
    source : anything with ``step() -> (windows, mask, positions) | None``
        (``BatchStreamEngine`` in windowed mode, ``FlacFleet``,
        ``stream.fleet.Fleet``)
    sinks : one sink or a tuple of sinks per station (with multichannel
        ``mono=False`` windows, sink j receives channel j — the reference
        speaker fan-out with its ``chunk[i] or chunk[1]`` fallback,
        aukit.lua:1929-1940)
    volume : forwarded to every ``play_audio`` call (speaker-level volume,
        aukit.lua:1935; per-station decode-side gain lives in
        ``source.set_volume``)
    progress : optional ``progress(station, position_seconds)`` callback
    drop : False (default) blocks the producer while any station's queue is
        full — the reference's lockstep back-pressure. True drops that
        station's OLDEST queued window instead, so one slow sink can never
        stall the batch (§5.3 isolation applied to playback; dropped audio
        is simply skipped, like a radio under-run)
    queue_windows : per-station queue depth (decode runs this far ahead)

    One producer thread steps the source; one consumer thread per station
    drains its sinks with the reference retry-on-False/await-drain loop.
    """
    import queue as _q

    per_station = [s if isinstance(s, (tuple, list)) else (s,) for s in sinks]
    n = len(per_station)
    queues = [_q.Queue(maxsize=max(1, queue_windows)) for _ in range(n)]
    stop = threading.Event()
    errors: list[BaseException] = []

    def _force_put(q, item):
        """Deliver without ever blocking: drop-oldest on a full queue (used
        for sentinels always, and for audio in drop mode — a stuck consumer
        must never wedge the producer)."""
        while True:
            try:
                q.put_nowait(item)
                return
            except _q.Full:
                try:
                    q.get_nowait()
                except _q.Empty:
                    pass

    def producer():
        try:
            while not stop.is_set():
                r = source.step()
                if r is None:
                    if getattr(source, "done", True):
                        break
                    time.sleep(0.005)  # starved, not done: await more feeds
                    continue
                windows, mask, positions = r
                host = _host(windows)  # one copy a step, for every station
                for i in range(n):
                    if i >= len(mask) or not mask[i]:
                        continue
                    if progress is not None:
                        progress(i, float(positions[i]))
                    item = host[i]
                    if drop:
                        _force_put(queues[i], item)
                    else:
                        while not stop.is_set():
                            try:
                                queues[i].put(item, timeout=0.5)
                                break
                            except _q.Full:
                                continue  # re-check stop: a dead consumer's
                                # queue must not wedge the fleet forever
        except BaseException as e:  # surfaced to the caller after joins
            errors.append(e)
            stop.set()
        finally:
            for q in queues:
                # let a live consumer drain its backlog first; only a truly
                # wedged one has its items displaced so the sentinel lands
                for _ in range(20):
                    try:
                        q.put(None, timeout=0.5)
                        break
                    except _q.Full:
                        continue
                else:
                    _force_put(q, None)

    def consumer(i: int):
        my_sinks = per_station[i]
        try:
            while True:
                item = queues[i].get()
                if item is None:
                    return
                chunk = np.atleast_2d(item)
                for piece in _split_chunks(chunk):
                    for j, sink in enumerate(my_sinks):
                        ch = piece[j] if j < piece.shape[0] else piece[0]
                        tries = 0
                        while not sink.play_audio(ch, volume) \
                                and not stop.is_set():
                            sink.wait_drain(timeout=1.0)
                            tries += 1
                            if drop and tries >= 3:
                                break  # drop semantics extend to the sink:
                                # a refusing speaker loses this piece rather
                                # than wedging the station (and the joins)
        except BaseException as e:  # a raising sink must not hang the fleet:
            errors.append(e)  # keep draining so the producer never blocks
            while True:
                item = queues[i].get()
                if item is None:
                    return

    threads = [threading.Thread(target=producer, daemon=True)]
    threads += [threading.Thread(target=consumer, args=(i,), daemon=True)
                for i in range(n)]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join()
    finally:
        stop.set()
    if errors:
        raise errors[0]


class Player:
    """Async player (reference aukit.player / Player, aukit.lua:2007-2134)."""

    def __init__(self, iterator, *sinks, volume: float | None = None):
        if not sinks:
            raise ValueError("expected at least one sink")
        self.sinks = sinks
        self.volume = volume
        self.is_paused = False
        self.position = 0.0  # seconds
        # decoded history as a chunk list + start-offset index: appending is
        # amortized O(1) like the reference's Lua table (aukit.lua:2085-2101);
        # a growing np.concatenate would copy O(n^2) bytes over a long stream
        self._chunks: list[np.ndarray] = []
        self._starts: list[int] = []  # start sample of each chunk
        self._decoded_len = 0
        self._lock = threading.Condition()
        self._stop = False
        self.last_playback: tuple[float, int] | None = None  # (wall time, sample pos)
        self._loader = threading.Thread(target=self._load, args=(iterator,), daemon=True)
        self._player = threading.Thread(target=self._play_loop, daemon=True)
        self._loader_done = False
        self._loader.start()
        self._player.start()

    # -- loader task (aukit.lua:2085-2101) --------------------------------------
    def _load(self, iterator):
        try:
            for chunk, _pos in iterator if hasattr(iterator, "__iter__") else iter(iterator, None):
                chunk = np.atleast_2d(_host(chunk).astype(np.float32, copy=False))
                with self._lock:
                    self._chunks.append(chunk)
                    self._starts.append(self._decoded_len)
                    self._decoded_len += chunk.shape[1]
                    self._lock.notify_all()
                if self._stop:
                    return
        finally:
            with self._lock:
                self._loader_done = True
                self._lock.notify_all()

    def _window(self, spos: int, n: int) -> np.ndarray:
        """Slice [spos, spos+n) across chunk boundaries (lock held)."""
        end = min(spos + n, self._decoded_len)
        i = bisect.bisect_right(self._starts, spos) - 1
        pieces = []
        while spos < end:
            c, s = self._chunks[i], self._starts[i]
            take = c[:, spos - s : end - s]
            pieces.append(take)
            spos += take.shape[1]
            i += 1
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=1)

    # -- player task (aukit.lua:2102-2132) ---------------------------------------
    def _play_loop(self):
        while not self._stop:
            with self._lock:
                # round, don't truncate: position accumulates float chunk
                # durations, and int() on 111104.9999... would replay a sample
                spos = int(round(self.position * 48000))
                ready = (
                    not self.is_paused
                    and self._decoded_len > 0
                    and spos < self._decoded_len
                )
                if not ready:
                    if self._loader_done and not self.is_paused and self._decoded_len > 0 and spos >= self._decoded_len:
                        return  # end of stream (aukit.lua:2125-2127)
                    self._lock.wait(timeout=0.05)
                    continue
                window = self._window(spos, 48000)
                self.position += window.shape[1] / 48000
            for i, sink in enumerate(self.sinks):
                ch = window[i] if i < window.shape[0] else window[0]
                while not sink.play_audio(ch, self.volume) and not self._stop:
                    sink.wait_drain(timeout=0.5)
            self.last_playback = (time.monotonic(), spos)

    # -- controls -------------------------------------------------------------
    def pause(self):
        """aukit.lua:2011: stop sinks, estimate position from wall clock."""
        if self.is_paused:
            return
        now = time.monotonic()
        self.is_paused = True
        for s in self.sinks:
            s.stop()
        if self.last_playback is not None:
            t0, spos = self.last_playback
            self.position = (spos + (now - t0) * 48000 - 1) / 48000

    def play(self):
        if not self.is_paused:
            return
        self.is_paused = False
        with self._lock:
            self._lock.notify_all()

    def live_position(self) -> float:
        """aukit.lua:2030: extrapolate from the last playback timestamp."""
        if self.last_playback is None:
            return 0.0
        if self.is_paused:
            return self.position
        t0, spos = self.last_playback
        return (spos + (time.monotonic() - t0) * 48000 - 1) / 48000

    def seek(self, pos: float):
        """aukit.lua:2041: set position and stop sinks; playback resumes once
        the target is loaded."""
        if pos < 0:
            raise ValueError("position out of range")
        with self._lock:
            self.position = float(pos)
            self._lock.notify_all()
        for s in self.sinks:
            s.stop()

    def stop(self):
        self._stop = True
        with self._lock:
            self._lock.notify_all()
        for s in self.sinks:
            s.stop()

    def join(self, timeout=None):
        self._player.join(timeout)


def player(iterator, *sinks, volume: float | None = None) -> Player:
    """Create an async Player (reference aukit.player, aukit.lua:2067 — the
    Taskmaster loop is replaced by host threads)."""
    return Player(iterator, *sinks, volume=volume)
