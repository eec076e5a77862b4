"""Playback sinks with the reference speaker's back-pressure contract —
counterpart of ``aukit_tpu.playback.sink`` (a copy: host code, numpy only).

The reference plays on ComputerCraft speaker peripherals (N4 in SURVEY.md
§2.3): ``playAudio(samples, volume)`` accepts at most 48000 signed-8-bit
samples, returns False when its buffer is full, and a ``speaker_audio_empty``
event fires on drain. Sinks here keep that contract so the player engines
port 1:1:

 - ``play_audio(samples, volume) -> bool`` (False == try again after drain)
 - ``wait_drain()`` blocks until buffer space frees
 - ``stop()`` drops any buffered audio

Provided sinks: NullSink (rate-paced /dev/null), FileSink (raw or WAV file),
BufferSink (captures everything, for tests), each single-channel like the
reference speaker (the player fans channels out across sinks). Sinks take
host arrays: the playback engines bring each chunk or window to the host
once before it reaches them.
"""

from __future__ import annotations

import threading

import numpy as np

MAX_CHUNK = 48000


class SinkBase:
    """Common buffer/back-pressure machinery."""

    def __init__(self, capacity_samples: int = MAX_CHUNK, realtime: bool = False, rate: int = 48000):
        self.capacity = capacity_samples
        self.realtime = realtime
        self.rate = rate
        self._buffered = 0
        self._lock = threading.Condition()
        self._stopped = False

    def play_audio(self, samples, volume: float | None = None) -> bool:
        samples = np.asarray(samples)
        n = samples.shape[-1]
        if n > MAX_CHUNK:
            raise ValueError(f"chunk too large ({n} > {MAX_CHUNK})")
        with self._lock:
            if self._buffered + n > self.capacity:
                return False
            self._buffered += n
            self._consume(samples, volume)
            if self.realtime:
                # schedule drain after the audio's wall-clock duration
                delay = n / self.rate
                threading.Timer(delay, self._drain, args=(n,)).start()
            else:
                self._buffered -= n
                self._lock.notify_all()
            return True

    def _drain(self, n: int):
        with self._lock:
            self._buffered = max(0, self._buffered - n)
            self._lock.notify_all()

    def wait_drain(self, timeout: float | None = None) -> bool:
        with self._lock:
            if self._buffered == 0:
                return True
            return self._lock.wait(timeout)

    def stop(self):
        with self._lock:
            self._stopped = True
            self._buffered = 0
            self._lock.notify_all()

    def _consume(self, samples: np.ndarray, volume: float | None):  # pragma: no cover
        raise NotImplementedError


class NullSink(SinkBase):
    """Discards audio; with realtime=True it paces like a real speaker."""

    def _consume(self, samples, volume):
        pass


class BufferSink(SinkBase):
    """Captures all samples (int8) for inspection — the test speaker the
    reference lacks (SURVEY.md §4 item 6)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.chunks: list[np.ndarray] = []
        self.volumes: list[float | None] = []

    def _consume(self, samples, volume):
        arr = np.clip(np.floor(np.asarray(samples, np.float64)), -128, 127).astype(np.int8)
        self.chunks.append(arr)
        self.volumes.append(volume)

    def samples(self) -> np.ndarray:
        if not self.chunks:
            return np.zeros(0, np.int8)
        return np.concatenate([c.reshape(-1) for c in self.chunks])


class FileSink(SinkBase):
    """Appends signed 8-bit samples to a file object."""

    def __init__(self, fileobj, **kw):
        super().__init__(**kw)
        self._f = fileobj

    def _consume(self, samples, volume):
        v = 1.0 if volume is None else float(volume)
        arr = np.clip(np.floor(np.asarray(samples, np.float64) * v), -128, 127).astype(np.int8)
        self._f.write(arr.tobytes())
