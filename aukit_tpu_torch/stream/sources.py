"""Byte/sample sources for the stream iterators — counterpart of
``aukit_tpu.stream.sources``.

The reference's stream functions accept a string, a table of values, or a
function returning successive chunks (aukit.lua:2255-2362). The Python
equivalents: ``bytes``, arrays/lists of sample values, callables returning
``bytes | None``, or iterators of ``bytes``. A torch tensor is a value
source like a numpy array (the JAX package's jax array): it stays on its
device, and ``read_frames`` returns float32 frames there.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..audio import mean_channels
from ..ops.pcmcode import normalize_pcm, unpack_pcm


class ByteSource:
    """Pull-based byte buffer over bytes / callable / iterator input."""

    def __init__(self, data, transform: Callable[[bytes], bytes] | None = None):
        self._buf = bytearray()
        self._eof = False
        self._transform = transform
        if isinstance(data, (bytes, bytearray, memoryview)):
            self._buf[:] = bytes(data)
            self._fn = None
            self._eof = True
        elif callable(data):
            self._fn = data
        elif hasattr(data, "__next__") or hasattr(data, "__iter__"):
            it = iter(data)
            self._fn = lambda: next(it, None)
        else:
            raise TypeError(f"unsupported stream source {type(data)!r}")

    def push_front(self, data: bytes):
        self._buf[:0] = data

    def _fill(self, n: int):
        while not self._eof and len(self._buf) < n:
            chunk = self._fn()
            if chunk is None:
                self._eof = True
                break
            if self._transform is not None:
                chunk = self._transform(chunk)
            self._buf.extend(chunk)

    def read(self, n: int) -> bytes:
        """Up to n bytes; shorter only at EOF."""
        self._fill(n)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def read_all(self) -> bytes:
        self._fill(1 << 62)
        out = bytes(self._buf)
        del self._buf[:]
        return out

    def take_buffer(self) -> bytes:
        """Drain only the already-buffered bytes (no new pulls)."""
        out = bytes(self._buf)
        del self._buf[:]
        return out

    def pull_chunk(self):
        """One raw chunk from the underlying source, preserving the caller's
        chunk boundaries (None at EOF). Buffered bytes are returned first."""
        if self._buf:
            return self.take_buffer()
        if self._eof or self._fn is None:
            return None
        chunk = self._fn()
        if chunk is None:
            self._eof = True
            return None
        if self._transform is not None:
            chunk = self._transform(chunk)
        return bytes(chunk)

    @property
    def exhausted(self) -> bool:
        return self._eof and not self._buf


class PcmFrameSource:
    """Decodes an interleaved PCM byte/value source into [C, k] float frames
    with optional mono mixdown (mean over channels, aukit.lua:2367-2371)."""

    def __init__(
        self,
        data,
        bit_depth: int,
        data_type: str,
        channels: int,
        big_endian: bool = False,
        mono: bool = False,
    ):
        self.bit_depth = bit_depth
        self.data_type = data_type
        self.channels = channels
        self.big_endian = big_endian
        self.mono = mono and channels > 1
        self.bytes_per_frame = (bit_depth // 8) * channels
        self._values = None
        self._vpos = 0
        self._bytes = None
        self._device = False
        self.total_frames = None
        # a torch tensor is a VALUE source like a numpy array (the reference's
        # table input), kept on its device: read_frames then returns float32
        # frames there and ChunkResampler routes them through its device twin
        is_tensor = isinstance(data, torch.Tensor)
        if isinstance(data, (bytes, bytearray, memoryview)) or callable(data) or (
            hasattr(data, "__iter__")
            and not isinstance(data, (list, tuple, np.ndarray))
            and not is_tensor
        ):
            self._bytes = ByteSource(data)
            if isinstance(data, (bytes, bytearray, memoryview)):
                self.total_frames = len(data) // self.bytes_per_frame
        else:
            self._device = is_tensor
            self._values = data.reshape(-1) if is_tensor else np.asarray(data)
            self.total_frames = len(self._values) // channels

    def read_frames(self, n: int):
        """Up to n frames as [channels_out, k] float64 (normalized); a tensor
        VALUE source returns float32 frames on its device instead."""
        c = self.channels
        if self._device:
            vals = self._values[self._vpos: self._vpos + n * c]
            self._vpos += vals.shape[0]
            k = vals.shape[0] // c
            v = vals[: k * c].to(torch.float32)
            if self.data_type != "float":
                # a division of two tensors on the device: torch divides by a
                # host scalar as a multiply by its reciprocal
                maxv = float(1 << (self.bit_depth - 1))
                if self.data_type == "signed":
                    v = v / torch.where(v < 0, maxv, maxv - 1)
                else:  # unsigned — reference quirk Q1: pivot/bias fixed at 128
                    v = (v - 128.0) / torch.where(v < 128, maxv, maxv - 1)
            frames = v.reshape(k, c).t()
            return mean_channels(frames) if self.mono else frames.contiguous()
        if self._values is not None:
            vals = self._values[self._vpos: self._vpos + n * c]
            self._vpos += len(vals)
        else:
            raw = self._bytes.read(n * self.bytes_per_frame)
            usable = len(raw) - (len(raw) % self.bytes_per_frame)
            from ..native import flacbits as _nb

            if _nb.available():
                # one-pass native unpack+normalize+mono (bit-identical)
                return _nb.pcm_frames(raw[:usable], self.bit_depth, self.data_type,
                                      self.big_endian, c, self.mono)
            vals = unpack_pcm(raw[:usable], self.bit_depth, self.data_type, self.big_endian)
        k = len(vals) // c
        norm = normalize_pcm(np.asarray(vals[: k * c]), self.bit_depth,
                             self.data_type).astype(np.float64)
        frames = norm.reshape(k, c).T
        if self.mono:
            frames = frames.mean(axis=0, keepdims=True)
        return frames
