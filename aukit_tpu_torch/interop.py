"""Carry lane state across from the JAX package (``aukit_tpu``).

The JAX ``DfpwmState`` is a pytree of five int32[L] arrays; as numpy arrays,
in leaf order (``codecs.dfpwm.FIELDS``), they map one to one onto the port's
``DfpwmState`` tensors. The block-codec kernels' states are tuples of int32
arrays in both packages: IMA (predictor, step_index), int32[L] each; MS
ADPCM (sample1, sample2, delta), int32[L] each; QOA (history, weights),
int32[L, 4] each. Engine checkpoints need no conversion: both packages'
engines write the same keys and types, and each restores the other's. A
decode checkpoint's ``fir_state`` (and its ``dsp`` carries) is a float for
mono engines and an f32[C] row for ``mono=False`` engines; an encode
checkpoint (``BatchEncodeEngine``) holds ``codec_state`` (three ints:
charge, strength, previous bit; ``[]`` for PCM lanes), ``volume``,
``pending`` (int32[C, k] target ints), ``eof`` and ``samples_in``.

An ``Audio`` crosses as its samples, a float32 [C, N] numpy array (the JAX
package's ``np.asarray(audio.data)``), with its rate and dicts.
"""

from __future__ import annotations

import numpy as np
import torch

from .audio import Audio, new_audio
from .codecs.dfpwm import FIELDS, DfpwmState


def dfpwm_state_from_numpy(leaves, device="cpu") -> DfpwmState:
    """Five int32[L] arrays (charge, strength, previous_bit,
    previous_charge, lowpass) -> DfpwmState on ``device``."""
    leaves = list(leaves)
    if len(leaves) != len(FIELDS):
        raise ValueError(f"expected {len(FIELDS)} state arrays, got {len(leaves)}")
    return DfpwmState(*kernel_state_from_numpy(leaves, device))


def dfpwm_state_to_numpy(state: DfpwmState) -> list[np.ndarray]:
    """DfpwmState -> five int32[L] numpy arrays in JAX leaf order."""
    return kernel_state_to_numpy(state.leaves())


def kernel_state_from_numpy(leaves, device="cpu") -> tuple[torch.Tensor, ...]:
    """A block kernel's state as int32 numpy arrays, in the JAX wrapper's
    order -> the tensors the port's kernel takes and returns: IMA
    (predictor, step_index), MS ADPCM (sample1, sample2, delta), QOA
    (history, weights)."""
    return tuple(torch.tensor(np.asarray(a, np.int32), device=device) for a in leaves)


def kernel_state_to_numpy(state) -> list[np.ndarray]:
    """A kernel's state (a tuple of int32 tensors) -> int32 numpy arrays in
    the same order, as the JAX wrappers return them."""
    return [leaf.cpu().numpy().astype(np.int32, copy=False) for leaf in state]


def audio_from_numpy(data, sample_rate: int, metadata: dict | None = None,
                     info: dict | None = None, device="cuda") -> Audio:
    """A JAX ``Audio``'s parts (``np.asarray(audio.data)``, its sample rate,
    metadata and info) -> the port's ``Audio`` on ``device``."""
    return new_audio(np.asarray(data, np.float32), sample_rate, dict(metadata or {}),
                     dict(info or {}), device)


def audio_to_numpy(audio: Audio) -> np.ndarray:
    """The port's ``Audio`` -> its float32 [C, N] samples as numpy, as the JAX
    package's ``np.asarray(audio.data)`` gives them."""
    return audio.numpy()
