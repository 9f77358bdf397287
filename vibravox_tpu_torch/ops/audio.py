"""Audio shaping helpers: pad, crop, fixed duration, speech/noise mixing.

Counterpart of ``vibravox_tpu/ops/audio.py`` (the reference's
``vibravox/utils.py:7-254``) on ``(..., time)`` tensors.  Random offsets
come from a numpy ``Generator`` where the JAX package takes a
``jax.random`` key: the same function, another random stream.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "pad_audio",
    "slice_audio",
    "set_audio_duration",
    "mix_speech_and_noise_with_rescaling",
    "mix_speech_and_noise_without_rescaling",
]


def pad_audio(audio: torch.Tensor, desired_samples: int) -> torch.Tensor:
    """Zero-pad the trailing axis symmetrically to ``desired_samples``
    (left ``(desired - initial) // 2``, as the JAX package does; the
    reference's ``desired - initial // 2`` truncates short inputs)."""
    initial = audio.shape[-1]
    if initial > desired_samples:
        raise ValueError("The audio signal is longer than the desired duration. Use set_audio_duration instead.")
    left = (desired_samples - initial) // 2
    return F.pad(audio, (left, desired_samples - initial - left))


def slice_audio(audio: torch.Tensor, desired_samples: int, offset_samples: int) -> torch.Tensor:
    """``desired_samples`` of the trailing axis from ``offset_samples``."""
    if audio.shape[-1] < desired_samples:
        raise ValueError("The audio signal is shorter than the desired duration. Use pad_audio instead.")
    return audio[..., int(offset_samples):int(offset_samples) + desired_samples]


def set_audio_duration(
    audio: torch.Tensor,
    desired_samples: int,
    audio_bis: Optional[torch.Tensor] = None,
    deterministic: bool = False,
    rng: Optional[np.random.Generator] = None,
):
    """Crop (at a random offset, or centred when ``deterministic``) or pad
    to ``desired_samples``; ``audio_bis`` takes the same offset, which keeps
    a sensor pair aligned (``vibravox/utils.py:50-81``)."""
    initial = audio.shape[-1]
    if audio_bis is not None and audio.shape != audio_bis.shape:
        raise ValueError("The two audio signals must have the same shape.")
    if initial >= desired_samples:
        if deterministic:
            offset = (initial - desired_samples) // 2
        elif rng is None:
            raise ValueError("a generator is required for a random crop")
        else:
            offset = int(rng.integers(0, initial - desired_samples + 1))
        fix = lambda a: slice_audio(a, desired_samples, offset)  # noqa: E731
    else:
        fix = lambda a: pad_audio(a, desired_samples)  # noqa: E731
    return (fix(audio), fix(audio_bis)) if audio_bis is not None else fix(audio)


def _check_pairs(speech_batch: Sequence[torch.Tensor], noise_batch: Sequence[torch.Tensor]) -> None:
    if len(speech_batch) != len(noise_batch):
        raise ValueError("speech_batch and noise_batch must have the same length")
    for speech, noise in zip(speech_batch, noise_batch):
        if speech.ndim != 1 or noise.ndim != 1:
            raise ValueError("Each sample must be a 1D tensor")
        if noise.shape[-1] < speech.shape[-1]:
            raise ValueError("noise must be at least as long as speech")


def _noise_slice(noise: torch.Tensor, speech_len: int, rng: np.random.Generator) -> torch.Tensor:
    start = int(rng.integers(0, noise.shape[-1] - speech_len))
    return noise[start:start + speech_len]


def mix_speech_and_noise_with_rescaling(
    speech_batch: List[torch.Tensor],
    noise_batch: List[torch.Tensor],
    rng: np.random.Generator,
    snr_range: Tuple[float, float] = (-3.0, 5.0),
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Add to each speech a slice of its noise scaled to a uniform random
    SNR in dB (``vibravox/utils.py:118-193``).  Returns the corrupted
    speech and the scaled noise slices."""
    _check_pairs(speech_batch, noise_batch)
    corrupted, scaled = [], []
    for speech, noise in zip(speech_batch, noise_batch):
        noise_sliced = _noise_slice(noise, speech.shape[-1], rng)
        snr = rng.uniform(snr_range[0], snr_range[1])
        scale = torch.sqrt(torch.mean(speech**2) / (torch.mean(noise**2) * 10.0 ** (snr / 10.0)))
        noise_sliced = noise_sliced * scale
        corrupted.append(speech + noise_sliced)
        scaled.append(noise_sliced)
    return corrupted, scaled


def mix_speech_and_noise_without_rescaling(
    speech_batch: List[torch.Tensor],
    noise_batch: List[torch.Tensor],
    rng: np.random.Generator,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Add to each speech an unscaled random slice of its noise
    (``vibravox/utils.py:195-254``)."""
    _check_pairs(speech_batch, noise_batch)
    corrupted, sliced = [], []
    for speech, noise in zip(speech_batch, noise_batch):
        noise_sliced = _noise_slice(noise, speech.shape[-1], rng)
        corrupted.append(speech + noise_sliced)
        sliced.append(noise_sliced)
    return corrupted, sliced
