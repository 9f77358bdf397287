"""Waveform data augmentation: speed perturbation, pitch shift, time masking.

Counterpart of ``vibravox_tpu/ops/augment.py`` (the reference's
``WaveformDataAugmentation``, ``data_augmentation.py:8-69``, and
``time_masking_waveform.py``), on float32 ``(..., T)`` tensors.  The BWE
collate calls it on the host, in the loader's worker processes, where the
reference runs torchaudio.

* ``speed_perturbation`` resamples from ``round(sr factor)`` to ``sr``.
* ``pitch_shift`` stretches the STFT in time by a phase vocoder, inverts it
  by windowed overlap-add and resamples from ``int(sr / rate)`` to ``sr``.
  Those rates share a small gcd (16951 / 16000 for one semitone up at
  16 kHz), so the resampler keeps only the band of its kernel bank
  (``ops/resample.py::design_band``): about 1.5 MB instead of up to 1.4 GB.
* ``time_masking_block`` zeroes a block of ``pct`` % of the samples.

The gates, factors, steps and percentages are drawn from a numpy
``Generator`` in the JAX package's order, so the same generator state draws
the same transforms.  The masked block's start is drawn from a second
generator, ``mask_rng``, as the JAX package draws it from a ``jax.random``
key of its own: the start's stream differs from JAX's, the rest does not.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vibravox_tpu_torch.ops.pallas_stft import hann_window, reflect_index
from vibravox_tpu_torch.ops.resample import resample

__all__ = [
    "speed_perturbation",
    "pitch_shift",
    "stretched_frames",
    "blocked_cumsum",
    "time_masking_block",
    "time_mask_at",
    "WaveformDataAugmentation",
]


def speed_perturbation(x: torch.Tensor, sample_rate: int, factor: float) -> torch.Tensor:
    """Change playback speed by ``factor`` (output length about T / factor):
    a resample from ``round(sample_rate factor)`` to ``sample_rate``."""
    return resample(x, int(round(sample_rate * factor)), sample_rate)


# --------------------------------------------------------------------------- #
# Phase-vocoder pitch shift
# --------------------------------------------------------------------------- #


def _stft_complex(x: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, n_frames, n_fft // 2 + 1) complex, centred, reflect-padded."""
    x = x[..., reflect_index(x.shape[-1], n_fft // 2, x.device)]
    frames = x.unfold(-1, n_fft, hop) * window
    return torch.fft.rfft(frames, dim=-1)


@functools.lru_cache(maxsize=64)
def _ola_norm(n_frames: int, n_fft: int, hop: int) -> torch.Tensor:
    """The overlap-added squared window of ``n_frames`` frames (float32)."""
    window = hann_window(n_fft)
    idx = (torch.arange(n_frames)[:, None] * hop + torch.arange(n_fft)[None, :]).reshape(-1)
    norm = torch.zeros(n_fft + hop * (n_frames - 1))
    return norm.index_add_(0, idx, (window**2).expand(n_frames, n_fft).reshape(-1))


def _istft(spec: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor, length: int) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add with COLA normalisation."""
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    n_frames = frames.shape[-2]
    idx = (torch.arange(n_frames, device=spec.device)[:, None] * hop
           + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
    out = torch.zeros(*frames.shape[:-2], n_fft + hop * (n_frames - 1), dtype=frames.dtype, device=spec.device)
    out.index_add_(-1, idx, frames.reshape(*frames.shape[:-2], -1))
    out = out / torch.clamp(_ola_norm(n_frames, n_fft, hop).to(spec.device), min=1e-8)
    start = n_fft // 2
    return out[..., start:start + length]


def stretched_frames(n_frames: int, rate: float) -> np.ndarray:
    """The phase vocoder's read positions, ``jnp.arange(0, n_frames, rate)``
    exactly: JAX hands a float step to ``np.arange`` with its float32
    default dtype, which sets both the count and the values."""
    return np.arange(0, n_frames, rate, dtype=np.float32)


def blocked_cumsum(x: torch.Tensor, dim: int, block: int = 16) -> torch.Tensor:
    """Prefix sum along ``dim`` in the dtype of ``x``, in blocks: each block
    of ``block`` values summed in order, the blocks' totals prefix-summed
    the same way and added to the blocks after them.  In float32 this is
    the rounding of XLA's CPU cumsum (``jnp.cumsum``), which the phase
    vocoder's phase, summed over hundreds of frames to 1e5 rad, inherits;
    ``torch.cumsum`` accumulates in float64 on the CPU and rounds otherwise."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    blocks = -(-n // block)
    out = torch.nn.functional.pad(x, (0, blocks * block - n)).reshape(*x.shape[:-1], blocks, block).clone()
    for i in range(1, block):
        out[..., i] = out[..., i - 1] + out[..., i]
    if blocks > 1:
        totals = blocked_cumsum(out[..., -1], -1, block)
        out[..., 1:, :] = out[..., 1:, :] + totals[..., :-1, None]
    return out.reshape(*x.shape[:-1], blocks * block)[..., :n].movedim(-1, dim)


def _phase_vocoder(spec: torch.Tensor, rate: float, hop: int) -> torch.Tensor:
    """Time-stretch a complex STFT by ``rate`` along the frame axis."""
    n_freq, n_frames = spec.shape[-1], spec.shape[-2]
    phi_advance = torch.linspace(0, math.pi * hop, n_freq, device=spec.device)[None, :]
    steps = torch.from_numpy(stretched_frames(n_frames, rate)).to(spec.device)
    idx_low = torch.floor(steps).to(torch.int64)
    idx_high = torch.clamp(idx_low + 1, max=n_frames - 1)
    frac = (steps - idx_low)[:, None]
    s0, s1 = spec[..., idx_low, :], spec[..., idx_high, :]
    mag = (1 - frac) * s0.abs() + frac * s1.abs()
    phase0 = torch.angle(s0)
    dphase = torch.angle(s1) - phase0 - phi_advance
    dphase = dphase - 2 * math.pi * torch.round(dphase / (2 * math.pi))
    acc = blocked_cumsum(phi_advance + dphase, dim=-2)
    first = phase0[..., :1, :]
    phase = torch.cat([first, first + acc[..., :-1, :]], dim=-2)
    return torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))


def pitch_shift(
    x: torch.Tensor,
    sample_rate: int,
    n_steps: float,
    bins_per_octave: int = 12,
    n_fft: int = 512,
    hop: Optional[int] = None,
) -> torch.Tensor:
    """Pitch-shift by ``n_steps`` semitones, keeping the length: a phase
    vocoder stretch by ``rate = 2 ** (-n_steps / bins_per_octave)``, then a
    resample from ``int(sample_rate / rate)`` to ``sample_rate`` (torchaudio's
    ``PitchShift`` algorithm)."""
    hop = hop or n_fft // 4
    rate = 2.0 ** (-n_steps / bins_per_octave)
    lead, length = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, length)
    window = hann_window(n_fft, flat.dtype, flat.device)
    stretched = _phase_vocoder(_stft_complex(flat, n_fft, hop, window), rate, hop)
    y = _istft(stretched, n_fft, hop, window, int(length / rate))
    y = resample(y, int(sample_rate / rate), sample_rate)
    y = y[..., :length] if y.shape[-1] >= length else torch.nn.functional.pad(y, (0, length - y.shape[-1]))
    return y.reshape(*lead, length)


# --------------------------------------------------------------------------- #
# Time masking
# --------------------------------------------------------------------------- #


def time_mask_at(x: torch.Tensor, masking_percentage: float, start: int) -> torch.Tensor:
    """Zero ``int(T masking_percentage / 100)`` samples from ``start``."""
    masked = int(x.shape[-1] * masking_percentage / 100)
    out = x.clone()
    out[..., start:start + masked] = 0.0
    return out


def time_masking_block(x: torch.Tensor, masking_percentage: float, rng: np.random.Generator) -> torch.Tensor:
    """Zero a random contiguous block of ``masking_percentage`` % of the
    samples, its start uniform in ``[0, T - masked)`` (reference:
    ``time_masking_waveform.py:17-35``)."""
    masked = int(x.shape[-1] * masking_percentage / 100)
    return time_mask_at(x, masking_percentage, int(rng.integers(0, x.shape[-1] - masked)))


class WaveformDataAugmentation:
    """Augmentation of one or two coupled waveforms: gated by
    ``p_data_augmentation``, then each transform fires on its own with its
    probability and a uniformly drawn factor, step or percentage, the same
    for both waveforms."""

    def __init__(
        self,
        sample_rate: int,
        p_data_augmentation: float = 0.0,
        p_speed_perturbation: float = 0.3,
        p_pitch_shift: float = 0.3,
        p_time_masking: float = 0.3,
        speed_perturbation_factors: Sequence[float] = (
            0.7, 0.8, 0.85, 0.9, 0.95, 1.05, 1.1, 1.15, 1.2, 1.3,
        ),
        pitch_shift_steps: Sequence[int] = (-4, -3, -2, -1, 1, 2, 3, 4, 5, 6),
        time_masking_percentage: Sequence[int] = (1, 2, 3, 4, 5, 6, 7, 8),
    ):
        for name, p in [
            ("p_data_augmentation", p_data_augmentation),
            ("p_speed_perturbation", p_speed_perturbation),
            ("p_pitch_shift", p_pitch_shift),
            ("p_time_masking", p_time_masking),
        ]:
            if not 0 <= p <= 1:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        self.sample_rate = sample_rate
        self.p_data_augmentation = p_data_augmentation
        self.p_speed_perturbation = p_speed_perturbation
        self.p_pitch_shift = p_pitch_shift
        self.p_time_masking = p_time_masking
        self.speed_perturbation_factors = tuple(speed_perturbation_factors)
        self.pitch_shift_steps = tuple(pitch_shift_steps)
        self.time_masking_percentage = tuple(time_masking_percentage)

    def __call__(
        self,
        waveform_1: torch.Tensor,
        waveform_2: Optional[torch.Tensor] = None,
        *,
        rng: np.random.Generator,
        mask_rng: np.random.Generator,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if rng.random() < self.p_data_augmentation:
            if rng.random() < self.p_speed_perturbation:
                factor = self.speed_perturbation_factors[rng.integers(len(self.speed_perturbation_factors))]
                waveform_1 = speed_perturbation(waveform_1, self.sample_rate, factor)
                if waveform_2 is not None:
                    waveform_2 = speed_perturbation(waveform_2, self.sample_rate, factor)
            if rng.random() < self.p_pitch_shift:
                step = self.pitch_shift_steps[rng.integers(len(self.pitch_shift_steps))]
                waveform_1 = pitch_shift(waveform_1, self.sample_rate, step)
                if waveform_2 is not None:
                    waveform_2 = pitch_shift(waveform_2, self.sample_rate, step)
            if rng.random() < self.p_time_masking:
                pct = self.time_masking_percentage[rng.integers(len(self.time_masking_percentage))]
                masked = int(waveform_1.shape[-1] * pct / 100)
                start = int(mask_rng.integers(0, waveform_1.shape[-1] - masked))
                waveform_1 = time_mask_at(waveform_1, pct, start)
                if waveform_2 is not None:
                    waveform_2 = time_mask_at(waveform_2, pct, start)
        return waveform_1, waveform_2
