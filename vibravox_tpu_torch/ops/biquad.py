"""Biquad low-pass filtering and the zero-phase ``remove_hf`` (host side).

Counterpart of ``vibravox_tpu/ops/biquad.py`` (torchaudio's
``lowpass_biquad`` and the reference's ``remove_hf``,
``vibravox/utils.py:84-116``).  The recurrence is sequential, so it runs
as ``scipy.signal.lfilter`` on the host (direct form II transposed, the
JAX scan's form), in the tensor's dtype; it serves data preparation and
analysis, not the training step.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

__all__ = ["biquad_coeffs_lowpass", "biquad_apply", "lowpass_biquad", "remove_hf"]


def biquad_coeffs_lowpass(sample_rate: int, cutoff_freq: float, Q: float = 0.707) -> Tuple[np.ndarray, np.ndarray]:
    """RBJ audio-EQ-cookbook low-pass coefficients ``(b, a)``, normalised by
    a0 (torchaudio's)."""
    w0 = 2.0 * math.pi * cutoff_freq / sample_rate
    alpha = math.sin(w0) / (2.0 * Q)
    cos_w0 = math.cos(w0)
    a0 = 1.0 + alpha
    b = np.array([(1.0 - cos_w0) / 2.0, 1.0 - cos_w0, (1.0 - cos_w0) / 2.0]) / a0
    a = np.array([1.0, -2.0 * cos_w0 / a0, (1.0 - alpha) / a0])
    return b, a


def biquad_apply(x: torch.Tensor, b, a) -> torch.Tensor:
    """One biquad along the trailing time axis, from zero state."""
    from scipy.signal import lfilter

    dtype = x.detach().cpu().numpy().dtype
    y = lfilter(np.asarray(b, dtype), np.asarray(a, dtype), x.detach().cpu().numpy(), axis=-1)
    return torch.from_numpy(np.ascontiguousarray(y.astype(dtype))).to(x.device)


def lowpass_biquad(x: torch.Tensor, sample_rate: int, cutoff_freq: float, Q: float = 0.707) -> torch.Tensor:
    b, a = biquad_coeffs_lowpass(sample_rate, cutoff_freq, Q)
    return biquad_apply(x, b, a)


def remove_hf(waveform: torch.Tensor, sample_rate: int, cutoff_freq: float,
              padding_length: int = 3000) -> torch.Tensor:
    """Fourth-order zero-phase low-pass: reflect-pad for the filter to
    settle, the biquad forward and backward, then un-pad."""
    x = torch.nn.functional.pad(waveform[None] if waveform.ndim == 1 else waveform,
                                (padding_length, padding_length), mode="reflect")
    x = x[0] if waveform.ndim == 1 else x
    x = lowpass_biquad(x, sample_rate, cutoff_freq)
    x = lowpass_biquad(x.flip(-1), sample_rate, cutoff_freq).flip(-1)
    return x[..., padding_length:-padding_length]
