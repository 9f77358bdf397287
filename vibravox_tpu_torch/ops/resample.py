"""Polyphase windowed-sinc resampling as one strided convolution (PyTorch).

Counterpart of ``vibravox_tpu/ops/resample.py``: torchaudio's
``sinc_interp_kaiser`` and default ``sinc_interp_hann`` Resample designs.
After reducing the rates by their gcd, each of the ``new_freq`` output
phases gets a windowed-sinc kernel; one ``F.conv1d`` with stride
``orig_freq`` computes every phase at once.  The kernel bank is designed on
the host in float64 (``design_kernel``, shared with ``host_resample``) and
cast to float32; the convolution runs in IEEE float32 on the GPU
(``strict_float32``).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vibravox_tpu_torch.device import strict_float32

__all__ = ["design_kernel", "KaiserResampler", "resample"]

_KAISER_BETA = 14.769656459379492  # torchaudio's sinc_interp_kaiser default
_LOWPASS_FILTER_WIDTH = 6
_ROLLOFF = 0.99


@functools.lru_cache(maxsize=None)
def design_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = _LOWPASS_FILTER_WIDTH,
    rolloff: float = _ROLLOFF,
    beta: float = _KAISER_BETA,
    window: str = "kaiser",
) -> Tuple[np.ndarray, int]:
    """The polyphase bank for rates already reduced by their gcd:
    ``(kernels (new_freq, width_total) float32, left_pad)``."""
    from scipy.special import i0

    base_freq = min(orig_freq, new_freq) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig_freq / base_freq))
    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx[None, :]
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)
    if window == "kaiser":
        win = i0(beta * np.sqrt(1 - (t / lowpass_filter_width) ** 2)) / i0(beta)
    elif window == "hann":
        win = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    else:
        raise ValueError(f"unknown window {window!r}; use 'kaiser' or 'hann'")
    t = t * np.pi
    scale = base_freq / orig_freq
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * win * scale
    return np.ascontiguousarray(kernels.astype(np.float32)), width


class KaiserResampler:
    """Resampler from ``orig_freq`` to ``new_freq`` along the time axis of
    ``(..., T)`` or ``(B, T, 1)`` tensors; the identity when the rates agree."""

    def __init__(self, orig_freq: int, new_freq: int, window: str = "kaiser"):
        gcd = math.gcd(int(orig_freq), int(new_freq))
        self.orig_freq = int(orig_freq) // gcd
        self.new_freq = int(new_freq) // gcd
        self.identity = self.orig_freq == self.new_freq
        if not self.identity:
            kernels, self.width = design_kernel(self.orig_freq, self.new_freq, window=window)
            self.weight = torch.from_numpy(kernels)[:, None, :]  # (new_freq, 1, width_total)

    def output_length(self, input_length: int) -> int:
        return int(math.ceil(self.new_freq * input_length / self.orig_freq))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.identity:
            return x
        squeeze_channel = x.ndim == 3 and x.shape[-1] == 1
        if squeeze_channel:
            x = x[..., 0]
        lead, length = x.shape[:-1], x.shape[-1]
        flat = x.reshape(-1, 1, length)
        num_wins = -(-length // self.orig_freq)
        pad_right = self.width + self.orig_freq + num_wins * self.orig_freq - length
        weight = self.weight.to(device=x.device, dtype=x.dtype)
        with strict_float32():
            y = F.conv1d(F.pad(flat, (self.width, pad_right)), weight, stride=self.orig_freq)
        # (N, phases, windows) -> phases interleaved in time
        y = y[:, :, :num_wins].transpose(1, 2).reshape(flat.shape[0], -1)
        y = y[:, : self.output_length(length)].reshape(*lead, -1)
        return y[..., None] if squeeze_channel else y


@functools.lru_cache(maxsize=None)
def _cached_resampler(orig_freq: int, new_freq: int, window: str) -> KaiserResampler:
    return KaiserResampler(orig_freq, new_freq, window=window)


def resample(x: torch.Tensor, orig_freq: int, new_freq: int, window: str = "kaiser") -> torch.Tensor:
    """One-shot resample with a cached kernel bank.  ``window="hann"`` is
    torchaudio's default ``sinc_interp_hann`` (the reference's metric path at
    16 kHz, ``base_se.py:54``); ``"kaiser"`` is ``sinc_interp_kaiser``."""
    return _cached_resampler(int(orig_freq), int(new_freq), window)(x)
