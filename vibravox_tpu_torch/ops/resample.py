"""Polyphase windowed-sinc resampling as one strided convolution (PyTorch).

Counterpart of ``vibravox_tpu/ops/resample.py``: torchaudio's
``sinc_interp_kaiser`` and default ``sinc_interp_hann`` Resample designs.
After reducing the rates by their gcd, each of the ``new_freq`` output
phases gets a windowed-sinc kernel; one ``F.conv1d`` with stride
``orig_freq`` computes every phase at once.  The kernel bank is designed on
the host in float64 (``design_kernel``, shared with ``native/pipeline.py``) and
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

__all__ = ["design_kernel", "design_band", "bank_nbytes", "KaiserResampler", "resample"]

_KAISER_BETA = 14.769656459379492  # torchaudio's sinc_interp_kaiser default
_LOWPASS_FILTER_WIDTH = 6
_ROLLOFF = 0.99
# Bytes of float32 taps; a larger bank is kept as its band.  The dense
# strided conv is the faster form where its bank is small, the band where
# it is large (chip_smoke.py phase ``augment``, ``resample_forms``, on the
# host of an H100 80GB HBM3 machine at one torch thread, batch 32 x 40000,
# two runs: band 84-251 ms against dense 3.3-9.4 ms at the speed factors'
# banks of at most 3 KB; band 145-155 ms against dense 868-1271 ms, after
# a 5.3-6.4 s design, at pitch step -3's 216 MB bank; on that card at
# 48 -> 16 kHz, one 2.5 s signal, band 0.24-0.46 ms against dense
# 0.09-0.11 ms).  The configs' banks are at
# most 3 KB or at least 216 MB, so any limit between them picks the same
# forms.
DENSE_BANK_LIMIT = 1 << 22


def _taps(t: np.ndarray, lowpass_filter_width: int, beta: float, window: str, scale: float) -> np.ndarray:
    """The windowed sinc at ``t`` (phase offsets in input samples times
    ``base_freq``), clipped at ``lowpass_filter_width`` zero crossings."""
    from scipy.special import i0

    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    if window == "kaiser":
        win = i0(beta * np.sqrt(1 - (t / lowpass_filter_width) ** 2)) / i0(beta)
    elif window == "hann":
        win = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    else:
        raise ValueError(f"unknown window {window!r}; use 'kaiser' or 'hann'")
    t = t * np.pi
    return np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * win * scale


def _geometry(orig_freq: int, new_freq: int, lowpass_filter_width: int, rolloff: float):
    """(base_freq, width, support): the kernel's cut-off, its left pad and
    half its support in input samples, ``width = ceil(support)``."""
    base_freq = min(orig_freq, new_freq) * rolloff
    support = lowpass_filter_width * orig_freq / base_freq
    return base_freq, int(math.ceil(support)), support


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
    base_freq, width, _ = _geometry(orig_freq, new_freq, lowpass_filter_width, rolloff)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx[None, :]
    kernels = _taps(t * base_freq, lowpass_filter_width, beta, window, base_freq / orig_freq)
    return np.ascontiguousarray(kernels.astype(np.float32)), width


def _band_length(orig_freq: int, new_freq: int, lowpass_filter_width: int, rolloff: float) -> int:
    return int(math.ceil(2 * _geometry(orig_freq, new_freq, lowpass_filter_width, rolloff)[2])) + 3


@functools.lru_cache(maxsize=None)
def design_band(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = _LOWPASS_FILTER_WIDTH,
    rolloff: float = _ROLLOFF,
    beta: float = _KAISER_BETA,
    window: str = "kaiser",
) -> Tuple[np.ndarray, np.ndarray, int]:
    """The band of ``design_kernel``'s bank, without building the bank:
    ``(taps (new_freq, L) float32, starts (new_freq,) int64, left_pad)``.
    Row p holds the dense row's entries ``starts[p] .. starts[p] + L``, the
    same float64 arithmetic cast to float32; they cover every tap inside
    the support (phase p's centre sits at ``left_pad + orig_freq p /
    new_freq``), and the entries left out are the clipped tails."""
    base_freq, width, support = _geometry(orig_freq, new_freq, lowpass_filter_width, rolloff)
    band = _band_length(orig_freq, new_freq, lowpass_filter_width, rolloff)
    width_total = 2 * width + orig_freq
    phase = np.arange(new_freq)
    starts = np.floor(width + orig_freq * phase / new_freq - support).astype(np.int64)
    starts = np.clip(starts, 0, width_total - band)
    cols = starts[:, None] + np.arange(band)[None, :]
    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    t = (np.arange(0, -new_freq, -1, dtype=np.float64) / new_freq)[:, None] + idx[cols]
    taps = _taps(t * base_freq, lowpass_filter_width, beta, window, base_freq / orig_freq)
    return np.ascontiguousarray(taps.astype(np.float32)), starts, width


def bank_nbytes(orig_freq: int, new_freq: int, lowpass_filter_width: int = _LOWPASS_FILTER_WIDTH,
                rolloff: float = _ROLLOFF) -> Tuple[int, int]:
    """(dense, banded) bytes of the float32 taps (and the band's int64
    starts) for rates already reduced by their gcd, computed, not built."""
    _, width, _ = _geometry(orig_freq, new_freq, lowpass_filter_width, rolloff)
    band = _band_length(orig_freq, new_freq, lowpass_filter_width, rolloff)
    return 4 * new_freq * (2 * width + orig_freq), new_freq * (4 * band + 8)


class KaiserResampler:
    """Resampler from ``orig_freq`` to ``new_freq`` along the time axis of
    ``(..., T)`` or ``(B, T, 1)`` tensors; the identity when the rates agree.
    It keeps only each phase's band (``design_band``) when the dense bank
    would exceed ``DENSE_BANK_LIMIT`` bytes."""

    def __init__(self, orig_freq: int, new_freq: int, window: str = "kaiser"):
        gcd = math.gcd(int(orig_freq), int(new_freq))
        self.orig_freq = int(orig_freq) // gcd
        self.new_freq = int(new_freq) // gcd
        self.identity = self.orig_freq == self.new_freq
        if self.identity:
            return
        self.banded = bank_nbytes(self.orig_freq, self.new_freq)[0] > DENSE_BANK_LIMIT
        if self.banded:
            taps, starts, self.width = design_band(self.orig_freq, self.new_freq, window=window)
            self.taps, self.starts = torch.from_numpy(taps), torch.from_numpy(starts)
        else:
            kernels, self.width = design_kernel(self.orig_freq, self.new_freq, window=window)
            self.weight = torch.from_numpy(kernels)[:, None, :]  # (new_freq, 1, width_total)

    def output_length(self, input_length: int) -> int:
        return int(math.ceil(self.new_freq * input_length / self.orig_freq))

    def nbytes(self) -> int:
        """Bytes of the bank this resampler holds."""
        if self.identity:
            return 0
        if self.banded:
            return self.taps.numel() * 4 + self.starts.numel() * 8
        return self.weight.numel() * 4

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.identity:
            return x
        squeeze_channel = x.ndim == 3 and x.shape[-1] == 1
        if squeeze_channel:
            x = x[..., 0]
        lead, length = x.shape[:-1], x.shape[-1]
        flat = x.reshape(-1, length)
        y = self._banded(flat) if self.banded else self._dense(flat)
        y = y.reshape(*lead, -1)
        return y[..., None] if squeeze_channel else y

    def _dense(self, flat: torch.Tensor) -> torch.Tensor:
        length = flat.shape[-1]
        num_wins = -(-length // self.orig_freq)
        pad_right = self.width + self.orig_freq + num_wins * self.orig_freq - length
        weight = self.weight.to(device=flat.device, dtype=flat.dtype)
        with strict_float32():
            y = F.conv1d(F.pad(flat[:, None], (self.width, pad_right)), weight, stride=self.orig_freq)
        # (N, phases, windows) -> phases interleaved in time
        y = y[:, :, :num_wins].transpose(1, 2).reshape(flat.shape[0], -1)
        return y[:, : self.output_length(length)]

    def _banded(self, flat: torch.Tensor) -> torch.Tensor:
        """Output n = w new + p is the band of phase p against the input from
        ``w orig + starts[p]`` of x left-padded by ``width``: the dense
        conv's sum without its clipped tails."""
        length = flat.shape[-1]
        n_out, band = self.output_length(length), self.taps.shape[1]
        n = torch.arange(n_out, device=flat.device)
        phase = n % self.new_freq
        src = (n // self.new_freq) * self.orig_freq + self.starts.to(flat.device)[phase]
        cols = src[:, None] + torch.arange(band, device=flat.device)
        pad_right = max(0, int(src[-1]) + band - self.width - length) if n_out else 0
        xp = F.pad(flat, (self.width, pad_right))
        taps = self.taps.to(device=flat.device, dtype=flat.dtype)[phase]
        rows = max(1, (1 << 22) // max(1, n_out * band))  # a gather of at most 16 MB at a time
        return torch.cat([(xp[i:i + rows, cols] * taps).sum(-1) for i in range(0, flat.shape[0], rows)])


@functools.lru_cache(maxsize=None)
def _cached_resampler(orig_freq: int, new_freq: int, window: str) -> KaiserResampler:
    return KaiserResampler(orig_freq, new_freq, window=window)


def resample(x: torch.Tensor, orig_freq: int, new_freq: int, window: str = "kaiser") -> torch.Tensor:
    """One-shot resample with a cached kernel bank.  ``window="hann"`` is
    torchaudio's default ``sinc_interp_hann`` (the reference's metric path at
    16 kHz, ``base_se.py:54``); ``"kaiser"`` is ``sinc_interp_kaiser``."""
    return _cached_resampler(int(orig_freq), int(new_freq), window)(x)
