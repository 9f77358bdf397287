"""A-weighted multi-resolution STFT loss (PyTorch).

Counterpart of ``vibravox_tpu/ops/stft.py``, the reference's auraloss
``MultiResolutionSTFTLoss`` as configured by
``configs/lightning_module/loss_module/multi_stft.yaml`` (fft 512/1024/2048,
hop 50/120/240, win 240/600/1200, perceptual A-weighting).  Every magnitude
goes through ``ops/pallas_stft.py::framed_dft_magnitude``: the K3/K4 kernels
on the GPU, ``torch.stft`` on the CPU, both with ``torch.stft`` framing
(center, reflect pad, periodic Hann window zero-padded to fft) and the power
clamped at eps before the square root.

The JAX package's packed FIR and custom-vjp FIR are TPU workarounds; the
prefilter here is the plain true convolution with zero "same" padding, and
autograd differentiates it.  The loss upcasts to float32 and keeps its
convolutions in IEEE float32 (``strict_float32``).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vibravox_tpu_torch.device import DeviceLike, resolve_device, strict_float32
from vibravox_tpu_torch.ops.pallas_stft import framed_dft_magnitude

__all__ = [
    "a_weighting_fir",
    "apply_fir",
    "spectral_convergence",
    "log_magnitude_l1",
    "MultiResolutionSTFTLoss",
]


@functools.lru_cache(maxsize=None)
def a_weighting_fir(sample_rate: int, ntaps: int = 101) -> np.ndarray:
    """Linear-phase FIR approximation of IEC 61672 A-weighting.

    Analog transfer function poles at f1..f4 with +2.0 dB gain normalisation
    at 1 kHz, discretised by bilinear transform, then a least-squares
    ``firls`` fit on the 512-point ``freqz`` grid (auraloss's "aw" prefilter).
    """
    from scipy import signal as sps

    f1, f2, f3, f4 = 20.598997, 107.65265, 737.86223, 12194.217
    a1000 = 1.9997
    num = [(2 * np.pi * f4) ** 2 * 10 ** (a1000 / 20), 0, 0, 0, 0]
    den = np.polymul(
        [1, 4 * np.pi * f4, (2 * np.pi * f4) ** 2],
        [1, 4 * np.pi * f1, (2 * np.pi * f1) ** 2],
    )
    den = np.polymul(np.polymul(den, [1, 2 * np.pi * f3]), [1, 2 * np.pi * f2])
    b, a = sps.bilinear(num, den, fs=sample_rate)
    w, h = sps.freqz(b, a, worN=512, fs=sample_rate)
    taps = sps.firls(ntaps, w, np.abs(h), fs=sample_rate)
    return taps.astype(np.float32)


def apply_fir(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Filter (B, T) with an FIR, 'same' output length: the true convolution
    with zero padding (k // 2, (k - 1) // 2), as ``F.conv1d`` on flipped taps."""
    k = taps.shape[0]
    w = taps.flip(0).to(x.dtype).view(1, 1, k)
    return F.conv1d(F.pad(x[:, None, :], (k // 2, (k - 1) // 2)), w)[:, 0, :]


def spectral_convergence(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    """|| |Y|-|X| ||_F / || |Y| ||_F over the whole tensor (auraloss
    ``SpectralConvergenceLoss``: one global Frobenius ratio)."""
    return torch.sqrt(torch.sum((y_mag - x_mag) ** 2)) / torch.sqrt(torch.sum(y_mag**2))


def log_magnitude_l1(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(torch.log(x_mag) - torch.log(y_mag)))


class MultiResolutionSTFTLoss:
    """Multi-resolution STFT loss with optional perceptual (A-)weighting, on
    ``(B, T, C)`` or ``(B, T)`` audio (channels folded into the batch).

    ``device``: ``None`` for the GPU (raises without one), or ``"cpu"``; the
    prefilter taps live there."""

    def __init__(
        self,
        fft_sizes: Sequence[int] = (1024, 2048, 512),
        hop_sizes: Sequence[int] = (120, 240, 50),
        win_lengths: Sequence[int] = (600, 1200, 240),
        sample_rate: int | None = None,
        perceptual_weighting: bool = False,
        w_sc: float = 1.0,
        w_log_mag: float = 1.0,
        device: DeviceLike = None,
    ):
        if not len(fft_sizes) == len(hop_sizes) == len(win_lengths):
            raise ValueError("fft_sizes, hop_sizes and win_lengths differ in length")
        self.device = resolve_device(device)
        self.resolutions: Tuple[Tuple[int, int, int], ...] = tuple(
            zip(map(int, fft_sizes), map(int, hop_sizes), map(int, win_lengths))
        )
        self.w_sc = float(w_sc)
        self.w_log_mag = float(w_log_mag)
        self.perceptual_weighting = bool(perceptual_weighting)
        if self.perceptual_weighting:
            if sample_rate is None:
                raise ValueError("sample_rate required for perceptual weighting")
            self.prefilter_taps = torch.from_numpy(a_weighting_fir(int(sample_rate))).to(self.device)

    @staticmethod
    def _fold(a: torch.Tensor) -> torch.Tensor:
        a = a.float()
        if a.dim() == 3:  # (B, T, C) -> (B * C, T)
            a = a.reshape(-1, a.shape[1]) if a.shape[2] == 1 else a.movedim(2, 1).reshape(-1, a.shape[1])
        return a

    @strict_float32()
    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x, y = self._fold(x), self._fold(y)
        if self.perceptual_weighting:
            x = apply_fir(x, self.prefilter_taps)
            y = apply_fir(y, self.prefilter_taps)
        loss = 0.0
        for fft, hop, win in self.resolutions:
            x_mag = framed_dft_magnitude(x, fft, hop, win)
            y_mag = framed_dft_magnitude(y, fft, hop, win)
            loss = loss + (
                self.w_sc * spectral_convergence(x_mag, y_mag)
                + self.w_log_mag * log_magnitude_l1(x_mag, y_mag)
            )
        return loss / len(self.resolutions)
