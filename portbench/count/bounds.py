"""Peaks of one NVIDIA H100 and the operations and bytes of K1-K4.

The peaks are NVIDIA's data sheet for the H100 SXM, dense, at its 700 W
limit: 989 TFLOP/s for bfloat16; 495 TFLOP/s, TF32's, as the ceiling of any
float32 work (a split-precision scheme such as 3xTF32 runs below it, and
float32 FMAs at 67); 3.35 TB/s of HBM.  A roofline share is the least
time the chip could take, the larger of operations / peak and bytes /
bandwidth, over the measured time, so no implementation can read over 100%.

The kernels' counts are frozen copies of the port's measurement script's
(``chip_smoke.py``: ``stack_bound_ms``, ``k2_bound_ms``, ``dft_bound_ms``),
with these peaks.  Each input byte is counted read once and each output
byte written once.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12}
HBM_BYTES_PER_S = 3.35e12


def peak_flops(dtype: torch.dtype) -> float:
    return PEAK_FLOPS[dtype]


def _size(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def stack_work(b: int, c: int, t: int, dtype: torch.dtype) -> Tuple[float, float]:
    """(FLOP, bytes) of K1, one fused residual stack forward: three units of
    a k3 and a pointwise conv, 24 C^2 T B FLOP; x read and y written once,
    the six weight tensors read once."""
    return 24.0 * c * c * t * b, float((2 * b * c * t + 12 * c * c) * _size(dtype))


def stack_backward_work(b: int, c: int, t: int, dtype: torch.dtype) -> Tuple[float, float]:
    """(FLOP, bytes) of K2, one stack backward from x and g alone: the
    forward again 24, dx 24 and dW 24 C^2 T B FLOP; x and g read, dx written,
    the weights read and the float32 dW written once."""
    e = _size(dtype)
    return 72.0 * c * c * t * b, float(3 * b * c * t * e + 12 * c * c * (e + 4))


def dft_work(b: int, t: int, fft: int, hop: int, backward: bool) -> Tuple[float, float]:
    """(FLOP, bytes) of K3 (|STFT|, float32) or K4 (its gradient): an FFT's
    2.5 fft log2(fft) FLOP a real frame, twice for K4 (the spectrum again and
    the inverse); x read and the magnitudes written for K3; x, g and the
    magnitudes read and dx written for K4."""
    frames, bins = 1 + t // hop, fft // 2 + 1
    flops = 2.5 * fft * math.log2(fft) * b * frames * (2 if backward else 1)
    nbytes = 4 * ((2 * b * t + 2 * b * frames * bins) if backward else (b * t + b * frames * bins))
    return flops, float(nbytes)


def bound_s(flops: float, nbytes: float, dtype: torch.dtype) -> float:
    """The least seconds: max(operations / peak, bytes / bandwidth)."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def fft_flops(b: int, t: int, fft: int, hop: int) -> float:
    """A framed real FFT's FLOP (2.5 fft log2 fft a frame), the count the
    model FLOPs use for an STFT, whose FFTs no FLOP counter sees."""
    return 2.5 * fft * math.log2(fft) * b * (1 + t // hop)
