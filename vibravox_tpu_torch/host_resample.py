"""Host-side polyphase resampler (numpy) for requests at other sample rates.

This package's own copy of the JAX package's numpy twin
(``vibravox_tpu/native/pipeline.py::_resample_poly_numpy``): torchaudio's
``sinc_interp_kaiser`` design (``ops/resample.py::design_kernel``), applied
per output window as one matrix product over all phases.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

from vibravox_tpu_torch.ops.resample import design_kernel

__all__ = ["host_resample"]


@functools.lru_cache(maxsize=None)
def _kernel_bank(orig_freq: int, new_freq: int) -> Tuple[np.ndarray, int, int, int]:
    """(kernels (phases, width_total) f32, left_pad, orig_g, new_g)."""
    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig_g, new_g = int(orig_freq) // gcd, int(new_freq) // gcd
    kernels, width = design_kernel(orig_g, new_g)
    return kernels, width, orig_g, new_g


def host_resample(x: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Resample a 1-D waveform; returns ``ceil(len(x) * new / orig)`` samples."""
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    kernels, width, orig_g, new_g = _kernel_bank(int(orig_freq), int(new_freq))
    if orig_g == new_g:
        return x
    out_len = int(math.ceil(new_g * len(x) / orig_g))
    n_wins = -(-out_len // new_g)
    width_total = kernels.shape[1]
    pad_right = max(0, (n_wins - 1) * orig_g - width + width_total - len(x))
    padded = np.pad(x.astype(np.float64), (width, pad_right))
    starts = np.arange(n_wins) * orig_g
    windows = padded[starts[:, None] + np.arange(width_total)[None, :]]
    y = windows @ kernels.astype(np.float64).T  # (n_wins, phases)
    return y.reshape(-1)[:out_len].astype(np.float32)
