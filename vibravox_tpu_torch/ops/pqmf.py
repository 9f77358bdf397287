"""Near-perfect-reconstruction pseudo-QMF filterbank (NCW ``nn.Module``).

Counterpart of ``vibravox_tpu/ops/pqmf.py``.  The bank design (Kaiser-
windowed sinc prototype whose cutoff minimises the decimated
autocorrelation peak, Lin & Vaidyanathan '98; cosine modulation with
alternating +-pi/4 phase, Nguyen '94) is this package's own copy of the JAX
package's numpy/scipy code.  Analysis is one conv with stride M and zero
padding K-1; synthesis is one dense transposed conv that fuses the band sum.
The filters are frozen buffers named as in the reference state dict.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["PQMF", "design_pqmf_bank", "design_prototype", "optimal_cutoff_ratio"]


def design_prototype(kernel_size: int, beta: float, cutoff_ratio: float) -> np.ndarray:
    """Kaiser-windowed sinc prototype filter (float64, length ``kernel_size``)."""
    kaiser = np.kaiser(kernel_size, beta)
    n = np.arange(kernel_size) - (kernel_size - 1) / 2
    sinc = cutoff_ratio * np.sinc(cutoff_ratio * n)
    return (sinc * kaiser).astype(np.float64)


def _design_objective(cutoff: float, decimation: int, kernel_size: int, beta: float) -> float:
    """Peak of the 2M-decimated autocorrelation of the prototype (zero lag
    excluded), plus a penalty outside the admissible cutoff range."""
    proto = design_prototype(kernel_size, beta, cutoff)
    padded = np.pad(proto, kernel_size // 2)
    autocorr = np.correlate(padded, proto, mode="valid")  # lag j - K//2, j in [0, K]
    autocorr[kernel_size // 2] = 0.0
    phi = np.max(np.abs(autocorr[:: 2 * decimation]))
    if abs(cutoff - 1 / (2 * decimation)) > 1 / (4 * decimation):
        phi += 1 / (4 * decimation)
    return float(phi)


@functools.lru_cache(maxsize=None)
def optimal_cutoff_ratio(decimation: int, kernel_size: int, beta: float) -> float:
    """Minimise the design objective over the cutoff ratio (host, init time)."""
    from scipy.optimize import minimize_scalar

    center = 1 / (2 * decimation)
    half = 1 / (4 * decimation)
    res = minimize_scalar(
        _design_objective,
        bounds=(center - half + 1e-9, center + half - 1e-9),
        args=(decimation, kernel_size, beta),
        method="bounded",
        options={"xatol": 1e-12},
    )
    return float(res.x)


@functools.lru_cache(maxsize=None)
def design_pqmf_bank(
    decimation: int, kernel_size: int, beta: float = 9.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Design the cosine-modulated bank.

    Returns:
        analysis: (decimation, kernel_size), row i the time-flipped modulated
            prototype, so a cross-correlation conv applies the true filter.
        synthesis: (decimation, kernel_size), unflipped, scaled by 2M.
    """
    if kernel_size % (4 * decimation) != 0:
        raise ValueError("kernel_size must be divisible by 4*decimation")
    cutoff = optimal_cutoff_ratio(decimation, kernel_size, beta)
    proto = design_prototype(kernel_size, beta, cutoff)
    n = np.arange(kernel_size) - (kernel_size - 1) / 2
    analysis = np.zeros((decimation, kernel_size))
    synthesis = np.zeros((decimation, kernel_size))
    for i in range(decimation):
        phase = (2 * i + 1) * np.pi / (2 * decimation) * n
        analysis[i] = 2 * (proto * np.cos(phase + (-1) ** i * np.pi / 4))[::-1]
        synthesis[i] = 2 * decimation * proto * np.cos(phase - (-1) ** i * np.pi / 4)
    return analysis, synthesis


class PQMF(nn.Module):
    """Frozen PQMF bank on NCW ``(B, 1, T)`` audio.

    Buffers ``analysis_weights`` and ``synthesis_weights`` are ``(M, 1, K)``
    float32, the reference's names and layouts; they are cast to the
    signal's dtype at use."""

    def __init__(self, decimation: int = 32, kernel_size: int = 1024, beta: float = 9.0):
        super().__init__()
        self.decimation = int(decimation)
        self.kernel_size = int(kernel_size)
        analysis, synthesis = design_pqmf_bank(self.decimation, self.kernel_size, float(beta))
        self.register_buffer(
            "analysis_weights", torch.tensor(analysis[:, None, :], dtype=torch.float32)
        )
        self.register_buffer(
            "synthesis_weights", torch.tensor(synthesis[:, None, :], dtype=torch.float32)
        )

    def analysis(self, signal: torch.Tensor, bands: int = -1) -> torch.Tensor:
        """(B, 1, T) -> (B, bands, T'), T' = (T + K - 2) // M + 1."""
        w = self.analysis_weights if bands == -1 else self.analysis_weights[:bands]
        return F.conv1d(
            signal, w.to(signal.dtype), stride=self.decimation, padding=self.kernel_size - 1
        )

    def synthesis(self, bands: torch.Tensor) -> torch.Tensor:
        """(B, M, T') -> (B, 1, T): per-band synthesis and the band sum as one
        dense transposed conv."""
        return F.conv_transpose1d(
            bands,
            self.synthesis_weights.to(bands.dtype),
            stride=self.decimation,
            padding=self.kernel_size - 1,
            output_padding=self.decimation - 2,
        )
