"""Residual vector quantization of the Mimi codec (PyTorch, (B, T, D)).

Counterpart of ``vibravox_tpu/models/mimi/rvq.py``: Mimi's split RVQ, one
semantic quantizer and ``n_q - 1`` acoustic ones, each a codebook lookup on
the residual between bias-free input and output projections.  The nearest
code minimises ``||C||^2 - 2 x.C`` in float32 (``||x||^2`` is the same for
every code), the first on a tie; the straight-through estimator passes the
gradient of the quantized output to the projection's output.  Codebooks
are in the inference form (embeddings); the regressive-Mimi task freezes
the quantizer.  On the GPU the distances need IEEE float32 products, which
the model's entry points ask for (``strict_float32``): a near tie decided
in TF32 can flip a code and every later stage's residual with it.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

__all__ = ["nearest", "ResidualVectorQuantizer", "SplitResidualVectorQuantizer"]


def nearest(codebook: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """codebook (K, D), x (..., D) -> the index (...,) of the nearest code."""
    dist = (codebook * codebook).sum(-1) - 2.0 * (x @ codebook.T)
    return dist.argmin(-1)


class ResidualVectorQuantizer(nn.Module):
    """``n_q`` stages of residual VQ with input and output projections."""

    def __init__(self, dimension: int = 256, input_dimension: int = 512, output_dimension: int = 512,
                 n_q: int = 8, codebook_size: int = 2048):
        super().__init__()
        self.n_q = n_q
        self.codebooks = nn.Parameter(torch.empty(n_q, codebook_size, dimension))
        self.input_proj = nn.Linear(input_dimension, dimension, bias=False)
        self.output_proj = nn.Linear(dimension, output_dimension, bias=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, T, input_dim) -> (quantized (B, T, output_dim), codes (n_q, B, T))."""
        h = self.input_proj(x)
        residual, quantized, codes = h, torch.zeros_like(h), []
        for q in range(self.n_q):
            idx = nearest(self.codebooks[q], residual)
            selected = self.codebooks[q][idx]
            quantized = quantized + selected
            residual = residual - selected
            codes.append(idx)
        quantized = h + (quantized - h).detach()
        return self.output_proj(quantized), torch.stack(codes)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (n_q, B, T) -> (B, T, output_dim)."""
        quantized = sum(self.codebooks[q][codes[q]] for q in range(codes.shape[0]))
        return self.output_proj(quantized)


class SplitResidualVectorQuantizer(nn.Module):
    """Mimi's one semantic plus ``n_q - 1`` acoustic quantizers; the codes
    stack the semantic stage first."""

    def __init__(self, dimension: int = 256, input_dimension: int = 512, output_dimension: int = 512,
                 n_q: int = 8, codebook_size: int = 2048):
        super().__init__()
        self.semantic = ResidualVectorQuantizer(dimension, input_dimension, output_dimension, 1, codebook_size)
        self.acoustic = ResidualVectorQuantizer(dimension, input_dimension, output_dimension, n_q - 1,
                                                codebook_size)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        q_sem, c_sem = self.semantic(x)
        q_ac, c_ac = self.acoustic(x)
        return q_sem + q_ac, torch.cat([c_sem, c_ac], dim=0)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.semantic.decode(codes[:1]) + self.acoustic.decode(codes[1:])
