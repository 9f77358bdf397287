"""EBEN multi-scale discriminators (PyTorch, NCW inside).

Counterpart of ``vibravox_tpu/models/eben_discriminator.py``: three
grouped-conv discriminators at dilations 1/2/3 over the *last q* PQMF bands,
plus one full-rate MelGAN discriminator on the audio; every layer's
activation is returned for feature matching.  Module names follow the
reference torch state dict.  ``embed`` works on NCW tensors (the train step
calls it); ``forward`` keeps the JAX package's channels-last layout.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from vibravox_tpu_torch.device import DeviceLike, resolve_device, strict_float32
from vibravox_tpu_torch.models.layers import WNConv1d
from vibravox_tpu_torch.models.melgan_discriminator import DiscriminatorMelGAN

__all__ = ["DiscriminatorEBEN", "DiscriminatorEBENMultiScales"]

_SLOPE = 0.2


class DiscriminatorEBEN(nn.Module):
    """Grouped weight-norm conv stack over q PQMF bands: a reflect pad by 1
    before stage 0 (whose own padding is zeros), six strided grouped stages,
    and an ungrouped certainty conv."""

    def __init__(self, dilation: int = 1, q: int = 3, min_channels: int = 24):
        super().__init__()
        if min_channels % q != 0:
            raise ValueError("min_channels must be a multiple of q")
        c, d = int(min_channels), int(dilation)
        widths = [c, 2 * c, 4 * c, 8 * c, 16 * c, 32 * c, 32 * c]
        stages = [nn.Sequential(
            nn.ReflectionPad1d(1),
            WNConv1d(q, c, 3, padding=1, dilation=d, groups=q),
            nn.LeakyReLU(_SLOPE),
        )]
        for i in range(1, 6):
            stages.append(nn.Sequential(
                WNConv1d(widths[i - 1], widths[i], 7, stride=2, padding=3, dilation=d, groups=q),
                nn.LeakyReLU(_SLOPE),
            ))
        stages.append(nn.Sequential(
            WNConv1d(widths[5], widths[6], 5, padding=2, dilation=d, groups=q), nn.LeakyReLU(_SLOPE),
        ))
        stages.append(WNConv1d(widths[6], 1, 3, padding=1))
        self.discriminator = nn.ModuleList(stages)

    def embed(self, bands: torch.Tensor) -> List[torch.Tensor]:
        """bands (B, q, T') -> 9 NCW embeddings [input, 7 hidden, certainties]."""
        embeddings = [bands]
        x = bands
        for stage in self.discriminator:
            x = stage(x)
            embeddings.append(x)
        return embeddings


class DiscriminatorEBENMultiScales(nn.Module):
    """Three band discriminators (dilation 1/2/3) and one MelGAN.

    ``device``: ``None`` for the GPU (raises without one), or ``"cpu"``."""

    def __init__(self, q: int = 3, min_channels: int = 24, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.q = int(q)
        self.pqmf_discriminators = nn.ModuleList(
            [DiscriminatorEBEN(dilation=d, q=self.q, min_channels=min_channels) for d in (1, 2, 3)]
        )
        self.melgan_discriminator = DiscriminatorMelGAN(_SLOPE, device="cpu")
        self.to(dev)

    @strict_float32()
    def embed(self, bands: torch.Tensor, audio: torch.Tensor) -> List[List[torch.Tensor]]:
        """bands (B, M, T') all PQMF bands, audio (B, 1, T) -> one NCW
        embedding list per discriminator (band discriminators see the last q
        bands only)."""
        last = bands[:, -self.q :, :]
        embeddings = [dis.embed(last) for dis in self.pqmf_discriminators]
        embeddings.append(self.melgan_discriminator.embed(audio))
        return embeddings

    def forward(self, bands: torch.Tensor, audio: torch.Tensor) -> List[List[torch.Tensor]]:
        """bands (B, T', M), audio (B, T, 1) -> embeddings (B, T'', C), the
        JAX package's layout."""
        nested = self.embed(bands.transpose(1, 2), audio.transpose(1, 2))
        return [[e.transpose(1, 2) for e in scale] for scale in nested]
