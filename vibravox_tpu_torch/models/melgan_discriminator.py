"""MelGAN discriminator (PyTorch, NCW inside).

Counterpart of ``vibravox_tpu/models/melgan_discriminator.py::DiscriminatorMelGAN``
on its plain path: a reflect pad by 7, seven weight-normalised convolutions
with bias, leaky ReLU (slope 0.2) after all but the last, and every layer's
activation returned for feature matching.  Module names follow the reference
torch state dict (``discriminator.<stage>[.<index in the stage>]``).  The JAX
package's space-to-depth packed stem and int8 path are TPU experiments and
are not ported; neither is the multi-scale wrapper with its Kaiser
resamplers, which the EBEN discriminator does not use.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from vibravox_tpu_torch.device import DeviceLike, resolve_device, strict_float32
from vibravox_tpu_torch.models.layers import WNConv1d

__all__ = ["DiscriminatorMelGAN"]


class DiscriminatorMelGAN(nn.Module):
    """Single-scale MelGAN discriminator over raw waveforms.

    ``device``: ``None`` for the GPU (raises without one), or ``"cpu"``."""

    def __init__(self, alpha_leaky_relu: float = 0.2, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        slope = float(alpha_leaky_relu)
        self.discriminator = nn.ModuleList([
            nn.Sequential(nn.ReflectionPad1d(7), WNConv1d(1, 16, 15), nn.LeakyReLU(slope)),
            nn.Sequential(WNConv1d(16, 64, 41, stride=4, padding=20, groups=4), nn.LeakyReLU(slope)),
            nn.Sequential(WNConv1d(64, 256, 41, stride=4, padding=20, groups=4), nn.LeakyReLU(slope)),
            nn.Sequential(WNConv1d(256, 1024, 41, stride=4, padding=20, groups=4), nn.LeakyReLU(slope)),
            nn.Sequential(WNConv1d(1024, 1024, 41, stride=4, padding=20, groups=4), nn.LeakyReLU(slope)),
            nn.Sequential(WNConv1d(1024, 1024, 5, padding=2), nn.LeakyReLU(slope)),
            WNConv1d(1024, 1, 3, padding=1),
        ])
        self.to(dev)

    @strict_float32()
    def embed(self, audio: torch.Tensor) -> List[torch.Tensor]:
        """audio (B, 1, T) -> 8 NCW embeddings [input, 6 hidden, certainties]."""
        embeddings = [audio]
        x = audio
        for stage in self.discriminator:
            x = stage(x)
            embeddings.append(x)
        return embeddings

    def forward(self, audio: torch.Tensor) -> List[torch.Tensor]:
        """audio (B, T, 1) -> 8 embeddings (B, T', C), the JAX package's layout."""
        return [e.transpose(1, 2) for e in self.embed(audio.transpose(1, 2))]
