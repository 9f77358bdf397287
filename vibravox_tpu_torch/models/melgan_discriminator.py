"""MelGAN discriminators (PyTorch, NCW inside).

Counterpart of ``vibravox_tpu/models/melgan_discriminator.py`` on its plain
path.  ``DiscriminatorMelGAN``: a reflect pad by 7, seven weight-normalised
convolutions with bias, leaky ReLU (slope 0.2) after all but the last, and
every layer's activation returned for feature matching.
``MelganMultiScalesDiscriminator``: N of them, scale s reading the audio
Kaiser-resampled to ``sample_rate // 2**s`` (scale 0 is the identity), the
resampler a fixed convolution that gradients flow through.  Module names
follow the reference torch state dict (``discriminator.<stage>[.<index in
the stage>]``, ``discriminators.<scale>.…``).

``VIBRAVOX_INT8_DISC=1`` when a discriminator is made runs conv_1 ... conv_5
in int8 (``WNConv1d(int8=True)``), as the JAX package's switch does.  The
JAX package's space-to-depth packed stem, a TPU layout on by default there
(``VIBRAVOX_PACKED_DISC``), keeps conv_1 and conv_2 in float even under
int8 at lengths that are a multiple of its pack factor; the port has no
packed stem, so those two stages are int8 at every length.
"""

from __future__ import annotations

import os
from typing import List

import torch
from torch import nn

from vibravox_tpu_torch.device import DeviceLike, resolve_device, strict_float32
from vibravox_tpu_torch.models.layers import WNConv1d
from vibravox_tpu_torch.ops.resample import KaiserResampler

__all__ = ["DiscriminatorMelGAN", "MelganMultiScalesDiscriminator", "int8_disc_enabled"]


def int8_disc_enabled() -> bool:
    """``VIBRAVOX_INT8_DISC=1``: the discriminators' middle convolutions in int8."""
    return os.environ.get("VIBRAVOX_INT8_DISC", "0") == "1"


class DiscriminatorMelGAN(nn.Module):
    """Single-scale MelGAN discriminator over raw waveforms.

    ``device``: ``None`` for the GPU (raises without one), or ``"cpu"``."""

    def __init__(self, alpha_leaky_relu: float = 0.2, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        slope = float(alpha_leaky_relu)
        q = int8_disc_enabled()
        self.discriminator = nn.ModuleList([
            nn.Sequential(nn.ReflectionPad1d(7), WNConv1d(1, 16, 15), nn.LeakyReLU(slope)),
            nn.Sequential(WNConv1d(16, 64, 41, stride=4, padding=20, groups=4, int8=q), nn.LeakyReLU(slope)),
            nn.Sequential(WNConv1d(64, 256, 41, stride=4, padding=20, groups=4, int8=q), nn.LeakyReLU(slope)),
            nn.Sequential(WNConv1d(256, 1024, 41, stride=4, padding=20, groups=4, int8=q), nn.LeakyReLU(slope)),
            nn.Sequential(WNConv1d(1024, 1024, 41, stride=4, padding=20, groups=4, int8=q), nn.LeakyReLU(slope)),
            nn.Sequential(WNConv1d(1024, 1024, 5, padding=2, int8=q), nn.LeakyReLU(slope)),
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


class MelganMultiScalesDiscriminator(nn.Module):
    """``scales`` MelGAN discriminators, scale s on the audio resampled to
    ``sample_rate // 2**s`` (``get_downsampled_versions``).

    ``device``: ``None`` for the GPU (raises without one), or ``"cpu"``."""

    def __init__(self, sample_rate: int, scales: int = 3, alpha_leaky_relu: float = 0.2,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.sample_rate, self.scales = int(sample_rate), int(scales)
        self.discriminators = nn.ModuleList(
            [DiscriminatorMelGAN(alpha_leaky_relu, device="cpu") for _ in range(self.scales)])
        # fixed banks, made once on the host and cast to the audio's device at the call
        self._downsamplers = [KaiserResampler(self.sample_rate, self.sample_rate // 2**s)
                              for s in range(self.scales)]
        self.to(dev)

    def get_downsampled_versions(self, audio: torch.Tensor) -> List[torch.Tensor]:
        """audio (B, 1, T) or (B, T, 1) -> one resampled copy a scale."""
        return [down(audio) for down in self._downsamplers]

    @strict_float32()
    def embed(self, audio: torch.Tensor) -> List[List[torch.Tensor]]:
        """audio (B, 1, T) -> per scale the 8 NCW embeddings."""
        return [disc.embed(signal)
                for disc, signal in zip(self.discriminators, self.get_downsampled_versions(audio))]

    def forward(self, audio: torch.Tensor) -> List[List[torch.Tensor]]:
        """audio (B, T, 1) -> per scale the 8 embeddings (B, T', C), the JAX
        package's layout."""
        return [[e.transpose(1, 2) for e in scale] for scale in self.embed(audio.transpose(1, 2))]
