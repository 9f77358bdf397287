"""EBEN generator (PyTorch, NCW inside).

Counterpart of ``vibravox_tpu/models/eben_generator.py``: PQMF analysis of
the first ``p`` bands, a 1-D conv U-Net (three encoder blocks with strides
2/4/8, a 256 -> 64 -> 256 latent bottleneck, three skip-connected decoder
blocks), a last conv to ``m`` bands, then ``tanh(x + [first_bands | 0])``
and the fused PQMF synthesis.  Every block's three ResidualUnits run as one
fused residual stack (``ops/fused_residual.py``: the CUDA kernel on the GPU,
the plain convs on the CPU).

Submodule names follow the reference torch state dict, so a reference or hub
checkpoint loads with ``strict=True``.  The public call keeps the JAX
package's layout: ``(B, T, 1)`` audio in, ``(enhanced (B, T, 1),
decomposed (B, T', m))`` out.  ``front`` and ``tail`` work on NCW tensors
and run their convolutions in IEEE float32, never TF32 (``strict_float32``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vibravox_tpu_torch.device import DeviceLike, resolve_device, strict_float32
from vibravox_tpu_torch.models.layers import TorchConv1d, WNConv1d, WNConvTranspose1d
from vibravox_tpu_torch.ops.fused_residual import residual_stack
from vibravox_tpu_torch.ops.pqmf import PQMF

__all__ = ["EBENGenerator", "EncBlock", "DecBlock", "ResidualUnit"]

_LEAKY_SLOPE = 0.01
_DILATIONS = (1, 3, 9)


def _nl(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, _LEAKY_SLOPE)


class ResidualUnit(nn.Module):
    """Dilated k=3 conv, pointwise conv, leaky ReLU, residual add."""

    def __init__(self, channels: int, dilation: int):
        super().__init__()
        self.dilated_conv = WNConv1d(
            channels, channels, 3, dilation=dilation, padding="same", bias=False,
            pad_mode="reflect",
        )
        self.pointwise_conv = WNConv1d(channels, channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + _nl(self.pointwise_conv(self.dilated_conv(x)))


def _residual_stack(units: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    """The three units of a block as one fused stack, on their effective
    weights cast to the activations' dtype."""
    kernels = tuple(
        (u.dilated_conv.weight.to(x.dtype), u.pointwise_conv.weight.to(x.dtype)) for u in units
    )
    return residual_stack(x, kernels, _DILATIONS, _LEAKY_SLOPE)


class EncBlock(nn.Module):
    """Three residual units, then a strided reflect-padded downsampling conv."""

    def __init__(self, out_channels: int, stride: int):
        super().__init__()
        c = out_channels // 2
        self.residuals = nn.ModuleList([ResidualUnit(c, d) for d in _DILATIONS])
        self.conv = WNConv1d(
            c, out_channels, 2 * stride, stride=stride, padding=stride - 1, bias=False,
            pad_mode="reflect",
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(_residual_stack(self.residuals, x))


class DecBlock(nn.Module):
    """Skip add, transposed upsampling conv and leaky ReLU, three residual units."""

    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.conv_trans = WNConvTranspose1d(
            in_channels, out_channels, 2 * stride, stride=stride, padding=stride // 2,
            output_padding=0, bias=False,
        )
        self.residuals = nn.ModuleList([ResidualUnit(out_channels, d) for d in _DILATIONS])

    def forward(self, x: torch.Tensor, encoder_output: torch.Tensor) -> torch.Tensor:
        x = _nl(self.conv_trans(x + encoder_output))
        return _residual_stack(self.residuals, x)


class EBENGenerator(nn.Module):
    """EBEN generator.

    Args:
        m: number of PQMF bands (= decimation factor).
        n: PQMF kernel size.
        p: number of informative low bands fed to the U-Net.
        device: ``None`` for the GPU (raises without one), or ``"cpu"``.
            Parameters are initialised on the CPU from torch's default
            generator and then moved, so one seed gives the same weights on
            either device.
    """

    def __init__(self, m: int = 4, n: int = 32, p: int = 2, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.m, self.n, self.p = int(m), int(n), int(p)
        self.pqmf = PQMF(self.m, self.n)
        self.first_conv = TorchConv1d(
            self.p, 32, 3, padding="same", bias=False, pad_mode="reflect"
        )
        self.encoder_blocks = nn.ModuleList(
            [EncBlock(64, 2), EncBlock(128, 4), EncBlock(256, 8)]
        )
        self.latent_conv = nn.Sequential(
            nn.LeakyReLU(_LEAKY_SLOPE),
            WNConv1d(256, 64, 7, padding="same", bias=False, pad_mode="reflect"),
            nn.LeakyReLU(_LEAKY_SLOPE),
            WNConv1d(64, 256, 7, padding="same", bias=False, pad_mode="reflect"),
            nn.LeakyReLU(_LEAKY_SLOPE),
        )
        self.decoder_blocks = nn.ModuleList(
            [DecBlock(256, 128, 8), DecBlock(128, 64, 4), DecBlock(64, 32, 2)]
        )
        self.last_conv = TorchConv1d(
            32, self.m, 3, padding="same", bias=False, pad_mode="reflect"
        )
        self.to(dev)

    @property
    def multiple(self) -> int:
        """Product of the encoder strides and the PQMF decimation."""
        return 2 * 4 * 8 * self.m

    def valid_length(self, length: int) -> int:
        """Largest valid input length <= ``length``."""
        return length - (length + self.n) % self.multiple

    def cut_to_valid_length(self, audio: torch.Tensor) -> torch.Tensor:
        """Trim (B, T, 1) audio so every stride divides evenly."""
        return audio[:, : self.valid_length(audio.shape[1]), :]

    def forward(self, cut_audio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """cut_audio (B, T, 1) -> (enhanced (B, T, 1), decomposed (B, T', m))."""
        features, first_bands = self.front(cut_audio.transpose(1, 2))
        enhanced, decomposed = self.tail(features, first_bands)
        return enhanced.transpose(1, 2), decomposed.transpose(1, 2)

    @strict_float32()
    def front(self, audio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """PQMF analysis and the U-Net up to, not including, the last conv.
        (B, 1, T) -> (features (B, 32, T'), first_bands (B, p, T'))."""
        first_bands = self.pqmf.analysis(audio, bands=self.p)
        x = self.first_conv(first_bands)
        skips = []
        for block in self.encoder_blocks:
            x = block(_nl(x))
            skips.append(x)
        h = self.latent_conv(x)
        for block, skip in zip(self.decoder_blocks, reversed(skips)):
            h = block(h, skip)
        return h, first_bands

    @strict_float32()
    def tail(
        self, features: torch.Tensor, first_bands: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Last conv, ``tanh(x + [first_bands | 0])``, fused PQMF synthesis.
        -> (enhanced (B, 1, T), decomposed (B, m, T'))."""
        x = self.last_conv(features)
        fill = first_bands.new_zeros(first_bands.shape[0], self.m - self.p, first_bands.shape[2])
        decomposed = torch.tanh(x + torch.cat([first_bands, fill], dim=1))
        return self.pqmf.synthesis(decomposed), decomposed
