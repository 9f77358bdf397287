"""Conv layers with reflect padding and torch weight normalisation (NCW).

Counterpart of ``vibravox_tpu/models/layers.py``.  The reference wraps every
GAN conv in ``weight_norm``; here that is
``torch.nn.utils.parametrizations.weight_norm(dim=0)``, which stores the
gain as ``parametrizations.weight.original0`` and the direction as
``original1`` -- the reference checkpoint names:

* Conv1d: weight (out, in/groups, k), gain per *output* channel;
* ConvTranspose1d: weight (in, out/groups, k), gain per *input* channel.

Initialisation is torch's conv default; weight norm starts with the gain at
the direction's norm, so the effective weight equals it.  Weights are cast
to the activations' dtype at the call (f32 masters, bf16 compute).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn
from torch.nn.utils.parametrizations import weight_norm

from vibravox_tpu_torch.ops.conv import conv1d, conv_transpose1d, norm_padding

__all__ = ["TorchConv1d", "WNConv1d", "WNConvTranspose1d"]


class TorchConv1d(nn.Conv1d):
    """Conv1d with ``"same"``/int/(left, right) padding in zero or reflect mode."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        padding: Union[str, int, Tuple[int, int]] = 0,
        dilation: int = 1,
        groups: int = 1,
        bias: bool = True,
        pad_mode: str = "zeros",
    ):
        super().__init__(
            in_channels, out_channels, kernel_size, stride=stride, padding=0,
            dilation=dilation, groups=groups, bias=bias,
        )
        self.pad = norm_padding(padding, kernel_size, dilation)
        self.pad_mode = pad_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(
            x, self.weight, self.bias, stride=self.stride[0], padding=self.pad,
            dilation=self.dilation[0], groups=self.groups, pad_mode=self.pad_mode,
        )


class WNConv1d(TorchConv1d):
    """Weight-normalised ``TorchConv1d`` (gain per output channel)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        weight_norm(self, dim=0)


class WNConvTranspose1d(nn.ConvTranspose1d):
    """Weight-normalised ConvTranspose1d (gain per input channel)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        padding: int = 0,
        output_padding: int = 0,
        groups: int = 1,
        bias: bool = True,
    ):
        super().__init__(
            in_channels, out_channels, kernel_size, stride=stride, padding=padding,
            output_padding=output_padding, groups=groups, bias=bias,
        )
        weight_norm(self, dim=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose1d(
            x, self.weight, self.bias, stride=self.stride[0], padding=self.padding[0],
            output_padding=self.output_padding[0], groups=self.groups,
        )
