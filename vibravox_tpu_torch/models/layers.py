"""Conv layers with reflect padding and torch weight normalisation (NCW).

Counterpart of ``vibravox_tpu/models/layers.py``.  The reference wraps every
GAN conv in ``weight_norm``; here that is
``torch.nn.utils.parametrizations.weight_norm(dim=0)``, which stores the
gain as ``parametrizations.weight.original0`` and the direction as
``original1`` -- the reference checkpoint names:

* Conv1d: weight (out, in/groups, k), gain per *output* channel;
* ConvTranspose1d: weight (in, out/groups, k), gain per *input* channel.

Initialisation is torch's conv default; weight norm starts with the gain at
the direction's norm, so the effective weight equals it.  ``variance_scaling_``
is flax's truncated-normal initialiser, for the models that draw their
random weights as the JAX package's do (wav2vec2, Mimi).  Weights are cast
to the activations' dtype at the call (f32 masters, bf16 compute).
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
from torch import nn
from torch.nn.utils.parametrizations import weight_norm

from vibravox_tpu_torch.ops.conv import conv1d, conv_transpose1d, norm_padding, reflect_pad
from vibravox_tpu_torch.ops.quant import conv1d_int8_ste

__all__ = ["TorchConv1d", "WNConv1d", "WNConvTranspose1d", "variance_scaling_"]


def variance_scaling_(w: torch.Tensor, scale: float, fan_in: int, gen: torch.Generator) -> None:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``: a
    normal truncated at two of its deviations, rescaled to variance
    ``scale / fan_in``."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


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
    """Weight-normalised ``TorchConv1d`` (gain per output channel).

    ``int8``: the forward convolution runs in int8 with a straight-through
    backward (``ops/quant.py::conv1d_int8_ste``), the discriminators'
    ``VIBRAVOX_INT8_DISC`` experiment; the parameters are the same."""

    def __init__(self, *args, int8: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        weight_norm(self, dim=0)
        self.int8 = bool(int8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.int8:
            return super().forward(x)
        pad = self.pad
        if self.pad_mode == "reflect":
            x, pad = reflect_pad(x, pad), (0, 0)
        y = conv1d_int8_ste(x, self.weight.to(x.dtype), self.stride[0], pad, self.dilation[0], self.groups)
        return y if self.bias is None else y + self.bias.to(y.dtype)[:, None]


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
