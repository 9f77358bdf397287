"""SEANet convolutional encoder and decoder of the Mimi codec (PyTorch, NCW).

Counterpart of ``vibravox_tpu/models/mimi/seanet.py`` (EnCodec / Mimi
SEANet): a conv stem, one residual unit and one strided conv per ratio (ELU
activations), and a mirrored decoder with transposed convs.  Causal padding
throughout, as the streaming Mimi configuration has it.

* ``CausalConv`` pads ``k_eff - stride`` on the left plus the right padding
  that completes the last frame (HF ``MimiConv1d._get_extra_padding_for_conv1d``),
  with zeros or, for ``pad_mode="replicate"``, the edge sample.
* ``CausalConvTranspose`` keeps its weight in the torch layout
  ``(in, out / groups, k)`` and trims all ``k - stride`` overhanging samples
  off the right.
* The encoder downsamples by the reversed ratios (4, 5, 6, 8 for Mimi),
  the decoder upsamples by the ratios in order; names are the JAX
  package's (``conv_in``, ``block_{i}_res_{j}``, ``down_{i}`` / ``up_{i}``,
  ``conv_out``), so its parameter tree maps key by key.

This is the plain path: the JAX package's space-to-depth packed stem and
tail (``ops/packed_seanet.py``) are a TPU layout of the same arithmetic.
``dtype`` (bf16 for ``compute_dtype="bfloat16"``) casts each conv's input,
weight and bias, so the residual stream takes the convs' dtype; the
decoder's last conv always runs in float32.  PyTorch adds a conv's bias
inside the conv, where flax adds it after, in the compute dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["CausalConv", "CausalConvTranspose", "SEANetResnetBlock", "SEANetEncoder", "SEANetDecoder"]


def cast(t: Optional[torch.Tensor], dtype: Optional[torch.dtype]) -> Optional[torch.Tensor]:
    return t if t is None or dtype is None else t.to(dtype)


class CausalConv(nn.Module):
    """Causal 1-D conv, weight ``(out, in, k)``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, bias: bool = True, pad_mode: str = "zeros"):
        super().__init__()
        if pad_mode not in ("zeros", "replicate"):
            raise ValueError(f"pad_mode must be 'zeros' or 'replicate', got {pad_mode!r}")
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.pad_mode = pad_mode
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def padding(self, length: int) -> Tuple[int, int]:
        """(left, right) samples of padding for an input of ``length``."""
        k_eff = (self.kernel_size - 1) * self.dilation + 1
        pad_total = k_eff - self.stride
        frames = -(-(length - k_eff + pad_total) // self.stride)
        return pad_total, max(0, frames * self.stride + k_eff - pad_total - length)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        x = F.pad(cast(x, dtype), self.padding(x.shape[-1]),
                  mode="replicate" if self.pad_mode == "replicate" else "constant")
        return F.conv1d(x, cast(self.weight, dtype), cast(self.bias, dtype), self.stride, 0, self.dilation)


class CausalConvTranspose(nn.Module):
    """Causal transposed 1-D conv, weight ``(in, out / groups, k)``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        self.kernel_size, self.stride, self.groups = kernel_size, stride, groups
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        y = F.conv_transpose1d(cast(x, dtype), cast(self.weight, dtype), cast(self.bias, dtype), self.stride,
                               groups=self.groups)
        trim = self.kernel_size - self.stride
        return y[..., :y.shape[-1] - trim] if trim > 0 else y


class SEANetResnetBlock(nn.Module):
    """x + conv_1(elu(conv_0(elu(x)))): a k-3 conv to dim / 2 channels, then
    a 1x1 conv back; the sum in x's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_0 = CausalConv(dim, dim // 2, 3)
        self.conv_1 = CausalConv(dim // 2, dim, 1)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        h = self.conv_1(F.elu(self.conv_0(F.elu(x), dtype)), dtype)
        return x + h.to(x.dtype)


class SEANetEncoder(nn.Module):
    """waveform (B, 1, T) -> latent (B, dimension, T / prod(ratios)).  Mimi's
    SEANet: a k-7 stem, one residual unit per ratio, a k-3 last conv."""

    def __init__(self, dimension: int = 512, n_filters: int = 64, ratios: Sequence[int] = (8, 6, 5, 4)):
        super().__init__()
        self.ratios = tuple(ratios)
        self.conv_in = CausalConv(1, n_filters, 7)
        mult = 1
        # the smallest ratio first (EnCodec ordering)
        for i, ratio in enumerate(reversed(self.ratios)):
            self.add_module(f"block_{i}_res_0", SEANetResnetBlock(mult * n_filters))
            self.add_module(f"down_{i}", CausalConv(mult * n_filters, mult * n_filters * 2, ratio * 2, stride=ratio))
            mult *= 2
        self.conv_out = CausalConv(mult * n_filters, dimension, 3)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        h = self.conv_in(x, dtype)
        for i in range(len(self.ratios)):
            h = getattr(self, f"block_{i}_res_0")(h, dtype)
            h = getattr(self, f"down_{i}")(F.elu(h), dtype)
        return self.conv_out(F.elu(h), dtype)


class SEANetDecoder(nn.Module):
    """latent (B, dimension, T') -> waveform (B, 1, T' * prod(ratios)), float32;
    the encoder mirrored, with transposed convs."""

    def __init__(self, dimension: int = 512, n_filters: int = 64, ratios: Sequence[int] = (8, 6, 5, 4)):
        super().__init__()
        self.ratios = tuple(ratios)
        mult = 2 ** len(self.ratios)
        self.conv_in = CausalConv(dimension, mult * n_filters, 7)
        for i, ratio in enumerate(self.ratios):
            self.add_module(f"up_{i}", CausalConvTranspose(mult * n_filters, mult * n_filters // 2, ratio * 2,
                                                           stride=ratio))
            self.add_module(f"block_{i}_res_0", SEANetResnetBlock(mult * n_filters // 2))
            mult //= 2
        self.conv_out = CausalConv(n_filters, 1, 3)

    def forward(self, z: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        h = self.conv_in(z, dtype)
        for i in range(len(self.ratios)):
            h = getattr(self, f"up_{i}")(F.elu(h), dtype)
            h = getattr(self, f"block_{i}_res_0")(h, dtype)
        # the waveform comes out of a float32 conv
        return self.conv_out(F.elu(h).float())
