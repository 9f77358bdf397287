"""1-D convolution helpers on NCW tensors with torch-layout weights.

Counterpart of ``vibravox_tpu/ops/conv.py`` (``same_pad_amount``,
``reflect_pad``, ``conv1d``, ``conv_transpose1d``).  The JAX package works
channels-last with WIO weights; here activations are ``(B, C, T)`` and
weights are torch's ``(out, in // groups, k)`` (``(in, out // groups, k)``
for transposed convs).  Weights are cast to the activations' dtype at the
call, the JAX package's mixed-precision policy (f32 masters, bf16 compute).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["same_pad_amount", "reflect_pad", "conv1d", "conv_transpose1d", "norm_padding"]

PaddingSpec = Union[str, int, Tuple[int, int]]


def same_pad_amount(kernel: int, dilation: int = 1) -> Tuple[int, int]:
    """Total 'same' padding split like torch (left gets the smaller half)."""
    total = (kernel - 1) * dilation
    left = total // 2
    return left, total - left


def reflect_pad(x: torch.Tensor, pad: Tuple[int, int]) -> torch.Tensor:
    """Reflection-pad the time axis of an NCW tensor."""
    if tuple(pad) == (0, 0):
        return x
    return F.pad(x, tuple(pad), mode="reflect")


def norm_padding(padding: PaddingSpec, kernel: int, dilation: int = 1) -> Tuple[int, int]:
    """``"same"`` / ``"valid"`` / int / (left, right) -> (left, right)."""
    if isinstance(padding, str):
        if padding.lower() == "same":
            return same_pad_amount(kernel, dilation)
        if padding.lower() == "valid":
            return (0, 0)
        raise ValueError(f"Unknown padding {padding!r}")
    if isinstance(padding, int):
        return (padding, padding)
    return (int(padding[0]), int(padding[1]))


def conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: PaddingSpec = 0,
    dilation: int = 1,
    groups: int = 1,
    pad_mode: str = "zeros",
) -> torch.Tensor:
    """Conv1d on NCW input; ``pad_mode`` is ``zeros`` or ``reflect`` (torch's
    ``padding_mode``), reflect padding applied explicitly before the conv."""
    pad = norm_padding(padding, weight.shape[-1], dilation)
    if pad_mode == "reflect":
        x = reflect_pad(x, pad)
        pad = (0, 0)
    elif pad_mode != "zeros":
        raise ValueError(f"Unknown pad_mode {pad_mode!r}")
    if pad[0] != pad[1]:
        x = F.pad(x, pad)
        pad = (0, 0)
    weight = weight.to(x.dtype)
    if bias is not None:
        bias = bias.to(x.dtype)
    return F.conv1d(x, weight, bias, stride, pad[0], dilation, groups)


def conv_transpose1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: int = 0,
    output_padding: int = 0,
    groups: int = 1,
) -> torch.Tensor:
    """``torch.nn.ConvTranspose1d`` semantics on NCW input:
    ``out_len = (in_len - 1) * stride - 2 * padding + kernel + output_padding``."""
    weight = weight.to(x.dtype)
    if bias is not None:
        bias = bias.to(x.dtype)
    return F.conv_transpose1d(x, weight, bias, stride, padding, output_padding, groups)
