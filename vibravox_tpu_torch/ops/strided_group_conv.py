"""The MelGAN discriminator's grouped stride-4 convolutions on Hopper.

Kernel 41, stride 4, zero padding 20, 4 groups, no dilation: conv_1 ...
conv_4 of ``models/melgan_discriminator.py``.  ``strided_group_conv``
dispatches on the tensor's device:

* a CPU tensor runs ``plain_strided_group_conv``, the polyphase form in plain
  PyTorch: the input's four time phases as channels, the taps zero-padded to
  44 and split by phase, and a stride-1 grouped convolution; autograd
  differentiates it;
* a CUDA bfloat16 tensor runs a ``torch.autograd.Function`` over the
  hand-written kernel ``csrc/strided_group_conv.cu``: the forward (fprop),
  and in the backward the data gradient (dgrad) only where the input needs
  one and the weight gradient (wgrad) only where the weight does.  It never
  falls back to cuDNN; a tensor it does not take raises.

``takes`` is the dispatch rule ``ops/conv.py::conv1d`` applies: a CUDA
bfloat16 input and exactly this geometry at input channels a group the
kernel is built for.  Everything else stays on cuDNN.

The kernel reads the float32 master weight and bias and casts them itself
(bf16 products, float32 sums); it returns y and dx in bfloat16, dW and the
bias gradient in float32, summed in a fixed order (deterministic).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vibravox_tpu_torch.ops import _build

__all__ = ["takes", "strided_group_conv", "plain_strided_group_conv"]

KERNEL, STRIDE, PAD, GROUPS = 41, 4, 20, 4
# input channels a group -> output channels a group must be a multiple of
# this (the plans' tiles, csrc/strided_group_conv.cu ``Plans``; a gpu test
# holds the two to each other)
_COG_MULTIPLE = {4: 16, 16: 64, 64: 128, 256: 128}
_TAPS_PAD = 44  # 11 taps a phase x 4 phases
_DGRAD_TAPS = 12


def takes(device_type: str, dtype: torch.dtype, c_in: int, weight_shape: Sequence[int], stride: int,
          padding: Tuple[int, int], dilation: int, groups: int) -> bool:
    """Whether a zero-padded ``conv1d`` call runs on the kernel: a CUDA
    bfloat16 input, kernel 41, stride 4, padding (20, 20), dilation 1, 4
    groups, and per-group widths the kernel is built for."""
    if weight_shape[-1] != KERNEL or stride != STRIDE or groups != GROUPS or dilation != 1:
        return False
    if tuple(padding) != (PAD, PAD) or device_type != "cuda" or dtype != torch.bfloat16:
        return False
    c_out, cig = int(weight_shape[0]), int(weight_shape[1])
    return (c_in == GROUPS * cig and cig in _COG_MULTIPLE and c_out % GROUPS == 0
            and (c_out // GROUPS) % _COG_MULTIPLE[cig] == 0)


def plain_strided_group_conv(x: torch.Tensor, weight: torch.Tensor,
                             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The polyphase form in plain PyTorch: ``F.conv1d(x, weight, bias, 4, 20,
    groups=4)`` as a stride-1, 11-tap grouped convolution over the input's
    four time phases, x_r[c, s] = x[c, 4 s + r], with tap k = 4 j + r of the
    weight zero-padded to 44.  Computes in x's dtype."""
    b, c_in, t = x.shape
    c_out, cig, k = weight.shape
    t_out = -(-t // STRIDE)
    # x padded to 4 (t_out + 10) samples: phase r of window s is x[4 (s - 5) + r]
    xp = F.pad(x, (PAD, STRIDE * (t_out + 10) - t - PAD))
    phases = xp.view(b, c_in, t_out + 10, STRIDE).transpose(2, 3).reshape(b, STRIDE * c_in, t_out + 10)
    w = F.pad(weight.to(x.dtype), (0, _TAPS_PAD - k))
    w = w.view(c_out, cig, _TAPS_PAD // STRIDE, STRIDE).transpose(2, 3).reshape(c_out, STRIDE * cig, -1)
    return F.conv1d(phases, w, None if bias is None else bias.to(x.dtype), groups=GROUPS)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("strided_group_conv")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vx_sgconv_fprop.restype = i32
    lib.vx_sgconv_fprop.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]  # x, w, bias, y, wt; b, cig, cog, t, dev
    lib.vx_sgconv_dgrad.restype = i32
    lib.vx_sgconv_dgrad.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]  # dy, w, dx, wt
    lib.vx_sgconv_wgrad_splits.restype = i32
    lib.vx_sgconv_wgrad_splits.argtypes = [i32] * 4
    lib.vx_sgconv_wgrad.restype = i32
    lib.vx_sgconv_wgrad.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]  # x, dy, dw, partial; splits, ...
    lib.vx_error_string.restype = ctypes.c_char_p
    lib.vx_error_string.argtypes = [i32]
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"strided group conv {what} failed: {_library().vx_error_string(err).decode()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bfloat16 CUDA input, got {x.dtype} on {x.device}")
    if x.dim() != 3 or weight.dim() != 3:
        raise ValueError(f"expected NCW input and (C_out, C_in / 4, 41) weight, got {tuple(x.shape)}, "
                         f"{tuple(weight.shape)}")
    if not takes(x.device.type, x.dtype, x.shape[1], weight.shape, STRIDE, (PAD, PAD), 1, GROUPS):
        raise ValueError(f"the CUDA kernel does not take input {tuple(x.shape)} with weight "
                         f"{tuple(weight.shape)}: C_in / 4 in {sorted(_COG_MULTIPLE)}, kernel {KERNEL}")
    if not 1 <= x.shape[0] <= 16383 or x.shape[2] < 1:
        raise ValueError(f"batch must be in [1, 16383] and T >= 1, got {tuple(x.shape)}")
    if weight.dtype != torch.float32 or weight.device != x.device:
        raise TypeError(f"the weight must be float32 on {x.device}, got {weight.dtype} on {weight.device}")
    if bias is not None and (bias.dtype != torch.float32 or bias.device != x.device
                             or tuple(bias.shape) != (weight.shape[0],)):
        raise TypeError(f"the bias must be float32 ({weight.shape[0]},) on {x.device}, got {bias.dtype} "
                        f"{tuple(bias.shape)} on {bias.device}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _fprop(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    b, c_in, t = x.shape
    c_out, cig = weight.shape[:2]
    y = torch.empty(b, c_out, -(-t // STRIDE), device=x.device, dtype=x.dtype)
    wt = torch.empty(c_out * cig * _TAPS_PAD, device=x.device, dtype=x.dtype)  # the weight, bf16, 44 taps
    err = _library().vx_sgconv_fprop(
        x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
        wt.data_ptr(), b, cig, c_out // GROUPS, t, x.device.index or 0, _stream(x))
    _raise_on(err, "fprop")
    return y


def _dgrad(dy: torch.Tensor, weight: torch.Tensor, x_shape: Sequence[int]) -> torch.Tensor:
    b, c_in, t = x_shape
    c_out, cig = weight.shape[:2]
    dx = torch.empty(b, c_in, t, device=dy.device, dtype=dy.dtype)
    # the weight flipped by phase: (group, input channel, phase) x (output channel, 12 taps)
    wt = torch.empty(GROUPS * STRIDE * cig * _DGRAD_TAPS * (c_out // GROUPS), device=dy.device, dtype=dy.dtype)
    err = _library().vx_sgconv_dgrad(
        dy.data_ptr(), weight.data_ptr(), dx.data_ptr(), wt.data_ptr(), b, cig, c_out // GROUPS, t,
        dy.device.index or 0, _stream(dy))
    _raise_on(err, "dgrad")
    return dx


def _wgrad(x: torch.Tensor, dy: torch.Tensor, weight_shape: Sequence[int]) -> torch.Tensor:
    b, c_in, t = x.shape
    c_out, cig, k = weight_shape
    lib = _library()
    splits = lib.vx_sgconv_wgrad_splits(b, cig, c_out // GROUPS, t)
    if splits < 1:
        raise ValueError(f"the wgrad kernel does not take x {tuple(x.shape)}, weight {tuple(weight_shape)}")
    dw = torch.empty(c_out, cig, k, device=x.device, dtype=torch.float32)
    partial = torch.empty(splits * c_out * cig * _TAPS_PAD, device=x.device, dtype=torch.float32)
    err = lib.vx_sgconv_wgrad(
        x.data_ptr(), dy.data_ptr(), dw.data_ptr(), partial.data_ptr(), splits, b, cig, c_out // GROUPS, t,
        x.device.index or 0, _stream(x))
    _raise_on(err, "wgrad")
    return dw


class _StridedGroupConv(torch.autograd.Function):
    """fprop forward; dgrad and wgrad in the backward, each only where its
    input needs a gradient (a frozen discriminator runs no wgrad)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = None if bias is None else bias.dtype
        strided_group_conv.launches += 1
        return _fprop(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _dgrad(dy, weight, x.shape)
            strided_group_conv.launches += 1
        if ctx.needs_input_grad[1]:
            dw = _wgrad(x, dy, weight.shape)
            strided_group_conv.launches += 1
        if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
            db = dy.sum(dim=(0, 2), dtype=ctx.bias_dtype)
        return dx, dw, db


def strided_group_conv(x: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.conv1d(x, weight, bias, stride=4, padding=20, groups=4)`` for a
    kernel of 41 on NCW ``(B, C_in, T)`` input, out ``(B, C_out, ceil(T /
    4))``.

    CPU tensors take ``plain_strided_group_conv``.  CUDA tensors must be
    bfloat16, with a floating-point weight ``(C_out, C_in / 4, 41)`` and
    bias, which the kernel reads in float32 (a float32 master as it is);
    they launch the fprop kernel and add one to
    ``strided_group_conv.launches``, as each dgrad and wgrad launch of their
    backward does."""
    if x.device.type == "cpu":
        return plain_strided_group_conv(x, weight, bias)
    for t in (weight, bias):
        if t is not None and not t.is_floating_point():
            raise TypeError(f"the weight and bias must be floating point, got {t.dtype}")
    weight, bias = weight.float(), None if bias is None else bias.float()
    _check(x, weight, bias)
    return _StridedGroupConv.apply(x, weight, bias)


strided_group_conv.launches = 0
