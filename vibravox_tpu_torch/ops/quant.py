"""Dynamic int8 1-D convolution with a straight-through backward.

Counterpart of ``vibravox_tpu/ops/quant.py``: the discriminators' opt-in
int8 convolutions (``VIBRAVOX_INT8_DISC=1``).  The activation is quantised
per tensor and the weight per output channel, symmetrically, from their
live max-abs (``quantize_symmetric``: the JAX package's float32 arithmetic
and round-half-to-even, so ``q`` and ``scale`` are bit-equal to its own);
the product runs int8 x int8 -> int32 and is rescaled by ``sx * sw``.  The
backward is the unquantised convolution's (``conv1d_int8_ste``).

The int8 product is an im2col and one integer GEMM per group
(``int8_conv1d``).  The JAX package leaves it to XLA's int8 convolution; no
Pallas kernel is involved, so on the GPU the GEMM is PyTorch's
``torch._int_mm`` (cuBLASLt's int8 tensor-core product), which wants K and
N multiples of 8 and M above 16: the wrapper pads A and B with zeros to
that, and a shape it still refuses raises (no fallback).  On a CPU tensor
the plain twin runs: the same im2col with an int32 matmul, exact.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["quantize_symmetric", "int8_conv1d", "gemm_int8_conv1d", "plain_int8_conv1d", "int8_mm",
           "conv1d_int8_ste"]


def quantize_symmetric(x: torch.Tensor, dims: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation: ``(q int8, scale float32)`` with
    ``x ~= q * scale``, the max-abs taken over ``dims`` (the other dims keep
    their own scale).  The scale is clamped away from zero, so a zero (or
    empty) tensor quantises to zeros."""
    xf = x.float()
    dims = tuple(d % x.ndim for d in dims)
    if xf.numel():
        amax = xf.abs().amax(dim=dims, keepdim=True)
    else:  # the JAX package's max with initial 0
        amax = xf.new_zeros([1 if d in dims else n for d, n in enumerate(xf.shape)])
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _im2col(x: torch.Tensor, k: int, stride: int, pad: Tuple[int, int], dilation: int) -> torch.Tensor:
    """(B, C, T) -> (B, T_out, C, k) windows of the zero-padded input."""
    x = F.pad(x, tuple(pad))
    span = (k - 1) * dilation + 1
    if x.shape[-1] < span:
        return x.new_zeros(x.shape[0], 0, x.shape[1], k)
    cols = x.unfold(2, span, stride)[..., ::dilation]  # (B, C, T_out, k)
    return cols.permute(0, 2, 1, 3)


def _group_operands(qx, qw, stride, pad, dilation, groups):
    """Per group g: A_g (B * T_out, C_in/g * k) and W_g (C_out/g, C_in/g * k)."""
    b, cin = qx.shape[:2]
    cout, cin_g, k = qw.shape
    if cin != cin_g * groups or cout % groups:
        raise ValueError(f"weight {tuple(qw.shape)} does not fit input {tuple(qx.shape)} at groups {groups}")
    cols = _im2col(qx, k, stride, pad, dilation)
    t_out = cols.shape[1]
    cout_g = cout // groups
    for g in range(groups):
        a = cols[:, :, g * cin_g:(g + 1) * cin_g].reshape(b * t_out, cin_g * k)
        yield a, qw[g * cout_g:(g + 1) * cout_g].reshape(cout_g, cin_g * k), t_out


def _gather(parts, b: int, t_out: int) -> torch.Tensor:
    """Per-group (B * T_out, C_out/g) int32 products -> (B, C_out, T_out)."""
    y = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return y.reshape(b, t_out, y.shape[1]).permute(0, 2, 1).contiguous()


def plain_int8_conv1d(qx: torch.Tensor, qw: torch.Tensor, stride: int, pad: Tuple[int, int],
                      dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """The twin: im2col and an int32 matmul per group, on the CPU (exact)."""
    qx, qw = qx.cpu(), qw.cpu()
    parts, t_out = [], 0
    for a, w, t_out in _group_operands(qx, qw, stride, pad, dilation, groups):
        parts.append(a.to(torch.int32) @ w.to(torch.int32).t())
    return _gather(parts, qx.shape[0], t_out)


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (M, K) int8 @ w (N, K).T -> (M, N) int32`` through ``torch._int_mm``
    as it is given: a shape it refuses raises."""
    return torch._int_mm(a, w.t())


def gemm_int8_conv1d(qx: torch.Tensor, qw: torch.Tensor, stride: int, pad: Tuple[int, int],
                     dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """The route of a CUDA tensor, on any device ``torch._int_mm`` takes: one
    ``int8_mm`` per group on operands zero-padded to what it accepts (K and
    N to multiples of 8, M above 16), the padding sliced off after."""
    parts, t_out = [], 0
    for a, w, t_out in _group_operands(qx, qw, stride, pad, dilation, groups):
        (m, k), n = a.shape, w.shape[0]
        if m == 0:
            parts.append(torch.zeros(0, n, dtype=torch.int32, device=qx.device))
            continue
        mp, kp, np_ = max(m, 17), _up(k, 8), _up(n, 8)
        a = F.pad(a, (0, kp - k, 0, mp - m)) if (mp, kp) != (m, k) else a.contiguous()
        w = F.pad(w, (0, kp - k, 0, np_ - n)) if (kp, np_) != (k, n) else w.contiguous()
        parts.append(int8_mm(a, w)[:m, :n])
    return _gather(parts, qx.shape[0], t_out)


def int8_conv1d(qx: torch.Tensor, qw: torch.Tensor, stride: int, pad: Tuple[int, int],
                dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """int8 (B, C_in, T) x int8 (C_out, C_in/g, k) -> int32 (B, C_out, T_out),
    zero padding ``pad`` = (left, right).  A CUDA tensor runs
    ``gemm_int8_conv1d`` and adds one to ``int8_conv1d.launches``; a CPU
    tensor runs ``plain_int8_conv1d``."""
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {qx.dtype} and {qw.dtype}")
    if qx.device.type == "cpu":
        return plain_int8_conv1d(qx, qw, stride, pad, dilation, groups)
    if qx.device.type != "cuda" or qw.device != qx.device:
        raise ValueError(f"int8_conv1d runs on cpu or cuda tensors of one device, got {qx.device}, {qw.device}")
    y = gemm_int8_conv1d(qx, qw, stride, pad, dilation, groups)
    int8_conv1d.launches += 1
    return y


int8_conv1d.launches = 0


class _Int8ConvSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, stride, pad, dilation, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, pad, dilation, groups)
        qx, sx = quantize_symmetric(x, (0, 1, 2))  # per tensor
        qw, sw = quantize_symmetric(weight, (1, 2))  # per output channel
        y = int8_conv1d(qx, qw, stride, pad, dilation, groups)
        # sx (1, 1, 1) * sw (C_out, 1, 1), then the product, in the JAX order
        return (y.to(x.device, torch.float32) * (sx * sw)[None, :, :, 0]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        # the float convolution's backward, as autograd runs it for
        # F.conv1d(F.pad(x, pad), weight): no forward is recomputed
        x, weight = ctx.saved_tensors
        stride, pad, dilation, groups = ctx.conf
        need_x, need_w = ctx.needs_input_grad[:2]
        gx, gw, _ = torch.ops.aten.convolution_backward(
            g.contiguous(), F.pad(x, pad), weight, None, [stride], [0], [dilation], False, [0], groups,
            [need_x, need_w, False])
        if gx is not None:
            gx = gx.narrow(-1, pad[0], x.shape[-1])
        return gx, gw, None, None, None, None


def conv1d_int8_ste(x: torch.Tensor, weight: torch.Tensor, stride: int, pad: Tuple[int, int],
                    dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """int8 forward convolution of ``x`` (B, C_in, T) with ``weight``
    (C_out, C_in/g, k) and zero padding ``pad`` = (left, right); the
    backward is the float convolution's (straight-through).  The output
    has ``x``'s dtype; give ``weight`` in it too, as the JAX package does."""
    return _Int8ConvSTE.apply(x, weight, int(stride), (int(pad[0]), int(pad[1])), int(dilation), int(groups))
