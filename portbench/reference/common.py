"""Shared pieces of the plain references: precision, weight norm, convolutions, Adam.

Plain PyTorch only.  Nothing here imports the program under test: every
formula is written out again from its published description, so the
references hold the program to the mathematics and not to itself.

``Precision`` says how a reference computes its float32 products:
``tf32=False`` is IEEE float32 (TF32 off in cuDNN and cuBLAS), the
reference proper; ``tf32=True`` rounds every operand of a convolution or a
matrix product to TF32 (10 mantissa bits, round to nearest even) and
accumulates in float32, which is what TF32 tensor cores do.  That is the
control: the nearest precision below IEEE float32, on any device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import statistics
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Precision:
    """``compute``: the dtype that activations and weights are cast to at
    each product (None: float32); ``tf32``: round float32 operands to TF32."""

    compute: Optional[torch.dtype] = None
    tf32: bool = False

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute is not None:
            return x.to(self.compute)
        if self.tf32 and x.dtype == torch.float32:
            return round_tf32(x)
        return x


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even; the
    rounding is not differentiated (straight through), as a tensor core's
    operand conversion is not."""
    bits = x.detach().contiguous().view(torch.int32)
    low = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + low) & ~0x1FFF).view(torch.float32)
    finite = torch.isfinite(x.detach())
    return x + (torch.where(finite, rounded, x.detach()) - x).detach()


@contextlib.contextmanager
def ieee_float32() -> Iterator[None]:
    """cuDNN convolutions and CUDA matmuls in IEEE float32 inside the block
    (TF32 off); the caller's settings are restored after."""
    conv, matmul = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    previous = conv.fp32_precision, matmul.fp32_precision
    conv.fp32_precision = matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision, matmul.fp32_precision = previous


def weight_norm(params: Params, prefix: str, dims: Sequence[int]) -> torch.Tensor:
    """w = g * v / ||v||, the norm over ``dims`` (every dimension but the
    one that ``g`` runs along); g and v are stored as
    ``<prefix>.parametrizations.weight.original0`` and ``original1``."""
    g = params[f"{prefix}.parametrizations.weight.original0"]
    v = params[f"{prefix}.parametrizations.weight.original1"]
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(dims), keepdim=True))
    return v * (g / norm)


def wn_conv_weight(params: Params, prefix: str) -> torch.Tensor:
    """A weight-normalised convolution's weight: the gain per dimension 0."""
    return weight_norm(params, prefix, (1, 2))


def conv1d(x: torch.Tensor, w: torch.Tensor, prec: Precision, bias: Optional[torch.Tensor] = None,
           stride: int = 1, padding: Tuple[int, int] = (0, 0), dilation: int = 1, groups: int = 1,
           reflect: bool = False) -> torch.Tensor:
    """A 1-D convolution on NCW input with (left, right) padding, zeros or
    reflect, its operands cast by ``prec``."""
    if padding != (0, 0):
        x = F.pad(x, padding, mode="reflect" if reflect else "constant")
    x, w = prec.operand(x), prec.operand(w)
    if bias is not None:
        bias = bias.to(x.dtype)
    return F.conv1d(x, w.to(x.dtype), bias, stride, 0, dilation, groups)


def same_padding(kernel: int, dilation: int = 1) -> Tuple[int, int]:
    total = (kernel - 1) * dilation
    return total // 2, total - total // 2


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], prec: Precision) -> torch.Tensor:
    x, w = prec.operand(x), prec.operand(w)
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


@dataclasses.dataclass
class Adam:
    """torch.optim.Adam's update, written out: L2 weight decay 0, the bias
    corrections, eps added to the corrected root (``denom = sqrt(v) /
    sqrt(1 - beta2^t) + eps``)."""

    lr: float
    betas: Tuple[float, float]
    eps: float = 1e-8
    step: int = 0
    m: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    v: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @torch.no_grad()
    def update(self, params: Params, grads: Params) -> None:
        self.step += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.step, math.sqrt(1 - b2 ** self.step)
        for name, g in grads.items():
            m = self.m.setdefault(name, torch.zeros_like(g))
            v = self.v.setdefault(name, torch.zeros_like(g))
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            params[name].addcdiv_(m, v.sqrt() / c2 + self.eps, value=-self.lr / c1)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The L2 norm of each tensor, in float64 on the host."""
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].double()) for n in names]).cpu().tolist()
    return dict(zip(names, norms))


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              leaves: Optional[List[str]] = None) -> Dict[str, float]:
    """Per leaf of ``leaves`` (default: all), the gap between the program's
    norm and the reference's, against the larger of the reference's norm of
    that leaf and the median leaf's; a leaf the program lacks reads 1."""
    names = list(reference) if leaves is None else leaves
    median = statistics.median(reference.values())
    return {n: abs(program[n] - reference[n]) / max(reference[n], median, 1e-30) if n in program else 1.0
            for n in names}


def train_numbers(logs: List[Dict[str, float]], ref_logs: List[Dict[str, float]],
                  grads: Dict[str, float], ref_grads: Dict[str, float],
                  change: Dict[str, float], ref_change: Dict[str, float],
                  group: Callable[[str], str]) -> Dict[str, float]:
    """The numbers that hold a program's checked train steps to the reference's.

    ``first_loss_gap`` and ``loss_gap``: the widest relative gap of a logged
    loss at the first step and over all.  ``grad_norm_gap`` and
    ``change_norm_gap``: for each network (``group`` of a leaf's name), the
    median leaf's gap (``leaf_gaps``) of the first gradient's norms and of
    the change's norms after the steps; the larger over the networks, so
    that a fault in one network shows whatever the size of the other.
    Leaves whose reference gradient is under a thousandth of their
    network's median leaf's are left out of the change: they move by
    round-off alone.  Kept as readings: each network's medians (where there
    are several) and the worst leaf's gaps."""
    gaps = [max(abs(got[k] - v) / max(abs(v), 1e-30) for k, v in want.items())
            for got, want in zip(logs, ref_logs)]
    out = {"first_loss_gap": gaps[0], "loss_gap": max(gaps)}
    nets = sorted({group(n) for n in ref_grads})
    grad_gaps: Dict[str, float] = {}
    change_gaps: Dict[str, float] = {}
    for net in nets:
        net_grads = {n: v for n, v in ref_grads.items() if group(n) == net}
        floor = 1e-3 * statistics.median(net_grads.values())
        moved = [n for n, v in net_grads.items() if v >= floor]
        g = leaf_gaps(grads, net_grads)
        c = leaf_gaps(change, {n: v for n, v in ref_change.items() if group(n) == net}, moved)
        out[f"grad_norm_gap.{net}"] = statistics.median(g.values())
        out[f"change_norm_gap.{net}"] = statistics.median(c.values())
        grad_gaps.update(g)
        change_gaps.update(c)
    out["grad_norm_gap"] = max(out[f"grad_norm_gap.{net}"] for net in nets)
    out["change_norm_gap"] = max(out[f"change_norm_gap.{net}"] for net in nets)
    if len(nets) == 1:
        del out[f"grad_norm_gap.{nets[0]}"], out[f"change_norm_gap.{nets[0]}"]
    out["worst_grad_norm_gap"] = max(grad_gaps.values())
    out["worst_change_norm_gap"] = max(change_gaps.values())
    return out
