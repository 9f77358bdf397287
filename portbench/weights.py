"""Seeded parameters, made on the device in one draw, and handed to both sides.

Every parameter of a configuration is drawn from one ``torch.Generator`` on
the device: one normal draw for all of them, cut into leaves and scaled.
Weights (the directions ``original1`` of weight-normalised ones too) are
normal with deviation ``gain / sqrt(fan_in)``; a weight norm's gain
``original0`` is set to its direction's norm, so the effective weight is
the direction, as weight norm starts; biases are normal with deviation
0.01; a normalisation's weight is 1 and its bias 0; a SpecAugment embedding
is uniform in [0, 1).  The program loads these values; the reference takes
a copy of the same dict.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _fan_in(shape: Tuple[int, ...]) -> int:
    return math.prod(shape[1:]) if len(shape) > 1 else shape[0]


@torch.no_grad()
def seeded_params(shapes: Dict[str, Tuple[int, ...]], gen: torch.Generator, device,
                  gain: float) -> Dict[str, torch.Tensor]:
    names = list(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, size in zip(names, sizes):
        shape = tuple(shapes[name])
        x = flat[offset:offset + size].view(shape)
        u = uniform[offset:offset + size].view(shape)
        offset += size
        if name.endswith("norm.weight"):
            out[name] = torch.ones(shape, device=device)
        elif name.endswith("norm.bias"):
            out[name] = torch.zeros(shape, device=device)
        elif name.endswith("masked_spec_embed"):
            out[name] = u.clone()
        elif name.endswith(".bias"):
            out[name] = 0.01 * x
        elif name.endswith("original0"):
            continue  # set from its direction below
        else:
            out[name] = x * (gain / math.sqrt(_fan_in(shape)))
    for name in names:
        if name.endswith("original0"):  # the norm over the dimensions the gain is 1 along
            v = out[name.replace("original0", "original1")]
            g_shape = tuple(shapes[name])
            dims = tuple(d for d in range(v.dim()) if g_shape[d] == 1)
            out[name] = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True))
    return {n: out[n] for n in names}


def load_into(module: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copies ``params`` into ``module``'s parameters, which must be exactly
    these names and shapes (buffers are the module's own)."""
    own = dict(module.named_parameters())
    if set(own) != set(params):
        missing, extra = sorted(set(own) - set(params)), sorted(set(params) - set(own))
        raise ValueError(f"parameter names differ from the reference's: missing {missing[:5]}, extra {extra[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            if tuple(p.shape) != tuple(params[name].shape):
                raise ValueError(f"{name}: the program has {tuple(p.shape)}, the reference {tuple(params[name].shape)}")
            p.copy_(params[name])
