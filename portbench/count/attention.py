"""Operations and bytes of a gated-bias attention layer's forward and
backward, the work the architecture needs whatever implements it.

One layer of softmax(q k^T / sqrt(d) + gate P) v over q, k, v (B, H, T, d),
with P (H, T, T) shared by the batch and the gate (B, H, T) per query:

* operations: q k^T and the weights times v forward, and backward the four
  products that give dq, dk (from the scores' gradient) and dv and the
  weights' gradient: 6 products of 2 B H T^2 d FLOP each;
* bytes: q, k, v, o and their four gradients read or written once (8 B H T
  d elements), P and its gradient (2 H T^2), the gate and its gradient
  (2 B H T), in the compute dtype.

The B H T^2 bias that a library attention is handed today, its gradient,
the scores and the softmax are not counted: a fused kernel need not make
them, so a later one is read against the same work.
"""

from __future__ import annotations

from typing import Tuple

import torch

from portbench.count.bounds import _size, bound_s as _bound_s


def work(b: int, h: int, t: int, d: int, dtype: torch.dtype) -> Tuple[float, float]:
    """(FLOP, bytes) of one layer's attention forward and backward."""
    flops = 6 * 2.0 * b * h * t * t * d
    elements = 8 * b * h * t * d + 2 * h * t * t + 2 * b * h * t
    return flops, float(elements * _size(dtype))


def bound_s(b: int, h: int, t: int, d: int, dtype: torch.dtype) -> float:
    """One layer's least seconds: the larger of operations at the dtype's
    peak and bytes at 3.35 TB/s (``count/bounds.py``)."""
    return _bound_s(*work(b, h, t, d, dtype), dtype)
