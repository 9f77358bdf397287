"""Optimizer factories with the JAX package's argument names (PyTorch).

Counterpart of ``vibravox_tpu/core/optim.py``, whose optax chains copy
``torch.optim`` semantics (``configs/lightning_module/optimizer/adam.yaml``:
lr 3e-4, betas (0.5, 0.9)).  Here each factory returns a partial that builds
the ``torch.optim`` optimizer over the parameters it is given, the
reference's ``_partial_: true`` configs.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, Sequence

import torch

__all__ = ["adam", "adamw", "sgd", "materialise", "step_counts_to_cpu"]

OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


def adam(
    lr: float = 1e-3,
    betas: Sequence[float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    amsgrad: bool = False,
) -> OptimizerFactory:
    """``torch.optim.Adam`` (L2 added to the gradient, not decoupled)."""
    return functools.partial(
        torch.optim.Adam, lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
        amsgrad=amsgrad,
    )


def sgd(
    lr: float = 1e-3, momentum: float = 0.0, weight_decay: float = 0.0, nesterov: bool = False
) -> OptimizerFactory:
    """``torch.optim.SGD``."""
    return functools.partial(
        torch.optim.SGD, lr=lr, momentum=momentum, weight_decay=weight_decay, nesterov=nesterov
    )


def adamw(
    lr: float = 1e-3, betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8,
    weight_decay: float = 0.01,
) -> OptimizerFactory:
    """``torch.optim.AdamW`` (decoupled weight decay)."""
    return functools.partial(
        torch.optim.AdamW, lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay
    )


def step_counts_to_cpu(optimizer: torch.optim.Optimizer) -> None:
    """Puts the step counts of a loaded optimizer back on the CPU where it
    keeps them (neither capturable nor fused).  ``load_state_dict`` leaves
    them where the checkpoint was mapped, and a step count on the GPU costs
    Adam two host syncs per parameter tensor per step."""
    for group in optimizer.param_groups:
        if group.get("capturable") or group.get("fused"):
            continue
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if isinstance(state.get("step"), torch.Tensor):
                state["step"] = state["step"].cpu()


def materialise(opt: Callable) -> Callable[..., torch.optim.Optimizer]:
    """A config's ``_partial_`` optimizer (``partial(adam, lr=...)``) called
    once, as the JAX task does, into a factory over parameters; a factory
    (a partial of a ``torch.optim.Optimizer`` class) is kept."""
    if isinstance(opt, functools.partial) and not (
            isinstance(opt.func, type) and issubclass(opt.func, torch.optim.Optimizer)):
        return opt()
    return opt
