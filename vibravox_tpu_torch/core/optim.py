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

__all__ = ["adam", "adamw", "sgd", "materialise", "step_counts_to_cpu", "MultiSteps"]

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


class MultiSteps:
    """``optax.MultiSteps`` over a ``torch.optim`` optimizer: each ``step()``
    folds the parameters' gradients into their running mean
    (``acc + (g - acc) / (n + 1)``, optax's Welford form); the k-th hands
    the mean to the inner optimizer, which steps, and starts the mean
    again.  The other calls leave the parameters and the inner state
    alone.  ``every_k=1`` is the inner optimizer's own step.

    ``state_dict`` is the inner optimizer's with ``acc`` (parameter index
    -> running mean) and ``mini_step``; ``param_groups`` and ``state`` are
    the inner optimizer's."""

    def __init__(self, optimizer: torch.optim.Optimizer, every_k: int):
        if every_k < 1:
            raise ValueError(f"accumulate_grad_batches must be >= 1, got {every_k}")
        self.inner, self.every_k, self.mini_step = optimizer, int(every_k), 0
        self.acc: dict = {}

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def _params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> bool:
        """True when the inner optimizer stepped."""
        if self.every_k == 1:
            self.inner.step()
            return True
        params = self._params()
        n = self.mini_step
        for i, p in enumerate(params):
            if p.grad is None:
                continue
            acc = self.acc.get(i)
            if acc is None:
                acc = self.acc[i] = torch.zeros_like(p.grad, dtype=torch.float32)
            acc.add_((p.grad.float() - acc) / (n + 1))
        self.mini_step = n + 1
        if self.mini_step < self.every_k:
            return False
        for i, p in enumerate(params):
            if i in self.acc:
                p.grad = self.acc[i].to(p.dtype)
        self.inner.step()
        self.acc, self.mini_step = {}, 0
        return True

    def state_dict(self) -> dict:
        sd = self.inner.state_dict()
        sd["acc"] = dict(self.acc)
        sd["mini_step"] = self.mini_step
        return sd

    def load_state_dict(self, sd: dict) -> None:
        sd = dict(sd)
        acc, self.mini_step = sd.pop("acc", {}), int(sd.pop("mini_step", 0))
        self.inner.load_state_dict(sd)
        params = self._params()
        self.acc = {int(i): t.to(params[int(i)].device, torch.float32) for i, t in acc.items()}


def accumulate(optimizer: torch.optim.Optimizer, every_k: int):
    """``optimizer`` itself for ``every_k == 1``, else :class:`MultiSteps`."""
    return optimizer if int(every_k) == 1 else MultiSteps(optimizer, every_k)
