"""Faults planted in the program under a run, for the tests and the readings
tool; a benchmark run never plants one.  Each turns a sound train run into
one whose ``correct`` has to read false:

* ``half_batch``: the step sees the first half of each batch, so its mean
  is taken over the rest;
* ``state_unchanged``: every optimizer's step does nothing;
* ``generator_unchanged``: EBEN's generator optimizer does nothing while
  the discriminator trains;
* ``k2_dx``: the residual stacks' backward (K2 on the card, its plain
  version on the CPU) returns half of dx; their weights' gradients stay.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Tuple

import torch

FAULTS = ("half_batch", "state_unchanged", "generator_unchanged", "k2_dx")


def _task_classes():
    from vibravox_tpu_torch.tasks.eben import EBENTask
    from vibravox_tpu_torch.tasks.wav2vec2_stp import Wav2Vec2STPTask

    return EBENTask, Wav2Vec2STPTask


def _halved(step):
    def train_step(self, state, batch):
        return step(self, state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    return train_step


def _generator_frozen(init_state):
    def frozen(self, *args, **kwargs):
        state = init_state(self, *args, **kwargs)
        state.generator_optimizer.step = lambda *a, **k: None
        return state

    return frozen


def _k2_dx_halved(stack):
    from vibravox_tpu_torch.ops import fused_residual

    class Stack(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dilations, slope, *flat):
            ctx.dilations, ctx.slope = dilations, slope
            ctx.save_for_backward(x, *flat)
            return stack(x, _pairs(flat), dilations, slope)

        @staticmethod
        def backward(ctx, g):
            x, *flat = ctx.saved_tensors
            dx, dws = fused_residual.residual_stack_backward(x, _pairs(flat), g, ctx.dilations, ctx.slope)
            return (0.5 * dx, None, None, *[w for pair in dws for w in pair])

    def residual_stack(x, kernels, dilations, slope):
        return Stack.apply(x, tuple(dilations), float(slope), *[w for pair in kernels for w in pair])

    return residual_stack


def _pairs(flat) -> Tuple:
    return tuple((flat[2 * u], flat[2 * u + 1]) for u in range(len(flat) // 2))


@contextlib.contextmanager
def planted(fault: str) -> Iterator[None]:
    """The program with ``fault`` planted inside the block."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; there are {FAULTS}")
    from vibravox_tpu_torch.models import eben_generator

    eben, w2v2 = _task_classes()
    patches: List[Tuple[object, str, object]] = []
    if fault == "half_batch":
        patches = [(cls, "train_step", _halved(cls.train_step)) for cls in (eben, w2v2)]
    elif fault == "state_unchanged":
        patches = [(torch.optim.Adam, "step", lambda self, closure=None: None)]
    elif fault == "generator_unchanged":
        patches = [(eben, "init_state", _generator_frozen(eben.init_state))]
    else:
        patches = [(eben_generator, "residual_stack", _k2_dx_halved(eben_generator.residual_stack))]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    try:
        for owner, name, value in patches:
            setattr(owner, name, value)
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)
