"""What every train cell's session does the same way: the checked steps
through the window's own call, and the numbers that hold them to the plain
reference.

An adapter's session subclasses ``TrainSession``.  Its ``__init__`` builds
``task`` and ``state`` (the program's step and its state), ``init`` (leaf
name -> the seeded tensor that both sides start from), ``batches`` and
``audio_s`` (the pool, made on the device), ``dtype`` (the compute dtype)
and ``betas`` (Adam's); it says ``leaves()`` (each trained leaf of the
program: name, parameter, optimizer), ``losses(logs)`` (a step's logged
losses by the reference's names), ``reference_steps(steps, prec)`` (the
reference's losses a step, its first gradients' norms and its parameters
after the steps) and, where it trains more than one network, ``group``.

The first ``CHECK_STEPS`` steps run in set-up on the pool's first batches.
After the first, each leaf's gradient norm is read from Adam's first moment
(exp_avg = (1 - beta1) g after one step); after the last, each leaf's change
from the seeded weights.  ``check`` runs the reference's steps from the
same weights and batches once the program is freed, and compares
(``reference.common.train_numbers``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import torch

from portbench.reference.common import Precision, leaf_norms, train_numbers

CHECK_STEPS = 3


class TrainSession:
    task: Any
    state: Any
    init: Dict[str, torch.Tensor]
    batches: List[Dict[str, torch.Tensor]]
    audio_s: List[float]
    dtype: torch.dtype
    betas: Tuple[float, float]
    prec: Precision = Precision()  # the reference's own precision

    def leaves(self) -> Iterator[Tuple[str, torch.nn.Parameter, torch.optim.Optimizer]]:
        raise NotImplementedError

    def losses(self, logs: Dict[str, Any]) -> Dict[str, float]:
        raise NotImplementedError

    def reference_steps(self, steps: int, prec: Precision):
        """(losses a step, first gradients' norms, parameters after ``steps``)."""
        raise NotImplementedError

    @staticmethod
    def group(leaf: str) -> str:
        """The network a leaf belongs to; each network's median leaf is compared."""
        return "model"

    def step(self, i: int) -> None:
        self.task.train_step(self.state, self.batches[i])

    def start(self) -> int:
        """The checked steps, through the window's own call; returns how many."""
        self.logs: List[Dict[str, float]] = []
        for i in range(CHECK_STEPS):
            _, logs = self.task.train_step(self.state, self.batches[i])
            self.logs.append(self.losses(logs))
            if i == 0:
                self.first_grads = leaf_norms({n: opt.state[p]["exp_avg"] / (1 - self.betas[0])
                                               for n, p, opt in self.leaves() if p in opt.state})
        self.change = self.changes({n: p for n, p, _ in self.leaves()})
        return CHECK_STEPS

    def changes(self, params: Dict[str, torch.Tensor]) -> Dict[str, float]:
        return leaf_norms({n: p.detach() - self.init[n] for n, p in params.items()})

    def free(self) -> None:
        del self.task, self.state
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        """The reference's steps from the same weights and batches, and the
        numbers: those compared and the readings kept beside them."""
        logs, grads, params = self.reference_steps(len(self.logs), self.prec)
        return train_numbers(self.logs, logs, self.first_grads, grads, self.change, self.changes(params),
                             self.group)
