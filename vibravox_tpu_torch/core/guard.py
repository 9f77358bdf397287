"""Failure detection: anomaly guard with checkpoint auto-restore (PyTorch).

Counterpart of ``vibravox_tpu/core/guard.py``.  The reference has no
failure detection (SURVEY §5): on a GAN recipe one non-finite step poisons
the parameters and then the next ``save_last`` checkpoint, the only restore
point.

* ``FailureGuard.scan`` inspects the per-step training logs the trainer
  floats anyway at the logging cadence for non-finite values, and
  optionally for divergence past an absolute loss bound;
  ``scan_every_n_steps`` adds denser scans at one host sync each.
* ``FailureGuard.scan_state`` is the end-of-epoch barrier: ``torch.isfinite``
  over every floating tensor of the train state (parameters and optimizer
  states).  The final step's backward can mint non-finite parameters while
  its forward loss is finite, so the trainer checks the state itself before
  any ``CheckpointManager.save`` can overwrite ``last``.
* On detection the trainer restores ``last`` (parameters, optimizer states,
  progress) and resumes, at most ``max_restores`` times; with no checkpoint
  or an exhausted budget it raises :class:`AnomalyDetected`.

Enable from config (``configs/trainer/ddp.yaml``)::

    failure_guard:            # or `failure_guard: true` for defaults
      max_restores: 2
      max_loss: 1e4
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Tuple

import torch

__all__ = ["AnomalyDetected", "FailureGuard"]


class AnomalyDetected(RuntimeError):
    """A non-finite/divergent training step that could not be recovered."""


@dataclass
class FailureGuard:
    """Policy + budget for training-anomaly recovery.

    ``max_restores`` bounds restore attempts for the whole run: a
    deterministic fault (e.g. corrupt input that reproduces after restore)
    fails loudly instead of livelocking.  ``max_loss`` (optional) flags
    divergence: any logged value whose key contains ``"loss"`` with
    ``|value| > max_loss``.  Non-finite values are flagged on every key.
    ``scan_every_n_steps`` (optional) scans the step logs every N steps in
    addition to the logging cadence — each extra scan costs one host sync
    (the logs must be floated), trading step-pipeline overlap for detection
    latency; at the default ``None`` detection waits for the next logged
    step (up to ``log_every_n_steps - 1`` garbage steps, bounded-loss risk
    only, since the epoch-end ``scan_state`` barrier still protects the
    checkpoint).
    """

    max_restores: int = 2
    max_loss: Optional[float] = None
    scan_every_n_steps: Optional[int] = None
    restores_used: int = field(default=0, init=False)

    def scan(self, logs: Dict[str, float]) -> Optional[str]:
        """Return a human-readable reason if ``logs`` contain an anomaly."""
        for key, value in logs.items():
            if not math.isfinite(value):
                return f"non-finite training log {key}={value}"
            if (
                self.max_loss is not None
                and "loss" in key
                and abs(value) > self.max_loss
            ):
                return f"divergent training log {key}={value} (max_loss={self.max_loss})"
        return None

    def scan_state(self, state) -> Optional[str]:
        """Return a reason if a floating tensor of ``state`` (its
        ``state_dict()``: parameters and optimizer states) is non-finite.
        One reduction and one readback per device (Adam keeps its step counts
        on the CPU); call at epoch end, immediately before
        ``CheckpointManager.save``."""
        tensors = list(_floating_tensors(state.state_dict()))
        flags: Dict[torch.device, list] = {}
        for _, t in tensors:
            flags.setdefault(t.device, []).append(torch.isfinite(t).all())
        if all(bool(torch.stack(f).all()) for f in flags.values()):
            return None
        for key, t in tensors:  # name the offending tensor
            if not bool(torch.isfinite(t).all()):
                return f"non-finite state tensor {key}"
        return "non-finite value in train state"


def _floating_tensors(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _floating_tensors(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _floating_tensors(v, f"{prefix}.{i}")
