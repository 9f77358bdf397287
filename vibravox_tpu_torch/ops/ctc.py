"""CTC loss (Graves et al., 2006) with the JAX package's contract.

Counterpart of ``vibravox_tpu/ops/ctc.py::ctc_loss`` (``optax.ctc_loss``
semantics): per-sequence negative log-likelihoods of right-padded labels
under a blank-inserted lattice.  The port computes it with
``F.ctc_loss(reduction="none")`` on the float32 ``log_softmax`` of the
logits: the JAX function is an XLA scan, not a TPU kernel.

Input lengths come from ``logit_paddings``, target lengths from
``label_paddings``, and padded labels are cleaned to 0.  A feasible target
gives the JAX value.  An infeasible one (the labels and the blanks forced
between repeats need more frames than there are) gives ``inf`` here and a
large finite value in JAX, whose log-zero is ``-1e5``; ``zero_infinity`` is
not set, since 0 would hide such a target.  CUDA's backward is not
deterministic: compare it with a relative tolerance.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ctc_loss"]


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """``logits`` (B, T, K); ``logit_paddings`` (B, T), 1.0 where padded;
    ``labels`` (B, N) right-padded, ``label_paddings`` (B, N), 1.0 where
    padded.  Returns the (B,) float32 losses."""
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T, B, K)
    input_lengths = (1.0 - logit_paddings.float()).sum(-1).round().long()
    target_lengths = (1.0 - label_paddings.float()).sum(-1).round().long()
    targets = torch.where(label_paddings > 0, 0, labels).long()
    return F.ctc_loss(log_probs, targets, input_lengths, target_lengths, blank=blank_id,
                      reduction="none", zero_infinity=False)
