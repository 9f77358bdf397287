"""Trainer callbacks (config-composable), PyTorch.

Counterpart of ``vibravox_tpu/core/callbacks.py``: the reference's
``RichModelSummary(max_depth=3)`` (``configs/callbacks/rich_model_summary.yaml``)
as an object the trainer calls once a fit has its state.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from torch import nn

__all__ = ["ModelSummary"]


class ModelSummary:
    """Parameter counts of the train state's networks (its ``nn.Module``
    fields), per submodule down to ``max_depth`` (depth 1: one line per
    network, Lightning's default ``ModelSummary``; the reference's config
    uses 3).  The total equals the JAX summary's on the same architecture."""

    def __init__(self, max_depth: int = 1):
        self.max_depth = int(max_depth)

    def _rows(self, name: str, module: nn.Module, depth: int) -> List[Tuple[str, int]]:
        rows = [(name, sum(p.numel() for p in module.parameters()))]
        if depth < self.max_depth:
            for child_name, child in module.named_children():
                rows.extend(self._rows(f"{name}.{child_name}", child, depth + 1))
        return rows

    def summarize(self, state) -> str:
        """The formatted summary of a dataclass train state."""
        if state is None or not dataclasses.is_dataclass(state):
            return ""
        lines: List[str] = []
        total = 0
        for field in dataclasses.fields(state):
            module = getattr(state, field.name, None)
            if not isinstance(module, nn.Module):
                continue
            rows = self._rows(field.name, module, 1)
            total += rows[0][1]
            for name, count in rows:
                lines.append(f"{'  ' * name.count('.')}{name}: {count:,} params")
        if not lines:
            return ""
        return "\n".join(lines) + f"\ntotal: {total:,}"

    def __call__(self, state, logger) -> None:
        summary = self.summarize(state)
        if summary:
            print(f"[model summary]\n{summary}", flush=True)
            logger.log_text("model_summary", summary.replace("\n", " | "))
