"""Reference-free quality metrics: SQUIM STOI and NORESQA-MOS (PyTorch).

Counterpart of ``vibravox_tpu/metrics/squim.py`` (the reference's
``metrics/torchsquim_stoi.py`` and ``metrics/noresqa_mos.py``): the metric
interface (``update`` / ``compute`` / ``__call__``, accumulating the mean)
over the networks of ``vibravox_tpu_torch.models.squim``.

Weights: ``load_squim_predictors`` reads ``squim_objective.pt`` and
``squim_subjective.pt`` from ``checkpoint_dir`` or ``$VIBRAVOX_SQUIM_DIR``;
each is a torch state dict in torchaudio's keys (or a TorchScript archive
of such a module), read by ``models/hub.py::load_state_dict`` (the JAX
loader also takes a pickled module, which the port refuses).  A missing
file leaves its metric out; a file whose keys or shapes do not fit the
architecture raises.  The predictors run on ``device``
(``None`` for the GPU, which raises without one, or ``"cpu"``) without
gradients, in IEEE float32.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from vibravox_tpu_torch.device import DeviceLike, resolve_device
from vibravox_tpu_torch.models.hub import load_state_dict
from vibravox_tpu_torch.models.squim import SquimObjective, SquimSubjective

__all__ = [
    "TorchsquimSTOI",
    "NoresqaMOS",
    "MissingPretrainedPredictor",
    "load_squim_objective",
    "load_squim_subjective",
    "load_squim_predictors",
]


class MissingPretrainedPredictor(RuntimeError):
    pass


# (apply_fn, model): apply_fn(model, *audio) -> (B,) scores
Predictor = Tuple[Callable, nn.Module]
Audio = Union[torch.Tensor, np.ndarray]


def _empty(make: Callable[[], nn.Module], device: torch.device) -> nn.Module:
    """The module without initialising its weights (built on the meta
    device, then given storage), to be filled by a state dict."""
    with torch.device("meta"):
        model = make()
    return model.to_empty(device=device).eval()


@torch.no_grad()
def _objective_stoi(model: SquimObjective, audio: torch.Tensor) -> torch.Tensor:
    return model(audio)[0]


@torch.no_grad()
def _subjective_mos(model: SquimSubjective, estimate: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    return model(estimate, reference)


def load_squim_objective(path: Union[str, Path], device: DeviceLike = None) -> Predictor:
    """A (B, T) audio -> (B,) STOI predictor from a torchaudio
    ``SquimObjective`` state dict."""
    dev = resolve_device(device)
    model = _empty(SquimObjective, dev)
    model.load_state_dict(load_state_dict(path), strict=True)
    return _objective_stoi, model


def load_squim_subjective(path: Union[str, Path], device: DeviceLike = None) -> Predictor:
    """A (B, T) estimate, (B, Tr) non-matching reference -> (B,) MOS
    predictor from a torchaudio ``SquimSubjective`` state dict."""
    dev = resolve_device(device)
    model = _empty(SquimSubjective, dev)
    model.load_torchaudio_state_dict(load_state_dict(path))
    return _subjective_mos, model


def load_squim_predictors(
    checkpoint_dir: Optional[Union[str, Path]] = None, device: DeviceLike = None,
) -> Tuple[Optional[Predictor], Optional[Predictor]]:
    """(objective, subjective) from ``checkpoint_dir`` or
    ``$VIBRAVOX_SQUIM_DIR``; a missing file gives ``None``."""
    root = checkpoint_dir or os.environ.get("VIBRAVOX_SQUIM_DIR")
    if not root:
        return None, None
    obj_path = Path(root) / "squim_objective.pt"
    subj_path = Path(root) / "squim_subjective.pt"
    objective = load_squim_objective(obj_path, device) if obj_path.exists() else None
    subjective = load_squim_subjective(subj_path, device) if subj_path.exists() else None
    return objective, subjective


class _AccumulatingMetric:
    def __init__(self, predictor: Optional[Predictor] = None):
        self.predictor = predictor
        self.total = 0.0
        self.count = 0

    def reset(self) -> None:
        self.total, self.count = 0.0, 0

    def compute(self) -> float:
        if self.count == 0:
            raise MissingPretrainedPredictor(
                f"{type(self).__name__} has no accumulated values: construct it with a SQUIM "
                "predictor (apply_fn, model) to enable reference-free evaluation")
        return self.total / self.count

    def _scores(self, *audio: Audio) -> torch.Tensor:
        if self.predictor is None:
            raise MissingPretrainedPredictor(
                f"{type(self).__name__} requires the SQUIM predictor weights "
                "(pass predictor=(apply_fn, model) or set VIBRAVOX_SQUIM_DIR)")
        apply_fn, model = self.predictor
        dev = next(model.parameters()).device
        scores = apply_fn(model, *(torch.as_tensor(a, dtype=torch.float32).to(dev) for a in audio))
        self.total += float(scores.sum())
        self.count += scores.numel()
        return scores


class TorchsquimSTOI(_AccumulatingMetric):
    """Reference-free STOI (torchaudio ``SQUIM_OBJECTIVE``).  The batch is
    flattened into one signal first, as the reference does
    (``torchsquim_stoi.py:62``)."""

    def update(self, preds: Audio) -> None:
        self._scores(preds.reshape(1, -1))

    def __call__(self, preds: Audio) -> float:
        return float(self._scores(preds.reshape(1, -1)).mean())


class NoresqaMOS(_AccumulatingMetric):
    """MOS against a non-matching reference (torchaudio ``SQUIM_SUBJECTIVE``)."""

    def __init__(self, sample_rate: int = 16000, predictor: Optional[Predictor] = None):
        super().__init__(predictor)
        if sample_rate != 16000:
            raise ValueError(f"the MOS predictor runs at 16 kHz, got {sample_rate}")

    def update(self, preds: Audio, non_matching_reference: Audio) -> None:
        self._scores(preds, non_matching_reference)

    def __call__(self, preds: Audio, non_matching_reference: Audio) -> float:
        return float(self._scores(preds, non_matching_reference).mean())
