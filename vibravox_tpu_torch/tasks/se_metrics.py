"""Speech-enhancement eval metrics, the reference's BaseSE logic (PyTorch).

Counterpart of ``vibravox_tpu/tasks/se_metrics.py``
(``lightning_modules/base_se.py:67-128``): metrics at 16 kHz after
resampling.

* With a reference signal: SI-SDR (on the tensors' device) and STOI (on the
  host), and, when the SQUIM predictors are loaded, ``torchsquim_stoi`` of
  the enhanced signal and ``noresqa_mos`` against the true reference; the
  first clean batch is kept as ``first_sample``, the non-matching reference
  of the reference-free MOS.
* Without one (real noisy speech): ``torchsquim_stoi``, and ``noresqa_mos``
  against ``first_sample`` tiled to the batch once one is kept.

The SQUIM predictors come from ``squim_dir`` or ``$VIBRAVOX_SQUIM_DIR``
(``vibravox_tpu_torch.metrics.squim.load_squim_predictors``) and run on
``device``; a missing file leaves its metric out.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from vibravox_tpu_torch.device import DeviceLike
from vibravox_tpu_torch.metrics.audio import si_sdr, stoi
from vibravox_tpu_torch.metrics.squim import NoresqaMOS, TorchsquimSTOI, load_squim_predictors
from vibravox_tpu_torch.ops.resample import resample

__all__ = ["SEMetrics"]


class SEMetrics:
    def __init__(self, sample_rate: int, squim_dir: Optional[str] = None, device: DeviceLike = None):
        """``device``: where the SQUIM predictors run, ``None`` for the GPU
        (raises without one when a predictor is loaded), or ``"cpu"``."""
        self.sample_rate = sample_rate
        self.first_sample: Optional[np.ndarray] = None
        objective, subjective = load_squim_predictors(squim_dir, device)
        self.squim_stoi = TorchsquimSTOI(objective) if objective else None
        self.noresqa_mos = NoresqaMOS(predictor=subjective) if subjective else None

    def _to_16k(self, audio: torch.Tensor) -> torch.Tensor:
        return resample(audio, self.sample_rate, 16000, window="hann")

    def __call__(self, outputs: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """outputs: ``enhanced`` (B, T, 1) and optionally ``reference``."""
        enhanced16 = self._to_16k(outputs["enhanced"].float())[:, :, 0]
        metrics: Dict[str, float] = {}
        if "reference" in outputs:
            reference16 = self._to_16k(outputs["reference"].float())[:, :, 0]
            metrics["torchmetrics_si_sdr"] = float(si_sdr(enhanced16, reference16))
            enhanced_np, reference_np = enhanced16.cpu().numpy(), reference16.cpu().numpy()
            metrics["torchmetrics_stoi"] = float(np.mean([
                stoi(r, e, fs=16000) for r, e in zip(reference_np, enhanced_np)
            ]))
            if self.squim_stoi is not None:
                metrics["torchsquim_stoi"] = self.squim_stoi(enhanced16)
            if self.noresqa_mos is not None:
                metrics["noresqa_mos"] = self.noresqa_mos(enhanced16, reference16)
            if self.first_sample is None:
                self.first_sample = reference_np
        else:
            if self.squim_stoi is not None:
                metrics["torchsquim_stoi"] = self.squim_stoi(enhanced16)
            if self.noresqa_mos is not None and self.first_sample is not None:
                reps = -(-enhanced16.shape[0] // self.first_sample.shape[0])
                nmr = np.tile(self.first_sample, (reps, 1))[:enhanced16.shape[0]]
                metrics["noresqa_mos"] = self.noresqa_mos(enhanced16, nmr)
        return metrics
