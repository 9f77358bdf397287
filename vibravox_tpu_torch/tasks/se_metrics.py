"""Speech-enhancement eval metrics, the reference's BaseSE logic (PyTorch).

Counterpart of ``vibravox_tpu/tasks/se_metrics.py``
(``lightning_modules/base_se.py:67-128``): metrics at 16 kHz after
resampling.  With a reference signal: SI-SDR (on the tensors' device) and
STOI (on the host), and the first clean batch kept as ``first_sample``, the
non-matching reference of the reference-free MOS.

The SQUIM predictors (``torchsquim_stoi``, ``noresqa_mos``) are not ported
yet (ROADMAP Queue 1 item 12): their slots stay ``None``, and asking for
them, by ``squim_dir`` or ``$VIBRAVOX_SQUIM_DIR``, raises.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from vibravox_tpu_torch.metrics.audio import si_sdr, stoi
from vibravox_tpu_torch.ops.resample import resample

__all__ = ["SEMetrics"]


class SEMetrics:
    def __init__(self, sample_rate: int, squim_dir: Optional[str] = None):
        if squim_dir or os.environ.get("VIBRAVOX_SQUIM_DIR"):
            raise NotImplementedError(
                "the SQUIM metrics are not ported yet (ROADMAP Queue 1 item 12); "
                "unset VIBRAVOX_SQUIM_DIR and pass no squim_dir")
        self.sample_rate = sample_rate
        self.first_sample: Optional[np.ndarray] = None
        self.squim_stoi = None
        self.noresqa_mos = None

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
            if self.first_sample is None:
                self.first_sample = reference_np
        return metrics
