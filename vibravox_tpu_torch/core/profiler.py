"""Profiling: per-step timing statistics and a profiler trace window (PyTorch).

Counterpart of ``vibravox_tpu/core/profiler.py``: a step timer whose
percentiles land in the epoch's logs, and ``trace_window``, a
``torch.profiler`` trace (CPU and CUDA activities) written as a Chrome
trace into ``trace_dir``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["StepTimer", "trace_window"]


class StepTimer:
    """Records wall time per step; computes summary stats on demand.  The
    first ``warmup_steps`` steps are left out (kernel builds, cuDNN's
    algorithm search)."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._count += 1
        if self._count > self.warmup_steps:
            self._times.append(dt)

    def summary(self, prefix: str = "profile/") -> Dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            f"{prefix}step_ms_mean": float(arr.mean() * 1e3),
            f"{prefix}step_ms_p50": float(np.percentile(arr, 50) * 1e3),
            f"{prefix}step_ms_p95": float(np.percentile(arr, 95) * 1e3),
            f"{prefix}step_ms_max": float(arr.max() * 1e3),
            f"{prefix}steps_per_sec": float(1.0 / arr.mean()),
        }


class trace_window:
    """Context manager: a ``torch.profiler`` trace of the block, exported to
    ``trace_dir/trace.json`` on exit."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        prof, self._prof = self._prof, None
        if prof is not None:
            prof.__exit__(*exc)
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.trace_dir, "trace.json"))
        return False
