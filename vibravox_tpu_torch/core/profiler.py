"""Profiling: the training loop's period, a profiler trace window, and the
train steps' phase spans (PyTorch).

Counterpart of ``vibravox_tpu/core/profiler.py``: a step timer whose
percentiles land in the epoch's logs; ``trace_window``, a
``torch.profiler`` trace (CPU and CUDA activities) written as a Chrome
trace into ``trace_dir``; and ``span``, a named range on the profiler's
timeline while one records, and nothing otherwise.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["StepTimer", "span", "trace_window"]

# a trace can lose the kernels launched at its start: it is led by this many
# launches of a kernel no step runs
LEAD_LAUNCHES = 64

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a range while a
    ``torch.profiler`` records, on the same clock as the kernels of a device
    trace: kernels are put down to the span that was open on the host when
    they were launched.  Otherwise the one shared null context, so an
    untraced step pays a flag check a span, not a ``record_function``."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


class StepTimer:
    """The training loop's period: host seconds from one step's start to
    the next step's start.  A step returns once its kernels are enqueued, so
    the time to its return is the enqueue; the period of a loop whose
    device keeps up is the step's own time, the wait for the next batch and
    the loop's logging included.  ``start`` opens a period at a step's start
    and closes the previous one; ``stop`` closes the open period and opens
    none: the loop calls it at an epoch's end, once the device has caught
    up, so validation and checkpoints fall in no period.  The first
    ``warmup_steps`` periods are left out (kernel builds, cuDNN's algorithm
    search)."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def _close(self, now: float) -> None:
        if self._t0 is None:
            return
        self._count += 1
        if self._count > self.warmup_steps:
            self._times.append(now - self._t0)

    def start(self) -> None:
        now = time.perf_counter()
        self._close(now)
        self._t0 = now

    def stop(self) -> None:
        self._close(time.perf_counter())
        self._t0 = None

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
    ``trace_dir/trace.json`` on exit.  On CUDA the trace is led by
    ``LEAD_LAUNCHES`` launches of an int32 xor, which no step runs, so the
    trace's losses at its start fall on them and not on the block's first
    kernels."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        lead = None
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
            lead = torch.zeros(1, dtype=torch.int32, device="cuda")
            torch.cuda.synchronize()
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        if lead is not None:
            for _ in range(LEAD_LAUNCHES):
                lead.bitwise_xor_(1)
        return self

    def __exit__(self, *exc):
        prof, self._prof = self._prof, None
        if prof is not None:
            prof.__exit__(*exc)
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.trace_dir, "trace.json"))
        return False
