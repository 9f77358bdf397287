"""Device traces: kernels by kind, the device's busy time, idle gaps.

A frozen copy of the port's measurement method (``chip_smoke.py``:
``kernel_kind``, ``cuda_trace``, ``device_profile``): a CUDA-only
``torch.profiler`` trace, led by ``LEAD_LAUNCHES`` launches of a kernel no
path runs (a trace can lose the kernels launched at its start, so the
trace is taken again until the lead shows); busy time is the union of the
kernels' intervals, since kernels on concurrent streams overlap.  A second,
short trace with the host's activity names what the host was doing in the
device's longest idle gaps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

# the hand-written kernels' CUDA names (the port's ops/csrc/*.cu)
K1_KERNELS = ("residual_stack_mma_kernel", "relayout_weights_kernel")
K2_KERNELS = ("unit_forward", "unit_backward", "reduce_partials_kernel", "layout_unit_weights")
LEAD_LAUNCHES = 64
ATTEMPTS = 4
LEAD = "xor"


def kernel_kind(name: str) -> str:
    """The kind of a CUDA kernel, from its name."""
    low = name.lower()
    if any(k in name for k in K1_KERNELS):
        return "K1 fused_residual"
    if any(s in name for s in K2_KERNELS):
        return "K2 fused_residual_bwd"
    if "framed_dft_magnitude_kernel" in name:
        return "K3 framed_dft_magnitude"
    if "framed_dft_backward" in name:
        return "K4 framed_dft_backward"
    if "ctc" in low:
        return "CTC"
    if any(s in low for s in ("flash", "fmha", "attention", "efficient")):
        return "attention"
    if "multi_tensor_apply" in low or "adam" in low:
        return "Adam"
    if any(s in low for s in ("nchwtonhwc", "nhwctonchw", "transpose")):
        return "NCHW<->NHWC transposes"
    if any(s in low for s in ("dgrad", "wgrad")) or ("conv" in low and "bwd" in low):
        return "conv backward"
    if any(s in low for s in ("conv", "fprop", "implicit", "cudnn")):
        return "conv forward"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "cublas", "xmma", "sm90_")):
        return "GEMMs"
    if "reflection" in low:
        return "reflection pad"
    if "elu" in low:
        return "activations (GELU, leaky ReLU)"
    if "reduce" in low or "norm" in low:
        return "norms and reductions"
    return "other elementwise (casts, pads, adds, copies)"


@dataclasses.dataclass
class Kernel:
    name: str
    kind: str
    start_us: float
    end_us: float


@dataclasses.dataclass
class Trace:
    """What a traced run of ``units`` steps read."""

    kernels: List[Kernel]
    wall_s: float  # host seconds from the traced work's start to its synchronised end
    units: int
    attempts: int
    host: List[Tuple[float, float, str]] = dataclasses.field(default_factory=list)

    def busy_s(self) -> float:
        busy, end = 0.0, float("-inf")
        for k in sorted(self.kernels, key=lambda k: k.start_us):
            busy += max(0.0, k.end_us - max(k.start_us, end))
            end = max(end, k.end_us)
        return busy / 1e6

    def by_kind_s(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for k in self.kernels:
            out[k.kind] = out.get(k.kind, 0.0) + (k.end_us - k.start_us) / 1e6
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _traced(run_one: Callable[[], None], calls: int, device, host: bool, attempt: int) -> Optional[Trace]:
    """One trace of ``calls`` calls of ``run_one``, or None when it lost its
    lead.  ``host``: record the host's activity too (for ``idle_gaps``; its
    cost stretches the idle share, so the metrics read a trace without it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lead = torch.zeros(1, dtype=torch.int32, device=device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])) as prof:
        t0 = time.perf_counter()
        for _ in range(LEAD_LAUNCHES):
            lead.bitwise_xor_(1)
        for _ in range(calls):
            run_one()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    events = list(prof.events())
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    if not any(LEAD in e.name.lower() for e in on_device):
        return None
    kernels = [Kernel(e.name, kernel_kind(e.name), e.time_range.start, e.time_range.end)
               for e in on_device if LEAD not in e.name.lower()]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == DeviceType.CPU and e.time_range.end > e.time_range.start]
    return Trace(kernels, wall, calls, attempt, spans)


def trace_calls(run_one: Callable[[], None], calls: int, device, host: bool = False) -> Trace:
    """A trace of ``calls`` calls of ``run_one`` (warm), taken again up to
    ATTEMPTS times until it holds its lead; raises if none does."""
    for attempt in range(1, ATTEMPTS + 1):
        trace = _traced(run_one, calls, device, host, attempt)
        if trace is not None:
            return trace
    raise RuntimeError(f"no trace of {calls} calls held its lead in {ATTEMPTS} attempts")


def idle_gaps(trace: Trace, top: int = 10) -> List[Tuple[str, float]]:
    """The device's idle gaps in a trace with the host's activity, summed by
    the innermost host span running at each gap's middle (the benchmark's
    ``record_function`` spans and the operators under them), the largest
    ``top``: [name, seconds]."""
    host = trace.host
    starts = np.array([h[0] for h in host], dtype=np.float64)
    ends = np.array([h[1] for h in host], dtype=np.float64)
    gaps: Dict[str, float] = {}
    end = None
    for k in sorted(trace.kernels, key=lambda k: k.start_us):
        if end is not None and k.start_us > end:
            mid = (k.start_us + end) / 2
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            name = host[inside[np.argmax(starts[inside])]][2][:96] if inside.size else "host outside any span"
            gaps[name] = gaps.get(name, 0.0) + (k.start_us - end) / 1e6
        end = k.end_us if end is None else max(end, k.end_us)
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:top]


def top_kinds(trace: Trace, top: int = 10) -> List[Tuple[str, float]]:
    return list(trace.by_kind_s().items())[:top]


