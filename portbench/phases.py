"""Device time by phase of a train step, from a trace with the host's
activity (``harness.py``'s ``host_trace``).

The port opens a span at each phase of its train steps
(``vibravox_tpu_torch/core/profiler.py::span``; ``tasks/eben.py``,
``tasks/wav2vec2_stp.py``).  A kernel belongs to the phase that launched
it: the phase span open on the host when its launch call ran.  Not the
phase open while it ran on the device: the device runs behind the host, so
the host is then usually in a later phase.  Backward kernels are launched
by the autograd engine's own thread while the caller waits in
``backward()`` or ``autograd.grad``, so a launch is put down to a span by
time alone, whatever its thread.

A trace of ``trace.py`` keeps each device event's name and interval and
each host event's name and interval, not the correlation ids that tie a
kernel to its launch call.  So the i-th launch call is taken to have made
the i-th device event by start, both counted from the end: a trace loses
events at its start only, and ``trace.py`` leaves out the kernels of the
trace's lead, whose calls come first.  Where the libraries put a kernel on
a second stream, two neighbours can start in the other order than they
were launched; that moves time between phases only where the two sit on
either side of a phase's edge.  Among the device events the profiler also copies each
innermost ``record_function`` range onto the device's timeline (from its
first kernel's start to its last one's end, named as the range): those are
no kernels, and are left out by name.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

# the phase spans of the port's train steps, by the metric that sums them
PHASES: Dict[str, Tuple[str, ...]] = {
    "forward": ("eben.generator.forward", "eben.discriminator.forward", "stp.forward"),
    "balancing": ("eben.generator.balancing",),
    "backward": ("eben.generator.backward", "eben.discriminator.backward", "stp.backward"),
    "optimizer": ("eben.generator.optimizer", "eben.discriminator.optimizer", "stp.optimizer"),
}
SPANS = frozenset(s for names in PHASES.values() for s in names)
UNATTRIBUTED = "unattributed"
# the CUDA calls that enqueue one device event each (kernel, copy or fill)
LAUNCHES = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaLaunchCooperativeKernel", "cudaMemcpyAsync", "cudaMemcpy", "cudaMemcpy2DAsync",
    "cudaMemsetAsync", "cudaMemset",
))


class _Spans:
    """The trace's phase spans, looked up by host time (phases do not nest)."""

    def __init__(self, host: Sequence[Tuple[float, float, str]]):
        self.spans = sorted((s, e, n) for s, e, n in host if n in SPANS)
        self.starts = [s for s, _, _ in self.spans]

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        return self.spans[i][2] if i >= 0 and t <= self.spans[i][1] else UNATTRIBUTED


def kernels(trace) -> List:
    """The trace's kernels, copies and fills by start, without the ranges
    the profiler copies from the host (named as a host event)."""
    host = {n for _, _, n in trace.host}
    return sorted((k for k in trace.kernels if k.name not in host), key=lambda k: k.start_us)


def attributed(trace) -> Optional[List[Tuple[object, str]]]:
    """(kernel, the phase span that launched it or ``UNATTRIBUTED``) for
    each of ``kernels(trace)``; None when the trace holds no phase span."""
    if trace is None or not any(n in SPANS for _, _, n in trace.host):
        return None
    spans = _Spans(trace.host)
    calls = [spans.at(s) for s in sorted(s for s, _, n in trace.host if n in LAUNCHES)]
    ks = kernels(trace)
    n = min(len(calls), len(ks))
    unmatched = len(ks) - n  # kernels before the first call kept: none where no call went unrecorded
    return [(k, UNATTRIBUTED) for k in ks[:unmatched]] + list(zip(ks[unmatched:], calls[len(calls) - n:]))


def by_span_s(trace) -> Optional[Dict[str, float]]:
    """Device seconds of the trace's kernels by the phase span that launched
    them (``UNATTRIBUTED`` for those launched outside every phase); None
    when the trace holds no phase span."""
    pairs = attributed(trace)
    if pairs is None:
        return None
    out: Dict[str, float] = {}
    for k, name in pairs:
        out[name] = out.get(name, 0.0) + (k.end_us - k.start_us) / 1e6
    return out


def idle_by_span_s(trace) -> Optional[Dict[str, float]]:
    """The device's idle gaps between the trace's kernels, in seconds, by
    the phase span open on the host at each gap's middle (``UNATTRIBUTED``
    where none was); None without phase spans.  The host's profiling
    stretches these gaps, not the kernels."""
    if trace is None or not any(n in SPANS for _, _, n in trace.host):
        return None
    spans = _Spans(trace.host)
    out: Dict[str, float] = {}
    end = None
    for k in kernels(trace):
        if end is not None and k.start_us > end:
            name = spans.at((k.start_us + end) / 2)
            out[name] = out.get(name, 0.0) + (k.start_us - end) / 1e6
        end = k.end_us if end is None else max(end, k.end_us)
    return out


def ms_per_step(run, phase: str) -> Optional[float]:
    """Device ms a traced step of the kernels that ``phase``'s spans
    launched (``PHASES``), from the host trace; None where the trace holds
    none of those spans."""
    trace = run.host_trace
    if trace is None or not trace.units or not any(n in PHASES[phase] for _, _, n in trace.host):
        return None
    spans = by_span_s(trace)
    return 1e3 * sum(spans.get(n, 0.0) for n in PHASES[phase]) / trace.units
