"""The port's spans that the benchmark reads beside the phases of
``phases.py``: WavLM's gated-bias spans (``models/wavlm.py``), and every
span name the port or the harness opens, which the profiler copies onto
the device's timeline as events that are no kernels.

``launched_s`` puts a kernel down to a span as ``phases.py`` does: by its
launch call, the i-th launch call taken to have made the i-th device event,
both counted from the end of the trace.  Unlike the phases, these spans
open inside a phase (``stp.forward``), so they are looked up on their own.
"""

from __future__ import annotations

import bisect
from typing import FrozenSet, Optional

from portbench import phases

# layer 0's bucket table and lookup; each layer's gate and gated bias
GATED_BIAS = frozenset(("wavlm.relpos", "wavlm.gate"))
# the train steps' root spans and the harness's own
ROOTS = frozenset(("eben.train_step", "stp.train_step", "portbench.train_step"))
NAMES = phases.SPANS | GATED_BIAS | ROOTS


def kind_s(trace, kind: str) -> float:
    """Device seconds of the trace's kernels of ``kind`` (``trace.py``),
    leaving out the events named after a span."""
    return sum(k.end_us - k.start_us for k in trace.kernels if k.kind == kind and k.name not in NAMES) / 1e6


def launched_s(trace, names: FrozenSet[str]) -> Optional[float]:
    """Device seconds of the kernels launched while a span of ``names`` was
    open on the host (the spans of ``names`` do not overlap one another);
    None when the trace holds none of those spans."""
    if trace is None or not any(n in names for _, _, n in trace.host):
        return None
    spans = sorted((s, e) for s, e, n in trace.host if n in names)
    starts = [s for s, _ in spans]

    def inside(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= spans[i][1]

    calls = [inside(s) for s in sorted(s for s, _, n in trace.host if n in phases.LAUNCHES)]
    ks = phases.kernels(trace)
    n = min(len(calls), len(ks))
    return sum((k.end_us - k.start_us) / 1e6 for k, hit in zip(ks[len(ks) - n:], calls[len(calls) - n:]) if hit)
