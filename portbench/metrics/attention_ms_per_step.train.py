"""Device milliseconds a train step of the kernels that ``trace.py`` calls
attention (the library attention's forward and backward, which WavLM calls
with its gated bias), from the traced steps; the profiler's copies of the
port's spans are left out by name (``spans.py``)."""

from portbench import spans


def read(run):
    if run.trace is None or run.trace.units == 0:
        return None
    spent = spans.kind_s(run.trace, "attention")
    return 1e3 * spent / run.trace.units if spent > 0 else None
