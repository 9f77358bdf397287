"""The attention's least time over the traced steps (the adapter's
``kernel_bounds_s()["attention"]``: ``count/attention.py``'s operations and
bytes of every layer, forward and backward, at the peak of the step's
dtype and 3.35 TB/s) over the traced device time of the kernels that
``trace.py`` calls attention, span copies left out."""

from portbench import spans


def read(run):
    if run.trace is None or "attention" not in run.bounds_s:
        return None
    spent = spans.kind_s(run.trace, "attention")
    return 100.0 * run.bounds_s["attention"] / spent if spent > 0 else None
