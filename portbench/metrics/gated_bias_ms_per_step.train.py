"""Device milliseconds a train step of the kernels launched under WavLM's
spans ``wavlm.relpos`` (layer 0's bucket table and lookup) and
``wavlm.gate`` (each layer's gate and gated bias), put down to a span by
their launch as ``phases.py`` does, from the traced steps with the host's
activity.  This is the forward's part: the gated bias's backward runs in
the autograd engine under ``stp.backward`` and is in
``backward_ms_per_step.train``, not split off, since a span inside autograd
would need hooks."""

from portbench import spans


def read(run):
    trace = run.host_trace
    if trace is None or not trace.units:
        return None
    spent = spans.launched_s(trace, spans.GATED_BIAS)
    return None if spent is None else 1e3 * spent / trace.units
