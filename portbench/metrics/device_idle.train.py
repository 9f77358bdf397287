"""The share of a train step's wall in which no kernel ran: 1 - the union
of the kernels' intervals a traced step / the untraced window's wall a
step (the profiler's own cost stretches a traced step's wall, not its
kernels)."""


def read(run):
    if run.trace is None or run.trace.units == 0 or run.units == 0:
        return None
    return 100.0 * (1.0 - (run.trace.busy_s() / run.trace.units) / (run.window_s / run.units))
