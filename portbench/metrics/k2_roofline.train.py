"""K2's least time at the step's stack shapes over its traced device time."""

K2 = "K2 fused_residual_bwd"


def read(run):
    if run.trace is None or K2 not in run.bounds_s:
        return None
    spent = run.trace.by_kind_s().get(K2, 0.0)
    return 100.0 * run.bounds_s[K2] / spent if spent > 0 else None
