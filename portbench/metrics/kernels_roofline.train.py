"""K1-K4's least time at the step's shapes (each call's larger of
operations / peak and bytes / 3.35 TB/s) over their traced device time."""

KERNELS = ("K1 fused_residual", "K2 fused_residual_bwd", "K3 framed_dft_magnitude", "K4 framed_dft_backward")


def read(run):
    if run.trace is None or not all(k in run.bounds_s for k in KERNELS):
        return None
    kinds = run.trace.by_kind_s()
    spent = sum(kinds.get(k, 0.0) for k in KERNELS)
    return 100.0 * sum(run.bounds_s[k] for k in KERNELS) / spent if spent > 0 else None
