"""Device milliseconds a train step of the kernels that are library
convolutions, forward and backward (cuDNN through F.conv1d and
F.conv_transpose1d), from the traced steps."""


def read(run):
    if run.trace is None or run.trace.units == 0:
        return None
    kinds = run.trace.by_kind_s()
    return 1e3 * (kinds.get("conv forward", 0.0) + kinds.get("conv backward", 0.0)) / run.trace.units
