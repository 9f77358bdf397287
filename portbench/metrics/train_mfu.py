"""The model FLOPs of the train steps done in the window (the plain
reference's forward and the backward the algorithm needs, counted at the
step's shapes), over the window's seconds, as a share of the peak of the
step's compute dtype (989 TFLOP/s bfloat16, 495 float32)."""


def read(run):
    if not run.unit_flops or run.window_s <= 0:
        return None
    return 100.0 * run.unit_flops * run.units / run.window_s / run.peak_flops
