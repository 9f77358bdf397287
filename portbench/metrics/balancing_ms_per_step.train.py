"""Device milliseconds a train step of the kernels launched in EBEN's loss
balancing (the port's span ``eben.generator.balancing``: each atomic loss's
gradient on the generator's last conv, the norms and their EMA), from the
traced steps with the host's activity (``phases.py``)."""

from portbench import phases


def read(run):
    return phases.ms_per_step(run, "balancing")
