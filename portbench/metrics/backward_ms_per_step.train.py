"""Device milliseconds a train step of the kernels launched in the step's
backward phases (the port's spans ``eben.generator.backward`` and
``eben.discriminator.backward``, or ``stp.backward``; EBEN's balancing
passes are not among them), from the traced steps with the host's activity
(``phases.py``)."""

from portbench import phases


def read(run):
    return phases.ms_per_step(run, "backward")
