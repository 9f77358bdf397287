"""Device milliseconds a train step of the kernels launched in the step's
forward phases (the port's spans ``eben.generator.forward`` and
``eben.discriminator.forward``, or ``stp.forward``), from the traced steps
with the host's activity (``phases.py``)."""

from portbench import phases


def read(run):
    return phases.ms_per_step(run, "forward")
