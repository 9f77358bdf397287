"""Device milliseconds a train step of the kernels launched in the step's
optimizer phases (the port's spans ``eben.generator.optimizer`` and
``eben.discriminator.optimizer``, or ``stp.optimizer``), from the traced
steps with the host's activity (``phases.py``)."""

from portbench import phases


def read(run):
    return phases.ms_per_step(run, "optimizer")
