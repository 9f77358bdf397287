"""Seconds from the process's start to the first timed step or request:
imports, weights and data made from the seed, the program's build (a
checkout's first run compiles the CUDA kernels) and the warm-up."""


def read(run):
    return run.setup_s
