"""Faults planted in the port's WavLM (``models/wavlm.py``) under a run,
for the tests and ``tools/wavlm_readings.py``; a benchmark run never plants
one.  Each turns a sound run of the WavLM cell into one whose ``correct``
has to read false:

* ``gate_off``: every layer's gate reads 1, so the bias is P itself;
* ``relpos_off``: the position table P reads 0, so no bias is added;

and ``faults.py``'s ``half_batch`` and ``state_unchanged``, planted through
``faults.planted``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from portbench import faults

FAULTS = ("gate_off", "relpos_off", "half_batch", "state_unchanged")
_planted = faults.planted


def _gate_of_one(x, linear, const, dtype):
    return torch.ones(x.shape[0], const.shape[1], x.shape[1], 1, device=x.device)


def _table_of_zeros(embed, t, num_buckets, max_distance):
    return torch.zeros(embed.weight.shape[1], t, t, device=embed.weight.device)


@contextlib.contextmanager
def planted(fault: str) -> Iterator[None]:
    """The program with ``fault`` planted inside the block."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; there are {FAULTS}")
    if fault not in ("gate_off", "relpos_off"):
        with _planted(fault):
            yield
        return
    from vibravox_tpu_torch.models import wavlm

    name, value = (("relative_position_gate", _gate_of_one) if fault == "gate_off"
                   else ("relative_position_table", _table_of_zeros))
    saved = getattr(wavlm, name)
    setattr(wavlm, name, value)
    try:
        yield
    finally:
        setattr(wavlm, name, saved)
