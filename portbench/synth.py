"""Speech-like coupled-sensor audio, made on the device from a seed.

A frozen, batched copy of the port's synthetic Vibravox source
(``data/sources.py::SyntheticVibravoxSource``): the airborne signal is a
stack of 23 harmonics of f0 ~ U(90, 220) Hz, amplitudes h^-0.8, under a
slow sinusoidal envelope (1.5-4 Hz), plus 2% noise, scaled to a peak of
0.5; the body-conducted signal is the airborne one through a fourth-order
low-pass at 700 Hz (an FFT mask), plus 0.5% noise.  Rows are zero past
their length.  Everything is drawn from one ``torch.Generator`` on the
device, a few large calls per chunk of rows.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

HARMONICS = 23
CHUNK_ROWS = 32


def _chunk(gen: torch.Generator, lengths: torch.Tensor, width: int, sample_rate: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = lengths.device
    b = lengths.shape[0]
    u = torch.rand(b, 3 + HARMONICS, generator=gen, device=dev, dtype=torch.float64)
    f0 = 90.0 + 130.0 * u[:, 0]
    am_rate, am_phase = 1.5 + 2.5 * u[:, 1], 6.0 * u[:, 2]
    phases = 6.0 * u[:, 3:]
    t = torch.arange(width, device=dev, dtype=torch.float64) / sample_rate
    h = torch.arange(1, HARMONICS + 1, device=dev, dtype=torch.float64)
    cycles = torch.remainder(f0[:, None, None] * h[None, :, None] * t[None, None, :], 1.0)
    tones = torch.sin(2 * math.pi * cycles + phases[:, :, None]).float()
    air = torch.einsum("bht,h->bt", tones, (h ** -0.8).float())
    envelope = 0.5 * (1 + torch.sin(2 * math.pi * am_rate[:, None] * t[None, :] + am_phase[:, None])).float()
    noise = torch.randn(2, b, width, generator=gen, device=dev)
    valid = torch.arange(width, device=dev)[None, :] < lengths[:, None]
    air = torch.where(valid, air * envelope + 0.02 * noise[0], 0.0)
    air = 0.5 * air / (air.abs().amax(dim=1, keepdim=True) + 1e-9)
    freqs = torch.fft.rfftfreq(width, 1.0 / sample_rate, device=dev)
    body = torch.fft.irfft(torch.fft.rfft(air) / (1.0 + (freqs / 700.0) ** 4), n=width)
    body = torch.where(valid, body + 0.005 * noise[1], 0.0)
    return air, body


@torch.no_grad()
def speech_pairs(gen: torch.Generator, lengths: Sequence[int], width: int, sample_rate: int, device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(airborne, body_conducted), each (len(lengths), width) float32 on
    ``device``, row i zero from ``lengths[i]`` on."""
    lengths = torch.as_tensor(list(lengths), device=device)
    airs, bodies = [], []
    for start in range(0, lengths.shape[0], CHUNK_ROWS):
        a, b = _chunk(gen, lengths[start:start + CHUNK_ROWS], width, sample_rate)
        airs.append(a)
        bodies.append(b)
    return torch.cat(airs), torch.cat(bodies)


def normalise(audio: torch.Tensor, lengths: Sequence[int]) -> torch.Tensor:
    """Zero mean and unit variance over each row's first ``lengths[i]``
    samples, zero past them (a feature extractor's ``do_normalize``)."""
    lengths = torch.as_tensor(list(lengths), device=audio.device)
    valid = torch.arange(audio.shape[1], device=audio.device)[None, :] < lengths[:, None]
    n = lengths[:, None].float()
    mean = torch.where(valid, audio, 0.0).sum(1, keepdim=True) / n
    var = torch.where(valid, (audio - mean) ** 2, 0.0).sum(1, keepdim=True) / n
    return torch.where(valid, (audio - mean) / torch.sqrt(var + 1e-7), 0.0)
