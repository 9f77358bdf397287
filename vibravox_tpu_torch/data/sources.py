"""Deterministic synthetic Vibravox data (host-side numpy).

The port's own copy of ``vibravox_tpu/data/sources.py::SyntheticVibravoxSource``,
the stand-in for the reference CI's miniature ``vibravox-test`` dataset: a
map-style source of utterances, dicts of 1-D float32 numpy arrays, the same
numbers for the same seed, split and index as the JAX package's.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np

__all__ = ["SyntheticVibravoxSource"]


class SyntheticVibravoxSource:
    """Deterministic speech-like synthetic data with coupled sensor pairs.

    The 'airborne' signal is a harmonic-rich amplitude-modulated tone stack
    plus noise; the 'body_conducted' signal is a low-passed, attenuated
    version of the same — reproducing the BWE problem structure (and the
    cross-sensor time alignment that the reference's datamodule tests check
    by cross-correlation).
    """

    def __init__(
        self,
        n_utterances: int = 16,
        sample_rate: int = 16000,
        min_seconds: float = 2.0,
        max_seconds: float = 6.0,
        seed: int = 0,
        split: str = "train",
        with_metadata: bool = False,
    ):
        self.sample_rate = sample_rate
        self.n = n_utterances
        self.min_seconds = min_seconds
        self.max_seconds = max_seconds
        self.with_metadata = with_metadata
        # distinct streams per split so train/val/test differ deterministically
        self.base_seed = seed * 1000 + int(
            hashlib.sha1(split.encode()).hexdigest(), 16
        ) % 997

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.base_seed + idx)
        sr = self.sample_rate
        seconds = rng.uniform(self.min_seconds, self.max_seconds)
        t = np.arange(int(seconds * sr)) / sr
        f0 = rng.uniform(90, 220)
        # voiced harmonic stack with slow AM envelope (speech-ish)
        envelope = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(1.5, 4.0) * t + rng.uniform(0, 6)))
        airborne = np.zeros_like(t)
        for h in range(1, 24):
            if f0 * h > sr / 2 * 0.95:
                break
            airborne += np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6)) / (h**0.8)
        airborne = airborne * envelope + 0.02 * rng.standard_normal(len(t))
        airborne = (airborne / (np.abs(airborne).max() + 1e-9) * 0.5).astype(np.float32)

        # body-conducted: low-pass via FFT mask + slight gain loss + noise
        spec = np.fft.rfft(airborne)
        freqs = np.fft.rfftfreq(len(airborne), 1 / sr)
        cutoff = 700.0
        mask = 1.0 / (1.0 + (freqs / cutoff) ** 4)
        body = np.fft.irfft(spec * mask, n=len(airborne)).astype(np.float32)
        body = body + 0.005 * rng.standard_normal(len(t)).astype(np.float32)

        item = {"audio_airborne": airborne, "audio_body_conducted": body}
        if self.with_metadata:
            item["speaker_id"] = str(idx % 4)
            item["sentence_id"] = int(idx)
            item["gender"] = "male" if (idx % 2) else "female"
        return item
