"""Constant-length batching of coupled BWE utterances (host-side numpy).

Counterpart of ``vibravox_tpu/data/collate.py::BWECollate`` with the
constant-length strategy and without augmentation: ``constant_length-XXXX-ms``
crops every utterance to a fixed length (at a random offset in training,
centred when ``deterministic``) and pads shorter ones symmetrically.  The
``pad`` strategy is not ported yet.  Crop offsets are drawn from a numpy
generator seeded with ``seed``, in sample order, as the JAX package draws
them, so the same items give byte-equal batches.  In a ``DataLoader``
worker the generator is reseeded from ``(seed, the worker's torch seed)``,
so workers do not repeat each other's offsets.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["parse_collate_strategy", "BWECollate"]


def parse_collate_strategy(strategy: str, sample_rate: int) -> int:
    """'constant_length-2500-ms' -> samples."""
    m = re.fullmatch(r"constant_length-(\d+)-ms", strategy)
    if not m:
        raise ValueError(f"Unknown collate strategy: {strategy!r}")
    return int(sample_rate * int(m.group(1)) / 1000)


def _fix_length_at(audio: np.ndarray, desired: int, offset: int, t: int) -> np.ndarray:
    """Crop at ``offset`` or pad symmetrically to ``desired`` samples, as the
    body-conducted signal of length ``t`` is (its pair follows it)."""
    if t >= desired:
        return audio[offset : offset + desired]
    left = (desired - t) // 2
    return np.pad(audio, (left, desired - t - left))


class BWECollate:
    """Collate coupled (body-conducted, airborne) utterances into
    ``{"audio_body_conducted": (B, T, 1), "audio_airborne": (B, T, 1)}``
    float32 CPU tensors."""

    def __init__(
        self,
        sample_rate: int,
        strategy: str = "constant_length-2500-ms",
        deterministic: bool = False,
        seed: int = 0,
    ):
        self.sample_rate = sample_rate
        self.constant_samples = parse_collate_strategy(strategy, sample_rate)
        self.deterministic = deterministic
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._worker_seed: Optional[int] = None

    def _reseed_in_worker(self) -> None:
        info = torch.utils.data.get_worker_info()
        if info is not None and info.seed != self._worker_seed:
            self._worker_seed = info.seed
            self.rng = np.random.default_rng([self.seed, info.seed])

    def __call__(self, samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
        self._reseed_in_worker()
        has_reference = "audio_airborne" in samples[0]
        bodies = [np.asarray(s["audio_body_conducted"], dtype=np.float32).reshape(-1) for s in samples]
        airs = (
            [np.asarray(s["audio_airborne"], dtype=np.float32).reshape(-1) for s in samples]
            if has_reference else None
        )
        target = self.constant_samples
        offsets = [
            (((t - target) // 2) if self.deterministic else int(self.rng.integers(0, t - target + 1)))
            if (t := b.shape[-1]) >= target else 0
            for b in bodies
        ]
        batch = {"audio_body_conducted": np.stack(
            [_fix_length_at(b, target, o, b.shape[-1]) for b, o in zip(bodies, offsets)])}
        if has_reference:
            batch["audio_airborne"] = np.stack(
                [_fix_length_at(a, target, o, b.shape[-1]) for a, b, o in zip(airs, bodies, offsets)])
        return {k: torch.from_numpy(np.ascontiguousarray(v[:, :, None])) for k, v in batch.items()}
