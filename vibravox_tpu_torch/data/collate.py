"""Batching of coupled BWE utterances, with augmentation (host side).

Counterpart of ``vibravox_tpu/data/collate.py::BWECollate``.  Two strategies,
as the reference's (``bwe.py:232-293``):

* ``constant_length-XXXX-ms`` crops every utterance to a fixed length (at a
  random offset in training, centred when ``deterministic``) and pads
  shorter ones symmetrically;
* ``pad`` pads every utterance symmetrically to the batch's longest,
  rounded up to a multiple of ``pad_multiple``.

The rows are assembled by the native kernel (``native/pipeline.py``), each
utterance written once into its row.  In training an ``augmentation``
(``ops/augment.py::WaveformDataAugmentation``) then runs on the batch, and
a batch whose length it changed (speed perturbation) is cropped back to
the target at one random offset, or padded.

All draws come from one numpy generator in the JAX collate's order: the
crop offsets in sample order, the augmentation's gates and choices, then
the re-crop.  ``__call__`` draws from a generator seeded with ``seed``, so
the same items and seed give the JAX package's batches.  ``keyed`` draws a
batch's from a generator of its own, keyed to ``(seed, epoch, batch)``: the
data module's loaders use it, so a batch depends neither on the worker
process that makes it nor on the batches made before it, and a run resumed
at an epoch sees the batches an uninterrupted run sees there.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from vibravox_tpu_torch.native import pipeline as native

__all__ = ["parse_collate_strategy", "BWECollate"]


def parse_collate_strategy(strategy: str, sample_rate: int) -> Optional[int]:
    """'pad' -> None; 'constant_length-2500-ms' -> samples."""
    if strategy == "pad":
        return None
    m = re.fullmatch(r"constant_length-(\d+)-ms", strategy)
    if not m:
        raise ValueError(f"Unknown collate strategy: {strategy!r}")
    return int(sample_rate * int(m.group(1)) / 1000)


def _fix_length(audio: np.ndarray, desired: int, rng: np.random.Generator, deterministic: bool,
                coupled: Optional[np.ndarray] = None):
    """Crop the trailing axis at one offset (random, or centred when
    ``deterministic``) or pad it symmetrically, ``coupled`` alike."""
    t = audio.shape[-1]
    if t >= desired:
        off = (t - desired) // 2 if deterministic else int(rng.integers(0, t - desired + 1))
        fix = lambda a: a[..., off:off + desired]  # noqa: E731
    else:
        left = desired - t
        pad = [(0, 0)] * (audio.ndim - 1) + [(left // 2, left - left // 2)]
        fix = lambda a: np.pad(a, pad)  # noqa: E731
    return fix(audio), (fix(coupled) if coupled is not None else None)


class BWECollate:
    """Collate coupled (body-conducted, airborne) utterances into
    ``{"audio_body_conducted": (B, T, 1), "audio_airborne": (B, T, 1)}``
    float32 CPU tensors (the airborne key only when the items have it)."""

    def __init__(
        self,
        sample_rate: int,
        strategy: str = "constant_length-2500-ms",
        deterministic: bool = False,
        augmentation=None,
        pad_multiple: int = 1024,
        seed: int = 0,
    ):
        self.sample_rate = sample_rate
        self.constant_samples = parse_collate_strategy(strategy, sample_rate)
        self.deterministic = deterministic
        self.augmentation = augmentation
        self.pad_multiple = pad_multiple
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.mask_rng = np.random.default_rng((seed, 1))

    def keyed(self, samples: Sequence[Dict[str, np.ndarray]], key: Tuple[int, ...],
              indices: Optional[Sequence[int]] = None) -> Dict[str, torch.Tensor]:
        """The batch of ``samples`` with its draws from
        ``default_rng((seed, *key))``, ``key`` being ``(epoch, batch)``; the
        masked block's start from ``default_rng((seed, *key, 1))``.  The
        items' source indices are not used."""
        return self._collate(samples, np.random.default_rng((self.seed, *key)),
                             np.random.default_rng((self.seed, *key, 1)))

    def __call__(self, samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
        return self._collate(samples, self.rng, self.mask_rng)

    def _target_length(self, lengths: Sequence[int]) -> int:
        if self.constant_samples is not None:
            return self.constant_samples
        return -(-max(lengths) // self.pad_multiple) * self.pad_multiple

    def _collate(self, samples, rng: np.random.Generator, mask_rng: np.random.Generator
                 ) -> Dict[str, torch.Tensor]:
        has_reference = "audio_airborne" in samples[0]
        bodies = [np.asarray(s["audio_body_conducted"], dtype=np.float32).reshape(-1) for s in samples]
        airs = (
            [np.asarray(s["audio_airborne"], dtype=np.float32).reshape(-1) for s in samples]
            if has_reference else None
        )
        target = self._target_length([b.shape[-1] for b in bodies])
        offsets = [
            (((t - target) // 2) if self.deterministic else int(rng.integers(0, t - target + 1)))
            if (t := b.shape[-1]) >= target else 0
            for b in bodies
        ]
        body, air = native.collate_pair(bodies, airs, offsets, target)
        if self.augmentation is not None and not self.deterministic:
            w1, w2 = self.augmentation(
                torch.from_numpy(body), torch.from_numpy(air) if has_reference else None,
                rng=rng, mask_rng=mask_rng)
            body, air = w1.numpy(), (w2.numpy() if w2 is not None else None)
            if body.shape[-1] != target:  # speed perturbation changed the length
                body, air = _fix_length(body, target, rng, self.deterministic, air)
        batch = {"audio_body_conducted": body}
        if has_reference:
            batch["audio_airborne"] = air
        return {k: torch.from_numpy(np.ascontiguousarray(v[:, :, None])) for k, v in batch.items()}
