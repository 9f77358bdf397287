"""The one traffic generator: a mix file's parameters and a seed -> a plan.

A mix is ``portbench/traffic/<name>.json`` with a ``kind``:

* ``train_pool``: a pool of ``pool_batches`` batches of ``batch`` rows,
  cycled by the train window.  Row lengths are uniform in
  [``min_s``, ``max_s``] seconds by a stratified design: each batch takes
  one length from each of ``batch`` equal strata, so every batch has the
  same spread and every seed the same set of lengths, in another order.
  Rows are padded to the batch's longest, then up to a multiple of
  ``bucket_samples`` (0: none).  ``labels_per_s`` > 0 adds that many label
  ids a second of audio, padded with -100 to a multiple of
  ``label_multiple``.

The seed reaches every draw through ``numpy.random.SeedSequence``, so any
whole number up to 2**63 is taken.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class TrainPlan:
    batch: int
    lengths: List[List[int]]  # per batch, per row: samples of audio
    widths: List[int]  # per batch: padded samples
    label_counts: List[List[int]]  # per batch, per row (empty without labels)
    label_width: List[int]
    sample_rate: int


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence((int(seed) & (2**63 - 1), *stream)))


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple if multiple else n


def train_plan(mix: Dict, seed: int, sample_rate: int) -> TrainPlan:
    r = rng(seed, 1)
    b, n = int(mix["batch"]), int(mix["pool_batches"])
    lo, hi = float(mix["min_s"]), float(mix["max_s"])
    # stratum j of each batch: [lo + (hi - lo) j / b, lo + (hi - lo) (j + 1) / b),
    # its n positions (k + 1/2) / n, dealt to the batches in a shuffled order
    lengths = np.empty((n, b), dtype=np.int64)
    for j in range(b):
        pos = (j + (np.arange(n) + 0.5) / n) / b
        lengths[:, j] = np.round((lo + (hi - lo) * r.permutation(pos)) * sample_rate)
    for row in lengths:
        r.shuffle(row)
    bucket = int(mix.get("bucket_samples", 0))
    widths = [_round_up(int(row.max()), bucket) for row in lengths]
    per_s = float(mix.get("labels_per_s", 0))
    counts, label_width = [], []
    for row in lengths:
        c = [max(1, int(round(per_s * v / sample_rate))) for v in row] if per_s > 0 else []
        counts.append(c)
        label_width.append(_round_up(max(c), int(mix.get("label_multiple", 1))) if c else 0)
    return TrainPlan(b, lengths.tolist(), widths, counts, label_width, sample_rate)
