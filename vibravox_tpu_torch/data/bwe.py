"""BWE data module over the synthetic source (PyTorch ``DataLoader``).

Counterpart of ``vibravox_tpu/data/bwe.py::BWEDataModule`` with
``dataset_name_principal: synthetic``: the port's own
``SyntheticVibravoxSource`` for the ``<subset>-<split>`` splits, batched by
``BWECollate`` (constant-length crops, no augmentation) through
``torch.utils.data.DataLoader``s, pinned for the GPU.

* Training: random crops, ``drop_last``, a shuffle keyed to
  ``(seed, epoch)`` as the JAX loader's is (``data/loader.py``), and crops
  keyed to ``(seed, epoch, batch)``.  The trainer calls the loader's
  ``batch_sampler.set_epoch`` at each epoch start, so a run resumed at
  epoch N sees what an uninterrupted run sees there, with any
  ``num_workers``.
* Validation and test: centred crops at batch 1, in order (the reference's
  val batch size ``min(1, batch_size // 4)`` is 1, ``bwe.py:177``).  With
  ``dataset_name_secondary`` they are ``{"principal", "secondary"}`` dicts,
  which the trainer logs under a ``/secondary`` suffix.

The hub and npz sources, streaming and augmentation are not ported yet and
raise.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from vibravox_tpu_torch.data.collate import BWECollate
from vibravox_tpu_torch.data.sources import SyntheticVibravoxSource
from vibravox_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["BWEDataModule"]

_SPLITS = {"fit": ("train", "validation"), "validate": ("validation",), "test": ("test",)}


def _check_source(name: Optional[str]) -> None:
    if name not in ("synthetic", None):
        raise NotImplementedError(
            f"the port reads only the synthetic source so far, got {name!r} "
            "(the hub and npz sources are ROADMAP Queue 1 item 5)")


class _EpochBatches(torch.utils.data.Sampler):
    """Batches of ``(index, epoch, batch)`` keys: the order is a pure
    function of ``(seed, epoch)``, and a pass takes the epoch that
    ``set_epoch`` last set (0 before the first call)."""

    def __init__(self, n: int, batch_size: int, seed: int):
        self.n, self.batch_size, self.seed = n, batch_size, seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return self.n // self.batch_size

    def __iter__(self) -> Iterator[List[Tuple[int, int, int]]]:
        idx = np.arange(self.n)
        np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        for b in range(len(self)):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield [(int(i), self.epoch, b) for i in chunk]


class _Keyed(torch.utils.data.Dataset):
    """The source's item and its batch key, for a ``(index, epoch, batch)`` key."""

    def __init__(self, source):
        self.source = source

    def __getitem__(self, key):
        i, epoch, b = key
        return self.source[i], (epoch, b)


class _KeyedCollate:
    def __init__(self, collate: BWECollate):
        self.collate = collate

    def __call__(self, pairs):
        return self.collate.keyed([item for item, _ in pairs], pairs[0][1])


class BWEDataModule:
    """``device``: where the batches go, ``None`` for the GPU (raises
    without one) or ``"cpu"``; it decides whether host batches are pinned.
    ``sensor`` and ``id`` name the run (the synthetic source has one sensor
    pair); ``streaming`` must be False and ``data_augmentation`` None."""

    def __init__(
        self,
        sample_rate: int = 16000,
        dataset_name_principal: str = "synthetic",
        dataset_name_secondary: Optional[str] = None,
        subset: str = "speech_clean",
        sensor: str = "rigid_in_ear_microphone",
        collate_strategy: str = "constant_length-2500-ms",
        streaming: bool = False,
        batch_size: int = 32,
        num_workers: int = 4,
        data_augmentation=None,
        synthetic_size: int = 16,
        seed: int = 42,
        id: Optional[str] = None,
        device: DeviceLike = None,
    ):
        _check_source(dataset_name_principal)
        if dataset_name_secondary is not None:
            _check_source(dataset_name_secondary)
        if streaming:
            raise NotImplementedError("streaming sources are not ported yet (ROADMAP Queue 1 item 5)")
        if data_augmentation is not None:
            raise NotImplementedError(
                "data augmentation is not ported yet (ROADMAP Queue 1 item 5); remove it with "
                "~lightning_datamodule.data_augmentation")
        self.sample_rate = sample_rate
        self.dataset_name_secondary = dataset_name_secondary
        self.subset = subset
        self.sensor = sensor
        self.id = id
        self.collate_strategy = collate_strategy
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.synthetic_size = synthetic_size
        self.seed = seed
        self.device = resolve_device(device)
        self._sources: Dict[str, SyntheticVibravoxSource] = {}

    def setup(self, stage: str = "fit") -> None:
        for split in _SPLITS[stage]:
            names = ["principal"]
            if self.dataset_name_secondary and split != "train":
                names.append("secondary")
            for name in names:
                self._sources.setdefault(f"{name}/{split}", SyntheticVibravoxSource(
                    n_utterances=self.synthetic_size, sample_rate=self.sample_rate,
                    split=f"{self.subset}-{split}"))

    def _collate(self, deterministic: bool) -> BWECollate:
        return BWECollate(self.sample_rate, self.collate_strategy, deterministic=deterministic,
                          seed=self.seed)

    def train_dataloader(self) -> torch.utils.data.DataLoader:
        """Its ``batch_sampler.set_epoch(epoch)`` keys the next pass's
        shuffle and crops to the trainer's epoch."""
        source = self._sources["principal/train"]
        return torch.utils.data.DataLoader(
            _Keyed(source),
            batch_sampler=_EpochBatches(len(source), self.batch_size, self.seed),
            num_workers=self.num_workers,
            persistent_workers=self.num_workers > 0,
            collate_fn=_KeyedCollate(self._collate(deterministic=False)),
            pin_memory=self.device.type == "cuda",
        )

    def _eval_loaders(self, split: str):
        loaders = {
            name: torch.utils.data.DataLoader(
                self._sources[f"{name}/{split}"], batch_size=1, shuffle=False,
                num_workers=self.num_workers, collate_fn=self._collate(deterministic=True),
                pin_memory=self.device.type == "cuda")
            for name in ("principal", "secondary") if f"{name}/{split}" in self._sources
        }
        return loaders if len(loaders) > 1 else loaders["principal"]

    def val_dataloader(self):
        return self._eval_loaders("validation")

    def test_dataloader(self):
        return self._eval_loaders("test")
