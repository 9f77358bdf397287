"""BWE data module: coupled body-conducted / airborne speech (PyTorch loaders).

Counterpart of ``vibravox_tpu/data/bwe.py::BWEDataModule``
(``lightning_datamodules/bwe.py:24-293`` in the reference): one sensor of a
subset, the headset microphone as reference, batched by ``BWECollate``
(constant-length or ``pad``, augmentation in training) through
``torch.utils.data.DataLoader``s, pinned for the GPU.

Sources, for ``dataset_name_principal`` and ``_secondary``: ``synthetic``,
a directory (``<dir>/<split>/*.npz``), or a hub name (``load_hf_vibravox``,
which needs the ``datasets`` package).

* Training: random crops, ``drop_last``, a shuffle keyed to
  ``(seed, epoch)`` as the JAX loader's is (``data/loader.py``), and the
  collate's draws (crops, augmentation) keyed to ``(seed, epoch, batch)``.
  The trainer calls ``set_epoch`` on the loader's batch sampler (or, for a
  stream, its dataset) at each epoch start, so a run resumed at epoch N
  sees what an uninterrupted run sees there, with any ``num_workers``.
* A streaming source (``streaming=True`` with a hub name) has no length:
  its batches come through the JAX loader's shuffle buffer of 256 items,
  in stream order per epoch.  With several workers each reads the whole
  stream's encoded rows (so the stream is read ``num_workers`` times), and
  decodes, resamples and collates only every ``num_workers``-th batch, in
  turn, so the batches are the same with any ``num_workers``.
* Validation and test: centred crops at batch 1, in order (the reference's
  val batch size ``min(1, batch_size // 4)`` is 1, ``bwe.py:177``).  With
  ``dataset_name_secondary`` they are ``{"principal", "secondary"}`` dicts,
  which the trainer logs under a ``/secondary`` suffix.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from vibravox_tpu_torch.data.collate import BWECollate
from vibravox_tpu_torch.data.sources import NpzDirectorySource, SyntheticVibravoxSource, load_hf_vibravox
from vibravox_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["BWEDataModule"]

_SPLITS = {"fit": ("train", "validation"), "validate": ("validation",), "test": ("test",)}
SHUFFLE_BUFFER = 256  # items, as the JAX loader's (vibravox_tpu/data/loader.py)


def resolve_source(name: Optional[str], subset: str, split: str, sensor: str, sample_rate: int,
                   streaming: bool, synthetic_size: int = 16):
    """``synthetic`` (or None), a directory holding ``<split>/*.npz``, or a
    hub dataset name."""
    if name == "synthetic" or name is None:
        return SyntheticVibravoxSource(n_utterances=synthetic_size, sample_rate=sample_rate,
                                       split=f"{subset}-{split}")
    if os.path.isdir(name):
        return NpzDirectorySource(os.path.join(name, split), sample_rate=sample_rate)
    return load_hf_vibravox(name, subset, split, sensor, sample_rate, streaming)


def _has_len(source) -> bool:
    try:
        len(source)
        return True
    except TypeError:
        return False


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


def eval_keys(n: int, batch_size: int = 1) -> List[List[Tuple[int, int, int]]]:
    """The eval loaders' batches, in order: batch b of epoch 0 holds items
    b * batch_size onwards (at batch 1, item i alone as batch i)."""
    return [[(i, 0, b) for i in range(b * batch_size, min((b + 1) * batch_size, n))]
            for b in range(-(-n // batch_size))]


class Keyed(torch.utils.data.Dataset):
    """The source's item and its ``(index, epoch, batch)`` key.  A source
    with ``keyed_item(index, epoch)`` (the noisy pairs) is asked for the
    item of that epoch."""

    def __init__(self, source):
        self.source = source

    def __getitem__(self, key):
        i, epoch, _ = key
        get = getattr(self.source, "keyed_item", None)
        return (get(i, epoch) if get is not None else self.source[i]), key


class KeyedCollate:
    """Collates ``Keyed`` items with ``collate.keyed(items, (epoch, batch),
    indices)``."""

    def __init__(self, collate):
        self.collate = collate

    def __call__(self, pairs):
        _, epoch, b = pairs[0][1]
        return self.collate.keyed([item for item, _ in pairs], (epoch, b), [k[0] for _, k in pairs])


class _StreamBatches(torch.utils.data.IterableDataset):
    """Collated batches of a hub stream, which has no length: its rows pass
    through a shuffle buffer drawn from ``default_rng((seed, epoch))`` (in
    stream order without ``shuffle``), batch b is collated with key
    ``(epoch, b)``, and worker w of n decodes and collates the batches
    b = w mod n.  The rows (``source.rows()``) are buffered encoded, and
    ``source.decode`` runs only on the rows of a worker's own batches."""

    def __init__(self, source, collate, batch_size: int, shuffle: bool, drop_last: bool, seed: int):
        self.source, self.collate, self.batch_size = source, collate, batch_size
        self.shuffle, self.drop_last, self.seed = shuffle, drop_last, seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _row_batches(self) -> Iterator[list]:
        rng = np.random.default_rng((self.seed, self.epoch))
        buffer: list = []
        pending: list = []
        for row in self.source.rows():
            buffer.append(row)
            if len(buffer) >= (SHUFFLE_BUFFER if self.shuffle else self.batch_size):
                pending.append(buffer.pop(int(rng.integers(len(buffer))) if self.shuffle else 0))
            if len(pending) == self.batch_size:
                yield pending
                pending = []
        while buffer:
            pending.append(buffer.pop(int(rng.integers(len(buffer))) if self.shuffle else 0))
            if len(pending) == self.batch_size:
                yield pending
                pending = []
        if pending and not self.drop_last:
            yield pending

    def __iter__(self):
        info = torch.utils.data.get_worker_info()
        worker, workers = (info.id, info.num_workers) if info is not None else (0, 1)
        for b, rows in enumerate(self._row_batches()):
            if b % workers == worker:
                yield self.collate.keyed([self.source.decode(row) for row in rows], (self.epoch, b), None)


def make_loader(source, collate, batch_size: int, train: bool, num_workers: int, seed: int,
                pin: bool) -> torch.utils.data.DataLoader:
    """A map-style source through ``Keyed``: in training the epoch-keyed
    shuffle (``drop_last``) and persistent workers, in evaluation its items
    in order; a source without a length through ``_StreamBatches``.  The
    collate needs ``keyed(items, (epoch, batch), indices)``."""
    if not _has_len(source):
        # the workers take a fresh copy of the stream's epoch at each pass
        return torch.utils.data.DataLoader(
            _StreamBatches(source, collate, batch_size, shuffle=train, drop_last=train, seed=seed),
            batch_size=None, num_workers=num_workers, pin_memory=pin)
    keys = _EpochBatches(len(source), batch_size, seed) if train else eval_keys(len(source), batch_size)
    return torch.utils.data.DataLoader(
        Keyed(source), batch_sampler=keys, num_workers=num_workers,
        persistent_workers=train and num_workers > 0, collate_fn=KeyedCollate(collate),
        pin_memory=pin)


class BWEDataModule:
    """``device``: where the batches go, ``None`` for the GPU (raises
    without one) or ``"cpu"``; it decides whether host batches are pinned.
    ``sensor`` selects the hub's column; ``id`` names the run.  The
    principal source defaults to ``synthetic`` (the config names the hub)."""

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
        self.sample_rate = sample_rate
        self.dataset_name_principal = dataset_name_principal
        self.dataset_name_secondary = dataset_name_secondary
        self.subset = subset
        self.sensor = sensor
        self.id = id
        self.collate_strategy = collate_strategy
        self.streaming = streaming
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.data_augmentation = data_augmentation
        self.synthetic_size = synthetic_size
        self.seed = seed
        self.device = resolve_device(device)
        self._sources: Dict[str, object] = {}

    def setup(self, stage: str = "fit") -> None:
        for split in _SPLITS[stage]:
            names = {"principal": self.dataset_name_principal}
            if self.dataset_name_secondary and split != "train":
                names["secondary"] = self.dataset_name_secondary
            for name, dataset in names.items():
                key = f"{name}/{split}"
                if key not in self._sources:
                    self._sources[key] = resolve_source(
                        dataset, self.subset, split, self.sensor, self.sample_rate, self.streaming,
                        self.synthetic_size)

    def _collate(self, deterministic: bool) -> BWECollate:
        return BWECollate(self.sample_rate, self.collate_strategy, deterministic=deterministic,
                          augmentation=None if deterministic else self.data_augmentation, seed=self.seed)

    def _loader(self, source, collate, batch_size: int, train: bool) -> torch.utils.data.DataLoader:
        return make_loader(source, collate, batch_size, train, self.num_workers, self.seed,
                           pin=self.device.type == "cuda")

    def train_dataloader(self) -> torch.utils.data.DataLoader:
        """Its ``batch_sampler.set_epoch(epoch)`` (a stream's
        ``dataset.set_epoch``) keys the next pass's shuffle and draws to the
        trainer's epoch."""
        return self._loader(self._sources["principal/train"], self._collate(deterministic=False),
                            self.batch_size, train=True)

    def _eval_loaders(self, split: str):
        loaders = {
            name: self._loader(self._sources[f"{name}/{split}"], self._collate(deterministic=True), 1,
                               train=False)
            for name in ("principal", "secondary") if f"{name}/{split}" in self._sources
        }
        return loaders if len(loaders) > 1 else loaders["principal"]

    def val_dataloader(self):
        return self._eval_loaders("validation")

    def test_dataloader(self):
        return self._eval_loaders("test")
