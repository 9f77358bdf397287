"""BWE data module over the synthetic source (PyTorch ``DataLoader``).

Counterpart of ``vibravox_tpu/data/bwe.py::BWEDataModule`` for the training
loader with ``dataset_name_principal: synthetic``: the port's own
``SyntheticVibravoxSource`` for the ``<subset>-train`` split, batched by
``BWECollate`` (constant-length random crops, no augmentation) through a
``torch.utils.data.DataLoader`` with a seeded shuffle, ``drop_last`` and,
for the GPU, pinned host memory.  The hub and npz sources, the validation
and test loaders and augmentation are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch

from vibravox_tpu_torch.data.collate import BWECollate
from vibravox_tpu_torch.data.sources import SyntheticVibravoxSource
from vibravox_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["BWEDataModule"]


class BWEDataModule:
    """``device``: where the batches go, ``None`` for the GPU (raises
    without one) or ``"cpu"``; it decides whether host batches are pinned."""

    def __init__(
        self,
        sample_rate: int = 16000,
        dataset_name_principal: str = "synthetic",
        subset: str = "speech_clean",
        collate_strategy: str = "constant_length-2500-ms",
        batch_size: int = 32,
        num_workers: int = 4,
        synthetic_size: int = 16,
        seed: int = 42,
        device: DeviceLike = None,
    ):
        if dataset_name_principal not in ("synthetic", None):
            raise NotImplementedError(
                f"the port reads only the synthetic source so far, got {dataset_name_principal!r}"
            )
        self.sample_rate = sample_rate
        self.subset = subset
        self.collate_strategy = collate_strategy
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.synthetic_size = synthetic_size
        self.seed = seed
        self.device = resolve_device(device)
        self._sources: Dict[str, SyntheticVibravoxSource] = {}

    def setup(self, stage: str = "fit") -> None:
        if stage != "fit":
            raise NotImplementedError("the port has only the training loader so far")
        if "principal/train" not in self._sources:
            self._sources["principal/train"] = SyntheticVibravoxSource(
                n_utterances=self.synthetic_size, sample_rate=self.sample_rate,
                split=f"{self.subset}-train",
            )

    def train_dataloader(self) -> torch.utils.data.DataLoader:
        return torch.utils.data.DataLoader(
            self._sources["principal/train"],
            batch_size=self.batch_size,
            shuffle=True,
            drop_last=True,
            generator=torch.Generator().manual_seed(self.seed),
            num_workers=self.num_workers,
            persistent_workers=self.num_workers > 0,
            collate_fn=BWECollate(self.sample_rate, self.collate_strategy, deterministic=False,
                                  seed=self.seed),
            pin_memory=self.device.type == "cuda",
        )
