"""Trainer: the explicit training loop (PyTorch).

Counterpart of ``vibravox_tpu/core/loop.py::Trainer.fit``: batches stream
from the data module's loader, each is put on the task's device and goes
through ``task.train_step``; scalar logs are kept every
``log_every_n_steps`` steps, and every epoch logs its wall time and the
seconds of audio it trained on per wall second.  The data-parallel mesh,
checkpoints, the failure guard, preemption, the profiler window and
validation are not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["Trainer"]


def _as_float_logs(logs: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in logs.items()}


class Trainer:
    """``sync_every_step`` waits for the device after every step and records
    the step's wall time in ``step_seconds`` (for measurement; it costs one
    host-device synchronisation per step).  ``data_wait_seconds`` holds, for
    every step, the host's wait for its batch: from the end of the previous
    step (or the epoch's start) until the batch came out of the loader and
    its copy to the device was issued."""

    def __init__(
        self,
        max_epochs: int = 1,
        log_every_n_steps: int = 100,
        limit_train_batches: Optional[int] = None,
        seed: int = 42,
        sync_every_step: bool = False,
    ):
        self.max_epochs = max_epochs
        self.log_every_n_steps = log_every_n_steps
        self.limit_train_batches = limit_train_batches
        self.seed = seed
        self.sync_every_step = sync_every_step
        self.state = None
        self.global_step = 0
        self.current_epoch = 0
        self.logged: List[Tuple[int, Dict[str, float]]] = []
        self.step_seconds: List[float] = []
        self.data_wait_seconds: List[float] = []

    def _sync(self, device: torch.device) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def fit(self, task, datamodule) -> None:
        datamodule.setup("fit")
        loader = datamodule.train_dataloader()
        if self.state is None:
            self.state = task.init_state(self.seed)
        device = task.device
        while self.current_epoch < self.max_epochs:
            epoch_t0 = time.perf_counter()
            audio_seconds = 0.0
            t_wait = epoch_t0
            for i, batch in enumerate(loader):
                if self.limit_train_batches is not None and i >= self.limit_train_batches:
                    break
                batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
                t0 = time.perf_counter()
                self.data_wait_seconds.append(t0 - t_wait)
                self.state, logs = task.train_step(self.state, batch)
                if self.sync_every_step:
                    self._sync(device)
                    self.step_seconds.append(time.perf_counter() - t0)
                x = batch["audio_body_conducted"]
                audio_seconds += x.shape[0] * x.shape[1] / task.sample_rate
                if self.global_step % self.log_every_n_steps == 0:
                    self.logged.append((self.global_step, _as_float_logs(logs)))
                self.global_step += 1
                t_wait = time.perf_counter()
            self._sync(device)
            wall = time.perf_counter() - epoch_t0
            self.logged.append((self.global_step, {
                "train/epoch_wall_seconds": wall,
                "train/audio_seconds_per_second": audio_seconds / max(wall, 1e-9),
            }))
            self.current_epoch += 1
