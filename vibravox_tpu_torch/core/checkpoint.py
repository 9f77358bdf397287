"""Checkpoints with monitor / top-k / save-last semantics (PyTorch).

Counterpart of ``vibravox_tpu/core/checkpoint.py`` (Lightning's
``ModelCheckpoint`` surface, ``configs/callbacks/bwe_checkpoint.yaml``:
monitored metric, mode, ``save_top_k``, ``save_last``), with ``torch.save``
of the train state's ``state_dict()`` in place of orbax.  Directory layout::

    dirpath/
      last/                 # most recent state: state.pt, trainer_state.json
      step_00000123/        # top-k by monitor: state.pt
      index.json            # {step: monitor_value}
      trainer_state.json    # progress of the last save

A save never leaves a torn checkpoint: each is written under a temporary
name and renamed into place.  ``last`` is replaced by two renames (``last``
to ``.last-old``, the new one to ``last``); a run cut between them finds
``.last-old`` and takes it back when the manager is next made.

In a multi-process run every rank calls ``save`` (the state's
``state_dict()`` may gather sharded tensors, a collective), only rank 0
writes, and the ranks meet at a barrier after each save and after the
manager's start-up cleanup; every rank reads a checkpoint to restore.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from vibravox_tpu_torch.device import DeviceLike, resolve_device
from vibravox_tpu_torch.parallel import distributed

__all__ = ["CheckpointManager"]

_STATE = "state.pt"
_PROGRESS = "trainer_state.json"


def _write_json(path: Path, obj: Any) -> None:
    tmp = path.with_name(f".{path.name}.tmp")
    tmp.write_text(json.dumps(obj, indent=1))
    os.replace(tmp, path)


class CheckpointManager:
    """Saves top-k checkpoints by a monitored metric plus an always-fresh
    ``last`` one.  ``save`` takes anything with a ``state_dict()``;
    ``restore`` loads into anything with a ``load_state_dict()``."""

    def __init__(
        self,
        dirpath: str,
        monitor: Optional[str] = None,
        mode: str = "max",
        save_top_k: int = 1,
        save_last: bool = True,
    ):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.dirpath = Path(dirpath)
        self.dirpath.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self._index_path = self.dirpath / "index.json"
        self._index: Dict[str, float] = {}
        if self._index_path.exists():
            self._index = json.loads(self._index_path.read_text())
        self._writer = distributed.process_index() == 0
        if self._writer:
            self._clean()
        _barrier()

    def _clean(self) -> None:
        old = self.dirpath / ".last-old"
        if old.exists():
            if (self.dirpath / "last").exists():
                shutil.rmtree(old)
            else:  # cut between the two renames of a save: the old `last` is whole
                os.rename(old, self.dirpath / "last")
        for tmp in self.dirpath.glob(".*.tmp"):
            shutil.rmtree(tmp) if tmp.is_dir() else tmp.unlink()

    # ------------------------------------------------------------------ #

    def _step_dir(self, step: int) -> Path:
        return self.dirpath / f"step_{step:08d}"

    def _write_dir(self, path: Path, sd: Dict[str, Any], trainer_state: Optional[Dict[str, Any]]) -> Path:
        """The checkpoint under a temporary name beside ``path``; returns it."""
        tmp = path.with_name(f".{path.name}.tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        torch.save(sd, tmp / _STATE)
        if trainer_state is not None:
            (tmp / _PROGRESS).write_text(json.dumps(trainer_state))
        return tmp

    def save(self, state: Any, step: int, metrics: Optional[Dict[str, float]] = None,
             trainer_state: Optional[Dict[str, Any]] = None) -> None:
        """Save ``last`` and, when the monitored metric qualifies, a top-k entry."""
        value = None
        if self.monitor is not None and metrics and self.monitor in metrics:
            value = float(metrics[self.monitor])
            worse = (min if self.mode == "max" else max)(self._index.values(), default=None)
            if not (len(self._index) < self.save_top_k or worse is None or (
                    value > worse if self.mode == "max" else value < worse)):
                value = None
        if not self.save_last and value is None:
            return
        sd = state.state_dict()
        stale = []
        if value is not None:  # every rank keeps the index, so all decide alike
            self._index[str(step)] = value
            ranked = sorted(self._index.items(), key=lambda kv: kv[1], reverse=(self.mode == "max"))
            stale = [int(k) for k, _ in ranked[self.save_top_k:]]
            for k in stale:
                del self._index[str(k)]
        if self._writer:
            self._write(sd, step, value, stale, trainer_state)
        _barrier()

    def _write(self, sd: Dict[str, Any], step: int, value: Optional[float], stale: list,
               trainer_state: Optional[Dict[str, Any]]) -> None:
        if self.save_last:
            last, old = self.dirpath / "last", self.dirpath / ".last-old"
            tmp = self._write_dir(last, sd, trainer_state)
            if last.exists():
                os.rename(last, old)
            os.rename(tmp, last)
            if old.exists():
                shutil.rmtree(old)
            if trainer_state is not None:
                _write_json(self.dirpath / _PROGRESS, trainer_state)

        if value is not None:
            path = self._step_dir(step)
            tmp = self._write_dir(path, sd, None)
            if path.exists():
                shutil.rmtree(path)
            os.rename(tmp, path)
            for stale_step in stale:
                if self._step_dir(stale_step).exists():
                    shutil.rmtree(self._step_dir(stale_step))
            _write_json(self._index_path, self._index)

    # ------------------------------------------------------------------ #

    def restore(self, target: Any, which: str = "last", device: DeviceLike = None) -> Any:
        """Load a checkpoint into ``target`` (in place) and return it.
        ``which``: ``'last'``, ``'best'`` or a step.  ``device``: where the
        tensors are loaded (``map_location``), ``None`` for the GPU (raises
        without one) or ``"cpu"``; the trainer passes the task's device."""
        dev = resolve_device(device)
        if which == "last":
            path = self.dirpath / "last"
        elif which == "best":
            if not self._index:
                raise FileNotFoundError("no best checkpoint recorded")
            path = self._step_dir(self.best_step())
        else:
            path = self._step_dir(int(which))
        if not (path / _STATE).exists():
            raise FileNotFoundError(f"checkpoint not found: {path}")
        target.load_state_dict(torch.load(path / _STATE, map_location=dev, weights_only=True))
        return target

    def best_step(self) -> Optional[int]:
        if not self._index:
            return None
        return int((max if self.mode == "max" else min)(self._index, key=self._index.get))

    def has_last(self) -> bool:
        return (self.dirpath / "last" / _STATE).exists()

    def trainer_state(self) -> Dict[str, Any]:
        """The progress saved with ``last`` (or, without one there, the
        directory's ``trainer_state.json``)."""
        for path in (self.dirpath / "last" / _PROGRESS, self.dirpath / _PROGRESS):
            if path.exists():
                return json.loads(path.read_text())
        return {}


def _barrier() -> None:
    if distributed.is_initialized():
        import torch.distributed as dist

        dist.barrier()
