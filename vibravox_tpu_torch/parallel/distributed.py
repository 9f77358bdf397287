"""Multi-process initialisation and the process helpers (PyTorch).

Counterpart of ``vibravox_tpu/parallel/distributed.py``.  The JAX package
reads ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``; the port reads the variables ``torchrun``
(``python -m torch.distributed.run``) exports: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.  Without them a run is
one process and :func:`initialize_distributed` does nothing.

The process group uses NCCL on ``cuda`` and gloo on ``cpu``; a process on
``cuda`` is bound to ``cuda:LOCAL_RANK``.  ``VIBRAVOX_DIST_BACKEND`` picks
another backend (``gloo`` lets several processes share one GPU, which NCCL
refuses).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from vibravox_tpu_torch.device import DeviceLike

__all__ = ["initialize_distributed", "is_initialized", "process_count", "process_index", "local_rank"]


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", process_index()))


def initialize_distributed(
    device: DeviceLike = "cuda",
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join the process group; True when this run has one (also when it was
    joined before), False for a single-process run.

    Without ``init_method`` the topology comes from the ``torchrun``
    variables, and their absence means one process.  With it (a
    ``file://`` or ``tcp://`` rendezvous), ``world_size`` and ``rank`` are
    required.  ``device``: the run's device type; ``cuda`` binds the process
    to ``cuda:LOCAL_RANK`` (``rank`` when ``LOCAL_RANK`` is unset)."""
    if is_initialized():
        return True
    if init_method is None:
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            return False
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        init_method = "env://"
    elif world_size is None or rank is None:
        raise ValueError("an explicit init_method needs world_size and rank")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        index = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(index % max(1, torch.cuda.device_count()))
    backend = backend or os.environ.get("VIBRAVOX_DIST_BACKEND") or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank, **kwargs)
    return True
