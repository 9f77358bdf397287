"""Speaker-verification eval task (inference only), PyTorch.

Counterpart of ``vibravox_tpu/tasks/ecapa2_spkv.py::SPKVTask`` (the
reference's ``ECAPA2LightningModule``, ``lightning_modules/ecapa2.py:22-224``):
the train step does nothing; the test loop embeds both sides of each trial
pair, L2-normalises them, and accumulates the cosine similarity, the
euclidean distance and the same-speaker labels on the host; the epoch's end
gives the EER and its threshold, minDCF and the distance statistics.  Over
a mesh each data rank embeds its own trials and the epoch's end scores the
trials of every rank, gathered.

The embedder is any module ``(B, T) waveform -> (B, D)``: ``ECAPA2`` by
default, ``ECAPATDNN`` through the config.  ``checkpoint_path`` (or
``$VIBRAVOX_ECAPA2_CKPT``) names a torch state dict in the embedder's key
layout (for ECAPA2 the JAX package's converter layout), or a TorchScript
archive of such a module (the published ``ecapa2.pt`` is one), read by
``models/hub.py::load_state_dict`` and loaded strictly;
without one the weights are random from the trainer's seed, made on the
CPU, so a seed gives the same embedder on any device.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vibravox_tpu_torch.device import DeviceLike, resolve_device
from vibravox_tpu_torch.metrics.verification import (
    BinaryScoreAccumulator,
    embedding_distance_stats,
    equal_error_rate,
    minimum_detection_cost,
)
from vibravox_tpu_torch.models.hub import load_state_dict
from vibravox_tpu_torch.parallel.mesh import gather_objects

__all__ = ["SPKVTask", "SPKVState"]


@dataclasses.dataclass
class SPKVState:
    """The embedder (the task's own module) and the step; ``state_dict`` /
    ``load_state_dict`` carry both, for checkpoints."""

    embedder: nn.Module = dataclasses.field(repr=False)
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "embedder": self.embedder.state_dict()}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.embedder.load_state_dict(sd["embedder"], strict=True)
        self.step = int(sd["step"])


def _random_state_dict(module: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """The state of ``module``'s architecture with every layer's parameters
    and buffers reset on the CPU from ``seed``."""
    fresh = copy.deepcopy(module).to("cpu")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(seed))
        for layer in fresh.modules():
            if layer is not fresh and hasattr(layer, "reset_parameters"):
                layer.reset_parameters()
    return fresh.state_dict()


@dataclasses.dataclass
class SPKVTask:
    """``device``: ``None`` for the GPU (raises without one), or ``"cpu"``;
    the embedder moves there."""

    embedder: nn.Module
    sample_rate: int = 16_000
    checkpoint_path: Optional[str] = None
    mindcf_p_target: float = 0.05
    mindcf_c_fa: float = 1.0
    mindcf_c_fr: float = 1.0
    description: Optional[str] = None
    device: DeviceLike = None

    def __post_init__(self):
        if self.sample_rate != 16_000:
            raise ValueError(f"SPKV evaluation runs at 16 kHz, got {self.sample_rate}")
        self.device = resolve_device(self.device)
        self.embedder = self.embedder.to(self.device).eval()
        self._cosine_acc = BinaryScoreAccumulator()
        self._euclid_acc = BinaryScoreAccumulator()

    def init_state(self, seed: int = 0) -> SPKVState:
        """The checkpoint's weights, or random ones from ``seed``."""
        path = self.checkpoint_path or os.environ.get("VIBRAVOX_ECAPA2_CKPT")
        if path:
            sd = load_state_dict(path)
        else:
            sd = _random_state_dict(self.embedder, seed)
        self.embedder.load_state_dict(sd, strict=True)
        return SPKVState(embedder=self.embedder)

    def train_step(self, state: SPKVState, batch) -> Tuple[SPKVState, Dict]:
        return state, {}  # inference only (ref ``ecapa2.py:58-75``)

    @torch.no_grad()
    def eval_step(self, state: SPKVState, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Embed both sides, L2-normalise, score (ref ``ecapa2.py:102-116``)."""
        emb_a = state.embedder(batch["sensor_a_audio"].to(self.device))
        emb_b = state.embedder(batch["sensor_b_audio"].to(self.device))
        emb_a = emb_a / torch.linalg.norm(emb_a, dim=-1, keepdim=True)
        emb_b = emb_b / torch.linalg.norm(emb_b, dim=-1, keepdim=True)
        return {"cosine": (emb_a * emb_b).sum(dim=-1), "euclidean": torch.linalg.norm(emb_a - emb_b, dim=-1),
                "logs": {}}

    def prepare_eval_batch(self, batch: Dict) -> Dict:
        """The paired batch flattened: the two sides' audio and speakers."""
        return {
            "sensor_a_audio": batch["sensor_a"]["audio"],
            "sensor_b_audio": batch["sensor_b"]["audio"],
            "speaker_a": batch["sensor_a"]["speaker_id"],
            "speaker_b": batch["sensor_b"]["speaker_id"],
        }

    def on_eval_batch_end(self, outputs: Dict) -> None:
        """Accumulate the scores and same-speaker labels (ref
        ``on_test_batch_end``, ``ecapa2.py:138-188``)."""
        host = outputs.get("host", {})
        labels = np.asarray([a == b for a, b in zip(host.get("speaker_a", []), host.get("speaker_b", []))],
                            dtype=np.int32)
        self._cosine_acc.update(outputs["cosine"].float().cpu().numpy(), labels)
        self._euclid_acc.update(outputs["euclidean"].float().cpu().numpy(), labels)

    def on_eval_epoch_end(self) -> Dict[str, float]:
        """EER, minDCF and the distance statistics (ref
        ``on_test_epoch_end``, ``ecapa2.py:190-201``); resets the epoch."""
        cosine, labels = self._cosine_acc.compute()
        euclid, _ = self._euclid_acc.compute()
        # over a mesh, every data rank's trials (parallel.mesh.gather_objects)
        parts = gather_objects((cosine, euclid, labels))
        if len(parts) > 1:
            cosine, euclid, labels = (np.concatenate([p[i] for p in parts]) for i in range(3))
        eer = equal_error_rate(cosine, labels)
        dcf = minimum_detection_cost(cosine, labels, self.mindcf_p_target, self.mindcf_c_fa, self.mindcf_c_fr)
        metrics = {
            "equal_error_rate": eer["eer"],
            "eer_threshold": eer["threshold"],
            "minimum_dcf": dcf["min_dcf"],
        }
        metrics.update({f"cosine_{k}": v for k, v in embedding_distance_stats(cosine, labels).items()})
        metrics.update({f"euclidean_{k}": v for k, v in embedding_distance_stats(euclid, labels).items()})
        self._cosine_acc.reset()
        self._euclid_acc.reset()
        return metrics
