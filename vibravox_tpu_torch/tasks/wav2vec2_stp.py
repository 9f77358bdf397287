"""Speech-to-phoneme task: wav2vec2-CTC fine-tuning (PyTorch), and WavLM-CTC's.

Counterpart of ``vibravox_tpu/tasks/wav2vec2_stp.py::Wav2Vec2STPTask``
(the reference's ``Wav2Vec2ForSTPLightningModule``,
``lightning_modules/wav2vec2_for_stp.py:13-249``): the CTC loss with the pad
token as blank and the ``'mean'`` reduction (each sequence's loss over its
target length, averaged over the batch), one Adam step, and in evaluation
the argmax predictions, greedy-decoded on the host into phoneme strings and
scored by CER (the reference's PER).

The train step's random draws (dropout masks, SpecAugment spans, layerdrop
gates) come from a ``torch.Generator`` on the task's device seeded from
``(seed, step)``, so a resumed fit draws what an uninterrupted one draws.
The step runs cuDNN's float32 convolutions in IEEE float32
(``strict_float32``); ``compute_dtype="bfloat16"`` (the trainer's
``precision="bf16-mixed"``) casts the Linear and conv inputs and weights.
No hand-written kernel lies on this path: the JAX model is XLA
convolutions, dense layers and ``dot_product_attention``, and its CTC an
XLA scan.  The same step trains the port's WavLM (``models/wavlm.py``,
which the JAX package lacks), whose forward opens its own spans inside
``stp.forward``.

``accumulate_grad_batches = k`` steps Adam on the mean of k micro-batch
gradients (``optax.MultiSteps``, ``core/optim.py::MultiSteps``).  Over a
mesh (``parallel/mesh.py``) the gradients are averaged over ``data``
before the step, the random draws are made over the global batch, and
``partition_spec_for_path`` (JAX's hook, ``parallel/tp.py``) splits the
encoder's attention and feed-forward blocks over ``model``; the conv
trunk stays replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vibravox_tpu_torch.core.optim import accumulate, materialise, step_counts_to_cpu
from vibravox_tpu_torch.core.profiler import span
from vibravox_tpu_torch.device import DeviceLike, resolve_device, strict_float32
from vibravox_tpu_torch.models.wav2vec2 import Wav2Vec2ForCTC
from vibravox_tpu_torch.models.wavlm import WavLMForCTC
from vibravox_tpu_torch.ops.ctc import ctc_loss
from vibravox_tpu_torch.parallel.mesh import sync_gradients
from vibravox_tpu_torch.parallel.tp import transformer_tp_spec

__all__ = ["Wav2Vec2STPTask", "STPTrainState", "step_generator"]


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The train step's generator on ``device``, seeded from ``(seed, step)``."""
    key = int(np.random.SeedSequence((int(seed), int(step))).generate_state(1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device).manual_seed(key)


@dataclasses.dataclass
class STPTrainState:
    """The model (the task's own module), its optimizer, the step and the
    seed of the step generators; ``state_dict`` / ``load_state_dict`` carry
    all of it, for checkpoints."""

    model: nn.Module = dataclasses.field(repr=False)
    optimizer: torch.optim.Optimizer
    step: int
    seed: int

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "seed": self.seed, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Loads in place: the parameters keep their identity, so the
        optimizer goes on updating them."""
        self.model.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        step_counts_to_cpu(self.optimizer)
        self.step, self.seed = int(sd["step"]), int(sd["seed"])


@dataclasses.dataclass
class Wav2Vec2STPTask:
    """The constructor surface of the JAX ``Wav2Vec2STPTask``.

    ``wav2vec2_for_ctc``: a ``Wav2Vec2ForCTC`` or a ``WavLMForCTC``
    (``models/wavlm.py``), or a factory of one (a config's
    ``_partial_``); ``optimizer``: a factory over parameters
    (``core/optim.py``); ``tokenizer``: the data module's (``run.main``
    hands it over), used by ``eval_metrics``.  ``device``: ``None`` for the
    GPU (raises without one), or ``"cpu"``.  Refused: ``flatten_optimizer``
    (an optax knob)."""

    wav2vec2_for_ctc: Any
    optimizer: Callable[..., torch.optim.Optimizer]
    sample_rate: int = 16_000
    freeze_feature_encoder: bool = True
    description: Optional[str] = None
    tokenizer: Any = None
    accumulate_grad_batches: int = 1
    flatten_optimizer: bool = False
    compute_dtype: Optional[str] = None
    device: DeviceLike = None

    def __post_init__(self):
        if self.flatten_optimizer:
            raise NotImplementedError("flatten_optimizer is an optax option with no PyTorch counterpart")
        self.device = resolve_device(self.device)
        model = self.wav2vec2_for_ctc
        if not isinstance(model, nn.Module):
            model = model()
        if not isinstance(model, (Wav2Vec2ForCTC, WavLMForCTC)):
            raise TypeError(f"wav2vec2_for_ctc must make a Wav2Vec2ForCTC or a WavLMForCTC, "
                            f"got {type(model).__name__}")
        self.wav2vec2_for_ctc = model.to(self.device)
        self.optimizer = materialise(self.optimizer)
        self.blank_id = int(model.config.pad_token_id)
        self.last_decoded: Optional[Tuple[str, str]] = None

    def init_state(self, seed: int = 0) -> STPTrainState:
        """A fresh optimizer over the model's parameters, step 0."""
        model = self.wav2vec2_for_ctc
        return STPTrainState(model=model, optimizer=accumulate(self.optimizer(model.parameters()),
                                                               self.accumulate_grad_batches),
                             step=0, seed=int(seed))

    partition_spec_for_path = staticmethod(transformer_tp_spec)

    # ------------------------------------------------------------------ #

    def _ctc_loss(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """'mean' CTC: each sequence's loss over its target length (at least
        1), averaged; labels are -100 where padded."""
        label_paddings = (labels == -100).float()
        logit_paddings = torch.zeros(logits.shape[:2], device=logits.device)
        per_example = ctc_loss(logits, logit_paddings, labels, label_paddings, blank_id=self.blank_id)
        target_lengths = torch.clamp((1.0 - label_paddings).sum(-1), min=1.0)
        return (per_example / target_lengths).mean()

    def _forward(self, audio: torch.Tensor, train: bool, generator=None) -> torch.Tensor:
        model = self.wav2vec2_for_ctc
        if model.config.compute_dtype != self.compute_dtype:
            model.config = dataclasses.replace(model.config, compute_dtype=self.compute_dtype)
        return model(audio.to(self.device), train=train, generator=generator,
                     freeze_feature_encoder=self.freeze_feature_encoder)

    def train_step(self, state: STPTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[STPTrainState, Dict[str, torch.Tensor]]:
        """One Adam step on ``{"audio": (B, T), "phonemes_ids": (B, N)}``.
        Updates ``state`` in place and returns it with ``train/ctc_loss``."""
        with span("stp.train_step"), strict_float32():
            with span("stp.forward"):
                generator = step_generator(state.seed, state.step, self.device)
                logits = self._forward(batch["audio"], train=True, generator=generator)
                loss = self._ctc_loss(logits, batch["phonemes_ids"].to(self.device))
                logs = {"train/ctc_loss": loss.detach()}
            with span("stp.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                sync_gradients(list(state.model.parameters()))
            with span("stp.optimizer"):
                state.optimizer.step()
        state.step += 1
        return state, logs

    @torch.no_grad()
    def eval_step(self, state: STPTrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """The argmax ``predictions`` (B, T') and ``logs`` ``{"ctc_loss"}``."""
        with strict_float32():
            logits = self._forward(batch["audio"], train=False)
            loss = self._ctc_loss(logits, batch["phonemes_ids"].to(self.device))
        return {"predictions": logits.argmax(-1), "logs": {"ctc_loss": loss}}

    def eval_metrics(self, outputs: Dict[str, Any]) -> Dict[str, float]:
        """Greedy decode and CER on the host (ref ``common_logging``,
        ``wav2vec2_for_stp.py:176-226``), against ``outputs["host"]``'s
        ``phonemes_str``; keeps the first (prediction, target) pair in
        ``last_decoded`` for the trainer's text log."""
        if self.tokenizer is None or "host" not in outputs:
            return {}
        from vibravox_tpu_torch.metrics.text import char_error_rate

        decoded = self.tokenizer.batch_decode(outputs["predictions"].cpu().numpy())
        targets = list(outputs["host"].get("phonemes_str", []))
        if not targets:
            return {}
        self.last_decoded = (decoded[0], targets[0]) if decoded else None
        return {"char_error_rate": char_error_rate(decoded, targets)}
