"""Regressive Mimi BWE: latent-space L1 fine-tuning of the codec's encoder (PyTorch).

Counterpart of ``vibravox_tpu/tasks/regressive_mimi.py`` (the reference's
``RegressiveMimiLightningModule``, ``lightning_modules/regressive_mimi.py:13-97``):
a trainable Mimi codec and a frozen copy of its encoder side, taken when
the state is made.  Only ``encoder``, ``encoder_transformer`` and
``downsample`` train, with Adam over those parameters alone; the decoder,
decoder transformer, upsample and quantizer never change.  The loss is the
L1 between the unquantized latents of the body-conducted audio (trainable
codec) and of the airborne audio (frozen copy).  Evaluation decodes the
body-conducted latents through the RVQ for the SE metrics (resampled to
16 kHz); 24 kHz only; inputs are right-padded to whole 1920-sample frames.

No hand-written kernel lies on this path: the JAX codec is XLA convs,
matmuls and ``dot_product_attention``.  The steps run under
``strict_float32`` (IEEE float32 convs and products on the GPU).

Over a mesh (``parallel/mesh.py``) the gradients are averaged over
``data`` before the step, and ``partition_spec_for_path`` (JAX's hook,
``parallel/tp.py``) splits both bottleneck transformers over ``model``
(the frozen copy too); the SEANet trunks and the quantizer stay
replicated.  Under FSDP2 the frozen copy is whole, taken before the
sharding (``configure_for_mesh``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vibravox_tpu_torch.core.optim import materialise, step_counts_to_cpu
from vibravox_tpu_torch.device import DeviceLike, resolve_device, strict_float32
from vibravox_tpu_torch.models.mimi.mimi import ENCODER_SIDE, MimiModule
from vibravox_tpu_torch.parallel.mesh import sync_gradients
from vibravox_tpu_torch.parallel.tp import transformer_tp_spec
from vibravox_tpu_torch.tasks.se_metrics import SEMetrics

__all__ = ["RegressiveMimiTask", "MimiTrainState"]


@dataclasses.dataclass
class MimiTrainState:
    """The trainable codec (the task's own module), Adam over its encoder
    side, the step, and the frozen copy of the encoder side (an
    ``nn.ModuleDict`` of ``ENCODER_SIDE``); ``state_dict`` /
    ``load_state_dict`` carry all of it, for checkpoints."""

    model: MimiModule = dataclasses.field(repr=False)
    optimizer: torch.optim.Optimizer
    step: int
    frozen: nn.ModuleDict = dataclasses.field(repr=False)

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "frozen": self.frozen.state_dict()}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Loads in place: the parameters keep their identity, so the
        optimizer goes on updating them."""
        self.model.load_state_dict(sd["model"], strict=True)
        self.frozen.load_state_dict(sd["frozen"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        step_counts_to_cpu(self.optimizer)
        self.step = int(sd["step"])


@dataclasses.dataclass
class RegressiveMimiTask:
    """The constructor surface of the JAX ``RegressiveMimiTask``.

    ``mimi``: a ``MimiModule`` (``models/mimi/mimi.py::Mimi``) or a factory
    of one; ``optimizer``: a factory over parameters (``core/optim.py``).
    ``device``: ``None`` for the GPU (raises without one), or ``"cpu"``."""

    mimi: Any
    optimizer: Callable[..., torch.optim.Optimizer]
    sample_rate: int = 24000
    description: Optional[str] = None
    device: DeviceLike = None

    def __post_init__(self):
        if self.sample_rate != 24000:
            raise ValueError(f"RegressiveMimi runs at 24 kHz only (ref regressive_mimi.py:21), got {self.sample_rate}")
        self.device = resolve_device(self.device)
        model = self.mimi if isinstance(self.mimi, nn.Module) else self.mimi()
        if not isinstance(model, MimiModule):
            raise TypeError(f"mimi must make a MimiModule, got {type(model).__name__}")
        self.mimi = model.to(self.device)
        for name, child in model.named_children():
            child.requires_grad_(name in ENCODER_SIDE)
        self.optimizer = materialise(self.optimizer)
        self._se_metrics = SEMetrics(self.sample_rate, device=self.device)
        self._whole_encoder_side: Optional[nn.ModuleDict] = None  # under FSDP (configure_for_mesh)

    def init_state(self, seed: int = 0) -> MimiTrainState:
        """Step 0, a fresh Adam over the encoder side, and the frozen copy of
        the encoder side as it is now.  ``seed`` is unused: the step draws
        nothing at random."""
        del seed
        model = self.mimi
        source = model if self._whole_encoder_side is None else self._whole_encoder_side
        frozen = nn.ModuleDict({name: copy.deepcopy(getattr(source, name)) for name in ENCODER_SIDE})
        frozen.requires_grad_(False)
        params = [p for name in ENCODER_SIDE for p in getattr(model, name).parameters()]
        return MimiTrainState(model=model, optimizer=self.optimizer(params), step=0, frozen=frozen)

    partition_spec_for_path = staticmethod(transformer_tp_spec)

    # the codec's entry points, which gather its parameters under FSDP2
    fsdp_forward_methods = {"mimi": ("encode_to_latent", "decode_latent")}

    def configure_for_mesh(self, mesh) -> None:
        """Under FSDP the encoder side is copied whole now, before FSDP2
        shards it: ``init_state`` takes the frozen copy from there."""
        if mesh.fsdp:
            self._whole_encoder_side = nn.ModuleDict(
                {name: copy.deepcopy(getattr(self.mimi, name)) for name in ENCODER_SIDE}).requires_grad_(False)

    def eval_metrics(self, outputs: Dict[str, Any]) -> Dict[str, float]:
        return self._se_metrics(outputs)

    # ------------------------------------------------------------------ #

    def pad_to_frame(self, audio: torch.Tensor) -> torch.Tensor:
        """Right-pad (B, T, 1) with zeros to a whole number of frames (ref ``91-97``)."""
        t, frame = audio.shape[1], self.mimi.config.hop_length
        return F.pad(audio.to(self.device), (0, 0, 0, -(-t // frame) * frame - t))

    def _target(self, state: MimiTrainState, reference: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return state.model.encode_to_latent(reference, encoder_side=state.frozen)

    def train_step(self, state: MimiTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[MimiTrainState, Dict[str, torch.Tensor]]:
        """One Adam step on ``{"audio_body_conducted", "audio_airborne"}``
        (B, T, 1).  Updates ``state`` in place and returns it with
        ``train/l1_latent_loss``."""
        with strict_float32():
            corrupted = self.pad_to_frame(batch["audio_body_conducted"])
            target = self._target(state, self.pad_to_frame(batch["audio_airborne"]))
            loss = (state.model.encode_to_latent(corrupted) - target).abs().mean()
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            sync_gradients([p for g in state.optimizer.param_groups for p in g["params"]])
            state.optimizer.step()
        state.step += 1
        return state, {"train/l1_latent_loss": loss.detach()}

    @torch.no_grad()
    def eval_step(self, state: MimiTrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """The body-conducted latents decoded through the RVQ (ref ``57-74``):
        ``corrupted``, ``enhanced`` and, with an airborne reference,
        ``reference`` (all padded, (B, T, 1)) and ``logs``
        ``{"l1_latent_loss"}`` against the frozen copy."""
        with strict_float32():
            corrupted = self.pad_to_frame(batch["audio_body_conducted"])
            latent = state.model.encode_to_latent(corrupted)
            outputs: Dict[str, Any] = {"corrupted": corrupted, "enhanced": state.model.decode_latent(latent),
                                       "logs": {}}
            if "audio_airborne" in batch:
                reference = self.pad_to_frame(batch["audio_airborne"])
                outputs["reference"] = reference
                outputs["logs"] = {"l1_latent_loss": (latent - self._target(state, reference)).abs().mean()}
        return outputs
