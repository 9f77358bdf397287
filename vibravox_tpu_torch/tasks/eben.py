"""EBEN GAN training task (PyTorch).

Counterpart of ``vibravox_tpu/tasks/eben.py::EBENTask.train_step``, the
reference's Lightning module with manual optimisation
(``vibravox/lightning_modules/eben.py``):

* the generator's atomic losses (multi-resolution STFT, feature matching,
  hinge), balanced by the reference's formulation: per loss,
  ``autograd.grad(L_i, last_conv.weight, retain_graph=True)``, its norm, an
  EMA of the norms (raw norms at step 0, beta otherwise) and
  lambda_i = clip(1 / (norm_ema + 1e-4), 0, 1e4).  The JAX package shares
  one linearisation and takes the norms through the generator tail only; by
  linearity of the vjp that is the same gradient;
* one backward of sum_i lambda_i L_i for the generator, with the
  discriminator's parameters frozen, so it leaves no gradient in them;
* the discriminator's hinge step on the same forward's outputs, detached,
  with the pre-update discriminator, one pass over [reference | enhanced]
  while B <= 64, gated by a Bernoulli draw from an explicit
  ``torch.Generator``: a closed gate leaves the discriminator's parameters
  and its Adam state (step count included) untouched.

Networks run in ``compute_dtype`` (``"bfloat16"`` casts activations and
weights at the call; the parameters stay float32); the losses reduce in
float32 and the whole step keeps cuDNN's float32 convolutions in IEEE
float32 (``strict_float32``), backward included.  On the GPU every fused
residual stack runs K1 forward and K2 backward, every STFT magnitude K3
forward and K4 backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from vibravox_tpu_torch.device import DeviceLike, resolve_device, strict_float32
from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
from vibravox_tpu_torch.models.eben_generator import EBENGenerator

__all__ = ["EBENTask", "EBENTrainState"]

Embeddings = List[List[torch.Tensor]]


@dataclasses.dataclass
class EBENTrainState:
    """What changes from step to step besides the networks' parameters."""

    step: int
    generator_optimizer: torch.optim.Optimizer
    discriminator_optimizer: torch.optim.Optimizer
    atomic_norms_ema: torch.Tensor  # (n_atomic_losses,) float32, on the task's device
    gate: torch.Generator  # CPU stream of the discriminator's Bernoulli gate


@dataclasses.dataclass
class EBENTask:
    """Networks, losses, optimizer factories and the train step, with the
    constructor surface of the JAX ``EBENTask``.

    ``device``: ``None`` for the GPU (raises without one), or ``"cpu"``; the
    networks are moved there."""

    sample_rate: int
    generator: EBENGenerator
    discriminator: DiscriminatorEBENMultiScales
    generator_optimizer: Callable[..., torch.optim.Optimizer]
    discriminator_optimizer: Callable[..., torch.optim.Optimizer]
    reconstructive_loss_freq_fn: Optional[Callable] = None
    reconstructive_loss_time_fn: Optional[Callable] = None
    feature_matching_loss_fn: Optional[Callable] = None
    adversarial_loss_fn: Optional[Callable] = None
    dynamic_loss_balancing: Optional[str] = None  # None | "simple" | "ema"
    beta_ema: float = 0.9
    update_discriminator_ratio: float = 1.0
    compute_dtype: Optional[str] = None
    device: DeviceLike = None

    def __post_init__(self):
        if self.dynamic_loss_balancing not in (None, "simple", "ema"):
            raise ValueError(f"unknown dynamic_loss_balancing {self.dynamic_loss_balancing!r}")
        if not 0 <= self.update_discriminator_ratio <= 1:
            raise ValueError("update_discriminator_ratio must be in [0, 1]")
        self.device = resolve_device(self.device)
        self.generator.to(self.device)
        self.discriminator.to(self.device)

    @property
    def atomic_loss_names(self) -> Tuple[str, ...]:
        names = []
        if self.reconstructive_loss_freq_fn is not None:
            names.append("reconstructive_loss_freq")
        if self.reconstructive_loss_time_fn is not None:
            names.append("reconstructive_loss_temp")
        if self.feature_matching_loss_fn is not None:
            names.append("feature_matching_loss")
        if self.adversarial_loss_fn is not None:
            names.append("adv_loss_gen")
        return tuple(names)

    def init_state(self, seed: int = 0, restored: Optional[Dict[str, Any]] = None) -> EBENTrainState:
        """Fresh optimizers over the networks' parameters, EMA norms at zero
        and step 0; ``restored`` (``models.convert.eben_train_state_from_jax``)
        loads the networks, the step and the EMA norms first."""
        step = 0
        ema = torch.zeros(len(self.atomic_loss_names), dtype=torch.float32)
        if restored is not None:
            self.generator.load_state_dict(restored["generator"], strict=True)
            self.discriminator.load_state_dict(restored["discriminator"], strict=True)
            step = int(restored["step"])
            ema = restored["atomic_norms_ema"].to(torch.float32)
        return EBENTrainState(
            step=step,
            generator_optimizer=self.generator_optimizer(self.generator.parameters()),
            discriminator_optimizer=self.discriminator_optimizer(self.discriminator.parameters()),
            atomic_norms_ema=ema.to(self.device),
            gate=torch.Generator().manual_seed(int(seed)),
        )

    # ------------------------------------------------------------------ #

    def _generator_atomic_losses(
        self, enhanced: torch.Tensor, reference: torch.Tensor,
        decomposed_enhanced: torch.Tensor, decomposed_reference: torch.Tensor,
    ) -> Dict[str, torch.Tensor]:
        """Generator-side atomic losses on NCW signals; the reconstruction
        losses see the JAX package's (B, T, 1) layout."""
        losses: Dict[str, torch.Tensor] = {}
        if self.reconstructive_loss_freq_fn is not None:
            losses["reconstructive_loss_freq"] = self.reconstructive_loss_freq_fn(
                enhanced.transpose(1, 2), reference.transpose(1, 2))
        if self.reconstructive_loss_time_fn is not None:
            losses["reconstructive_loss_temp"] = self.reconstructive_loss_time_fn(
                enhanced.transpose(1, 2), reference.transpose(1, 2))
        if self.feature_matching_loss_fn is not None or self.adversarial_loss_fn is not None:
            enhanced_emb = self.discriminator.embed(decomposed_enhanced, enhanced)
            if self.feature_matching_loss_fn is not None:
                reference_emb = self.discriminator.embed(decomposed_reference, reference)
                losses["feature_matching_loss"] = self.feature_matching_loss_fn(
                    enhanced_emb, reference_emb)
            if self.adversarial_loss_fn is not None:
                losses["adv_loss_gen"] = self.adversarial_loss_fn(enhanced_emb, 1)
        return {k: v.float() for k, v in losses.items()}

    def _discriminator_embeddings(
        self, enhanced: torch.Tensor, reference: torch.Tensor,
        decomposed_enhanced: torch.Tensor, decomposed_reference: torch.Tensor,
    ) -> Tuple[Embeddings, Embeddings]:
        """(reference, enhanced) embeddings on detached generator outputs:
        one pass over both halves while B <= 64, two passes beyond."""
        b = reference.shape[0]
        if b <= 64:
            both = self.discriminator.embed(
                torch.cat([decomposed_reference, decomposed_enhanced.detach()]),
                torch.cat([reference, enhanced.detach()]),
            )
            return ([[e[:b] for e in s] for s in both], [[e[b:] for e in s] for s in both])
        return (self.discriminator.embed(decomposed_reference, reference),
                self.discriminator.embed(decomposed_enhanced.detach(), enhanced.detach()))

    def _balancing(self, state: EBENTrainState, values: List[torch.Tensor]):
        """(lambdas, norm EMA) from each loss's gradient on the last conv."""
        if self.dynamic_loss_balancing is None:
            return torch.ones(len(values), device=self.device), state.atomic_norms_ema
        weight = self.generator.last_conv.weight
        norms = torch.stack([
            torch.linalg.vector_norm(torch.autograd.grad(v, weight, retain_graph=True)[0].float())
            for v in values
        ])
        if self.dynamic_loss_balancing == "ema" and state.step > 0:
            norms = self.beta_ema * state.atomic_norms_ema + (1 - self.beta_ema) * norms
        return torch.clamp(1.0 / (norms + 1e-4), 0.0, 1e4).detach(), norms.detach()

    def train_step(
        self, state: EBENTrainState, batch: Dict[str, torch.Tensor]
    ) -> Tuple[EBENTrainState, Dict[str, torch.Tensor]]:
        """One GAN step on ``{"audio_body_conducted", "audio_airborne"}``
        (B, T, 1) batches: balanced generator update, gated discriminator
        update.  Updates ``state`` in place and returns it with the logs
        (0-dim tensors, the JAX step's keys)."""
        with strict_float32():
            return self._train_step(state, batch)

    def _train_step(self, state, batch):
        gen = self.generator
        corrupted = gen.cut_to_valid_length(batch["audio_body_conducted"].to(self.device))
        reference = gen.cut_to_valid_length(batch["audio_airborne"].to(self.device))
        corrupted = corrupted.transpose(1, 2).contiguous()  # NCW (B, 1, T)
        reference = reference.transpose(1, 2).contiguous()
        if self.compute_dtype is not None:
            dtype = getattr(torch, self.compute_dtype)
            corrupted, reference = corrupted.to(dtype), reference.to(dtype)
        decomposed_reference = gen.pqmf.analysis(reference)
        logs: Dict[str, torch.Tensor] = {}

        # ---- generator: balanced update, discriminator frozen ----
        names = self.atomic_loss_names
        self.discriminator.requires_grad_(False)
        try:
            enhanced, decomposed = gen.tail(*gen.front(corrupted))
            atomic = self._generator_atomic_losses(enhanced, reference, decomposed, decomposed_reference)
            values = [atomic[n] for n in names]
            lambdas, norms_ema = self._balancing(state, values)
            total = sum(lambdas[i] * v for i, v in enumerate(values))
            state.generator_optimizer.zero_grad(set_to_none=True)
            total.backward()
            state.generator_optimizer.step()
        finally:
            self.discriminator.requires_grad_(True)
        for k, v in atomic.items():
            logs[f"train/generator/{k}"] = v.detach()
        logs["train/generator/backprop_loss"] = total.detach()

        # ---- discriminator: Bernoulli-gated hinge step ----
        if self.adversarial_loss_fn is not None:
            gate_open = bool(torch.rand((), generator=state.gate) < self.update_discriminator_ratio)
            with torch.set_grad_enabled(gate_open):
                reference_emb, enhanced_emb = self._discriminator_embeddings(
                    enhanced, reference, decomposed, decomposed_reference)
                real = self.adversarial_loss_fn(reference_emb, 1).float()
                fake = self.adversarial_loss_fn(enhanced_emb, -1).float()
                disc_total = real + fake
            if gate_open:
                state.discriminator_optimizer.zero_grad(set_to_none=True)
                disc_total.backward()
                state.discriminator_optimizer.step()
            logs["train/discriminator/real_loss"] = real.detach()
            logs["train/discriminator/fake_loss"] = fake.detach()
            logs["train/discriminator/backprop_loss"] = disc_total.detach()

        state.step += 1
        state.atomic_norms_ema = norms_ema
        return state, logs
