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

``eval_step`` is the JAX ``eval_step`` (the reference's
``common_eval_step``): the generator's float32 forward without gradients,
both networks' atomic losses against the reference, and the outputs that
``eval_metrics`` (``SEMetrics``: SI-SDR and STOI at 16 kHz) reads.  On the
GPU it runs K1 (six calls a forward) and K3 (the STFT loss), no K2 or K4.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from vibravox_tpu_torch.core.optim import materialise, step_counts_to_cpu
from vibravox_tpu_torch.device import DeviceLike, resolve_device, strict_float32
from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
from vibravox_tpu_torch.models.eben_generator import EBENGenerator
from vibravox_tpu_torch.tasks.se_metrics import SEMetrics

__all__ = ["EBENTask", "EBENTrainState"]

Embeddings = List[List[torch.Tensor]]


@dataclasses.dataclass
class EBENTrainState:
    """Everything a step changes: the two networks (the task's own modules),
    their optimizers, the EMA norms, the step and the gate's stream.
    ``state_dict`` / ``load_state_dict`` carry all of it, for checkpoints."""

    generator: nn.Module = dataclasses.field(repr=False)
    discriminator: nn.Module = dataclasses.field(repr=False)
    step: int
    generator_optimizer: torch.optim.Optimizer
    discriminator_optimizer: torch.optim.Optimizer
    atomic_norms_ema: torch.Tensor  # (n_atomic_losses,) float32, on the task's device
    gate: torch.Generator  # CPU stream of the discriminator's Bernoulli gate

    def state_dict(self) -> Dict[str, Any]:
        return {
            "step": self.step,
            "generator": self.generator.state_dict(),
            "discriminator": self.discriminator.state_dict(),
            "generator_optimizer": self.generator_optimizer.state_dict(),
            "discriminator_optimizer": self.discriminator_optimizer.state_dict(),
            "atomic_norms_ema": self.atomic_norms_ema,
            "gate": self.gate.get_state(),
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Loads in place: the networks' parameters keep their identity, so
        the optimizers go on updating them."""
        self.generator.load_state_dict(sd["generator"], strict=True)
        self.discriminator.load_state_dict(sd["discriminator"], strict=True)
        for optimizer, key in ((self.generator_optimizer, "generator_optimizer"),
                               (self.discriminator_optimizer, "discriminator_optimizer")):
            optimizer.load_state_dict(sd[key])
            step_counts_to_cpu(optimizer)
        self.step = int(sd["step"])
        self.atomic_norms_ema = sd["atomic_norms_ema"].to(self.atomic_norms_ema.device, torch.float32)
        self.gate.set_state(sd["gate"].cpu())


def _grad_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm of the gradients (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in params if g is not None]))


@dataclasses.dataclass
class EBENTask:
    """Networks, losses, optimizer factories and the train and eval steps,
    with the constructor surface of the JAX ``EBENTask``.

    ``device``: ``None`` for the GPU (raises without one), or ``"cpu"``; the
    networks are moved there.  ``track_grad_norm=2`` logs each network's
    global gradient norm (``train/*/grad_2.0_norm_total``).  Not ported yet,
    and refused: ``push_to_hub_after_testing`` (it needs the network) and
    ``accumulate_grad_batches`` other than 1."""

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
    description: Optional[str] = None
    push_to_hub_after_testing: bool = False
    hub_repo_id: Optional[str] = None
    accumulate_grad_batches: int = 1
    track_grad_norm: int = -1
    compute_dtype: Optional[str] = None
    device: DeviceLike = None

    def __post_init__(self):
        if self.dynamic_loss_balancing not in (None, "simple", "ema"):
            raise ValueError(f"unknown dynamic_loss_balancing {self.dynamic_loss_balancing!r}")
        if not 0 <= self.update_discriminator_ratio <= 1:
            raise ValueError("update_discriminator_ratio must be in [0, 1]")
        if self.track_grad_norm not in (-1, 2):
            raise ValueError(f"track_grad_norm must be -1 or 2, got {self.track_grad_norm!r}")
        if self.push_to_hub_after_testing:
            raise NotImplementedError("pushing to the hub needs the network and is not ported")
        if self.accumulate_grad_batches != 1:
            raise NotImplementedError(
                "gradient accumulation is not ported yet: accumulate_grad_batches must be 1")
        self.generator_optimizer = materialise(self.generator_optimizer)
        self.discriminator_optimizer = materialise(self.discriminator_optimizer)
        self.device = resolve_device(self.device)
        self.generator.to(self.device)
        self.discriminator.to(self.device)
        self._se_metrics = SEMetrics(self.sample_rate)

    def eval_metrics(self, outputs: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """SE metrics at 16 kHz (ref ``base_se.py:67-106``)."""
        return self._se_metrics(outputs)

    def on_test_end(self, state: EBENTrainState) -> None:
        """The reference exports the generator to the hub here; the port
        refuses ``push_to_hub_after_testing`` at construction, so a test
        pass ends with nothing to export."""

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
            generator=self.generator,
            discriminator=self.discriminator,
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
        if self.track_grad_norm == 2:
            logs["train/generator/grad_2.0_norm_total"] = _grad_norm(
                p.grad for p in gen.parameters())

        # ---- discriminator: Bernoulli-gated hinge step ----
        if self.adversarial_loss_fn is not None:
            gate_open = bool(torch.rand((), generator=state.gate) < self.update_discriminator_ratio)
            track = self.track_grad_norm == 2
            with torch.set_grad_enabled(gate_open or track):
                reference_emb, enhanced_emb = self._discriminator_embeddings(
                    enhanced, reference, decomposed, decomposed_reference)
                real = self.adversarial_loss_fn(reference_emb, 1).float()
                fake = self.adversarial_loss_fn(enhanced_emb, -1).float()
                disc_total = real + fake
            if gate_open:
                state.discriminator_optimizer.zero_grad(set_to_none=True)
                disc_total.backward()
                state.discriminator_optimizer.step()
                grads = [p.grad for p in self.discriminator.parameters()]
            elif track:  # the JAX step logs the norm of the gradient it gated away
                grads = torch.autograd.grad(disc_total, list(self.discriminator.parameters()),
                                            allow_unused=True)
            logs["train/discriminator/real_loss"] = real.detach()
            logs["train/discriminator/fake_loss"] = fake.detach()
            logs["train/discriminator/backprop_loss"] = disc_total.detach()
            if track:
                logs["train/discriminator/grad_2.0_norm_total"] = _grad_norm(grads)

        state.step += 1
        state.atomic_norms_ema = norms_ema
        return state, logs

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def eval_step(self, state: EBENTrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """The generator's float32 forward and both networks' losses on a
        ``(B, T, 1)`` batch.  Returns ``corrupted``, ``enhanced`` and, with
        an ``audio_airborne`` reference, ``reference`` (``(B, T, 1)`` tensors
        on the task's device), and ``logs`` (``generator/*`` and
        ``discriminator/*`` 0-dim tensors, the JAX step's keys)."""
        with strict_float32():
            return self._eval_step(batch)

    def _eval_step(self, batch):
        gen = self.generator
        corrupted = gen.cut_to_valid_length(batch["audio_body_conducted"].to(self.device))
        enhanced, decomposed = gen.tail(*gen.front(corrupted.transpose(1, 2).contiguous()))
        outputs: Dict[str, Any] = {"corrupted": corrupted, "enhanced": enhanced.transpose(1, 2)}
        logs: Dict[str, torch.Tensor] = {}
        if "audio_airborne" in batch:
            reference = gen.cut_to_valid_length(batch["audio_airborne"].to(self.device))
            outputs["reference"] = reference
            reference = reference.transpose(1, 2).contiguous()
            decomposed_reference = gen.pqmf.analysis(reference)
            atomic = self._generator_atomic_losses(enhanced, reference, decomposed, decomposed_reference)
            for k, v in atomic.items():
                logs[f"generator/{k}"] = v
            if self.adversarial_loss_fn is not None:
                reference_emb, enhanced_emb = self._discriminator_embeddings(
                    enhanced, reference, decomposed, decomposed_reference)
                logs["discriminator/real_loss"] = self.adversarial_loss_fn(reference_emb, 1).float()
                logs["discriminator/fake_loss"] = self.adversarial_loss_fn(enhanced_emb, -1).float()
        outputs["logs"] = logs
        return outputs
