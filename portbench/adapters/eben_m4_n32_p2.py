"""EBEN (m 4, n 32, p 2) with its multi-scale discriminators: the program's
train step and its check against the plain reference.

``EBENTask.train_step`` of the port, built as eben.yaml states it, checked
as ``portbench/session.py`` sets out; the generator and the discriminator
are compared network by network (``group``).  The reference computes in the
configuration's dtype, its STFT loss in float64.  In bfloat16 a few small
leaves, the discriminators' biases, read a tenth and more on every seed:
their gaps are kept as readings, the median leaf's are compared.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from portbench import session, synth, weights
from portbench.count import bounds, flops
from portbench.reference import eben as ref
from portbench.reference.common import Precision, ieee_float32
from portbench.traffic import TrainPlan

INT8_SWITCH = "VIBRAVOX_INT8_DISC"  # the program's int8 discriminator path


def _dtype(name: Optional[str]) -> torch.dtype:
    return torch.float32 if name in (None, "float32") else getattr(torch, name)


def _resolutions(cfg: Dict):
    loss = cfg["stft_loss"]
    return tuple(zip(loss["fft_sizes"], loss["hop_sizes"], loss["win_lengths"]))


def build_task(cfg: Dict, device, int8_discriminator: bool = False):
    """The program's task as the configuration states it.  ``int8_discriminator``
    switches on the program's own int8 path, the control's."""
    from vibravox_tpu_torch.core.optim import adam
    from vibravox_tpu_torch.losses.gan import FeatureMatchingLoss, HingeLoss
    from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
    from vibravox_tpu_torch.models.eben_generator import EBENGenerator
    from vibravox_tpu_torch.ops.stft import MultiResolutionSTFTLoss
    from vibravox_tpu_torch.tasks.eben import EBENTask

    g, d, loss, opt = cfg["generator"], cfg["discriminator"], cfg["stft_loss"], cfg["optimizer"]
    previous = os.environ.pop(INT8_SWITCH, None)
    if int8_discriminator:
        os.environ[INT8_SWITCH] = "1"
    try:
        with torch.device(device):
            generator = EBENGenerator(g["m"], g["n"], g["p"], device=device)
            discriminator = DiscriminatorEBENMultiScales(d["q"], d["min_channels"], device=device)
    finally:
        os.environ.pop(INT8_SWITCH, None)
        if previous is not None:
            os.environ[INT8_SWITCH] = previous
    optimizer = adam(opt["lr"], betas=tuple(opt["betas"]))
    return EBENTask(
        sample_rate=cfg["sample_rate"], generator=generator, discriminator=discriminator,
        generator_optimizer=optimizer, discriminator_optimizer=optimizer,
        reconstructive_loss_freq_fn=MultiResolutionSTFTLoss(
            loss["fft_sizes"], loss["hop_sizes"], loss["win_lengths"], sample_rate=cfg["sample_rate"],
            perceptual_weighting=loss["perceptual_weighting"], device=device),
        feature_matching_loss_fn=FeatureMatchingLoss(), adversarial_loss_fn=HingeLoss(),
        dynamic_loss_balancing=cfg["dynamic_loss_balancing"], beta_ema=cfg["beta_ema"],
        update_discriminator_ratio=cfg["update_discriminator_ratio"],
        compute_dtype=cfg["train"]["compute_dtype"], device=device)


def seeded_weights(cfg: Dict, gen: torch.Generator, device) -> Dict[str, Dict[str, torch.Tensor]]:
    g, d = cfg["generator"], cfg["discriminator"]
    gain = cfg["init_gain"]
    return {"generator": weights.seeded_params(ref.generator_shapes(g["m"], g["p"]), gen, device, gain),
            "discriminator": weights.seeded_params(ref.discriminator_shapes(d["q"], d["min_channels"]),
                                                   gen, device, gain)}


class TrainSession(session.TrainSession):
    def __init__(self, cfg: Dict, plan: TrainPlan, seed: int, device, int8_discriminator: bool = False):
        self.cfg, self.plan, self.device = cfg, plan, torch.device(device)
        self.dtype = _dtype(cfg["train"]["compute_dtype"])
        self.betas = tuple(cfg["optimizer"]["betas"])
        self.prec = Precision(compute=None if self.dtype == torch.float32 else self.dtype)
        gen = torch.Generator(self.device).manual_seed(int(seed) & (2**63 - 1))
        nets = seeded_weights(cfg, gen, self.device)
        self.init = {f"{net}.{n}": t for net, params in nets.items() for n, t in params.items()}
        self.task = build_task(cfg, self.device, int8_discriminator)
        for net, params in nets.items():
            weights.load_into(getattr(self.task, net), params)
        self.state = self.task.init_state(seed)
        self.batches: List[Dict[str, torch.Tensor]] = []
        self.audio_s: List[float] = []
        for lengths, width in zip(plan.lengths, plan.widths):
            air, body = synth.speech_pairs(gen, lengths, width, plan.sample_rate, self.device)
            self.batches.append({"audio_body_conducted": body[..., None], "audio_airborne": air[..., None]})
            self.audio_s.append(sum(min(n, self.valid(width)) for n in lengths) / plan.sample_rate)

    def valid(self, width: int) -> int:
        """The longest length <= ``width`` that the generator's strides divide."""
        g = self.cfg["generator"]
        return width - (width + g["n"]) % (64 * g["m"])

    def leaves(self):
        for net in ("generator", "discriminator"):
            opt = getattr(self.state, f"{net}_optimizer")
            for name, p in getattr(self.task, net).named_parameters():
                yield f"{net}.{name}", p, opt

    @staticmethod
    def group(leaf: str) -> str:
        return leaf.split(".", 1)[0]

    def losses(self, logs) -> Dict[str, float]:
        return {k.rsplit("/", 1)[1]: float(v) for k, v in logs.items()}

    # ---- the yardstick ----

    def step_flops(self) -> float:
        width = self.valid(self.plan.widths[0])
        return flops.eben_step(self.cfg, self.plan.batch, width, self.dtype)

    def kernel_bounds_s(self) -> Dict[str, float]:
        """Seconds a step at the roofline, per hand-written kernel: K1 and K2
        over the six stacks, K3 on both signals and K4 twice on the enhanced
        one (the balancing's gradient and the backward) per resolution."""
        g = self.cfg["generator"]
        width = self.valid(self.plan.widths[0])
        _, stacks = flops.eben_forward(g["m"], g["n"], g["p"], self.plan.batch, width, self.dtype)
        f32 = torch.float32
        k3 = sum(bounds.bound_s(*bounds.dft_work(self.plan.batch, width, fft, hop, False), f32)
                 for fft, hop, _ in _resolutions(self.cfg))
        k4 = sum(bounds.bound_s(*bounds.dft_work(self.plan.batch, width, fft, hop, True), f32)
                 for fft, hop, _ in _resolutions(self.cfg))
        return {"K1 fused_residual": flops.k_bounds_s(stacks, self.dtype, False),
                "K2 fused_residual_bwd": flops.k_bounds_s(stacks, self.dtype, True),
                "K3 framed_dft_magnitude": 2 * k3, "K4 framed_dft_backward": 2 * k4}

    def reference_steps(self, steps: int, prec: Precision):
        g, d = self.cfg["generator"], self.cfg["discriminator"]
        taps = torch.from_numpy(ref.a_weighting_taps(self.cfg["sample_rate"])).to(self.device)
        own = {net: {n.split(".", 1)[1]: t.clone() for n, t in self.init.items() if self.group(n) == net}
               for net in ("generator", "discriminator")}
        r = ref.EBENReference(
            gen=ref.Generator.make(g["m"], g["n"], g["p"], self.device),
            gen_params=own["generator"], disc_params=own["discriminator"],
            q=d["q"], resolutions=_resolutions(self.cfg), taps=taps, prec=prec,
            lr=self.cfg["optimizer"]["lr"], betas=self.betas, beta_ema=self.cfg["beta_ema"])
        logs = []
        with ieee_float32():
            for b in self.batches[:steps]:
                width = self.valid(b["audio_airborne"].shape[1])
                logs.append(r.train_step(b["audio_body_conducted"][:, :width, 0], b["audio_airborne"][:, :width, 0]))
        params = {**{f"generator.{n}": t for n, t in r.gen_params.items()},
                  **{f"discriminator.{n}": t for n, t in r.disc_params.items()}}
        return logs, r.first_grads, params


def control_readings(cfg: Dict, plan: TrainPlan, seed: int, device) -> Dict[str, float]:
    """The control for bfloat16 training: the program with its own int8
    discriminator path switched on, held to the bfloat16 reference."""
    s = TrainSession(cfg, plan, seed, device, int8_discriminator=True)
    s.start()
    s.free()
    return s.check()
