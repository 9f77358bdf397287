"""WavLM-Large fine-tuned for CTC: the program's train step and its check
against the plain reference.

The port's ``WavLMForCTC`` (``models/wavlm.py``) trained by
``Wav2Vec2STPTask.train_step`` as wav2vec2_for_stp.yaml trains wav2vec2
(the dropout, SpecAugment and LayerDrop of the yaml; the feature encoder
frozen; Adam as adam.yaml), IEEE float32, checked as ``portbench/session.py``
sets out against ``reference/wavlm.py``, which draws the same masks from
the same (seed, step) generator in the same order.  The weights are those
of ``wav2vec2_base_ctc.py`` (``weights.seeded_params``), but for two leaves
that have a start of their own: ``rel_attn_embed`` N(0, 1) (PyTorch's
``Embedding``) and ``gru_rel_pos_const`` ones (HF's).

The program is imported here, at the top, so that a checkout without
``models/wavlm.py`` fails when the cell is resolved.  ``kernel_bounds_s``
gives the attention's least time a step (``count/attention.py``) under the
kind ``trace.py`` calls its kernels, ``attention``; the path has no
hand-written kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from portbench import session, synth, weights
from portbench.count import attention, flops
from portbench.reference import wavlm as ref
from portbench.reference.common import Precision, ieee_float32
from portbench.traffic import TrainPlan
from vibravox_tpu_torch.core.optim import adam
from vibravox_tpu_torch.models.wavlm import WavLMConfig, WavLMForCTC
from vibravox_tpu_torch.tasks.wav2vec2_stp import Wav2Vec2STPTask


def build_task(cfg: Dict, device) -> Wav2Vec2STPTask:
    fields = {f.name for f in dataclasses.fields(WavLMConfig)}
    with torch.device(device):
        model = WavLMForCTC(WavLMConfig(**{k: v for k, v in cfg["model"].items() if k in fields}))
    opt = cfg["optimizer"]
    return Wav2Vec2STPTask(wav2vec2_for_ctc=model, optimizer=adam(opt["lr"], betas=tuple(opt["betas"])),
                           sample_rate=cfg["sample_rate"], freeze_feature_encoder=cfg["freeze_feature_encoder"],
                           compute_dtype=cfg["train"]["compute_dtype"], device=device)


def seeded(shapes, gen: torch.Generator, device, gain: float) -> Dict[str, torch.Tensor]:
    """``weights.seeded_params``, then the bucket table drawn N(0, 1) from
    the same generator and each gate's constant set to ones."""
    init = weights.seeded_params(shapes, gen, device, gain)
    for name, shape in shapes.items():
        if name.endswith("rel_attn_embed.weight"):
            init[name] = torch.randn(shape, generator=gen, device=device)
        elif name.endswith("gru_rel_pos_const"):
            init[name] = torch.ones(shape, device=device)
    return init


class TrainSession(session.TrainSession):
    def __init__(self, cfg: Dict, plan: TrainPlan, seed: int, device):
        self.cfg, self.plan, self.device, self.seed = cfg, plan, torch.device(device), int(seed)
        self.dtype = torch.float32 if cfg["train"]["compute_dtype"] is None else getattr(torch, cfg["train"]["compute_dtype"])
        self.betas = tuple(cfg["optimizer"]["betas"])
        self.ref_cfg = ref.WavLMRefConfig.of(cfg["model"])
        gen = torch.Generator(self.device).manual_seed(self.seed & (2**63 - 1))
        self.init = seeded(ref.param_shapes(self.ref_cfg), gen, self.device, cfg["init_gain"])
        self.task = build_task(cfg, self.device)
        weights.load_into(self.task.wav2vec2_for_ctc, self.init)
        self.state = self.task.init_state(self.seed)
        phonemes = int(cfg["phoneme_ids"])
        self.batches: List[Dict[str, torch.Tensor]] = []
        self.audio_s: List[float] = []
        for lengths, width, counts, label_width in zip(plan.lengths, plan.widths, plan.label_counts,
                                                       plan.label_width):
            air, _ = synth.speech_pairs(gen, lengths, width, plan.sample_rate, self.device)
            ids = torch.randint(0, phonemes, (len(lengths), label_width), generator=gen, device=self.device)
            pad = torch.arange(label_width, device=self.device)[None, :] >= torch.tensor(counts, device=self.device)[:, None]
            self.batches.append({"audio": synth.normalise(air, lengths), "phonemes_ids": ids.masked_fill(pad, -100)})
            self.audio_s.append(sum(lengths) / plan.sample_rate)

    def leaves(self):
        for name, p in self.task.wav2vec2_for_ctc.named_parameters():
            yield name, p, self.state.optimizer

    def losses(self, logs) -> Dict[str, float]:
        return {"ctc_loss": float(logs["train/ctc_loss"])}

    def step_flops(self) -> float:
        """Model FLOP of a step at the pool's shape (every batch pads to it),
        counted on the meta device: the frozen encoder forward, the rest
        forward and backward."""
        r = ref.WavLMReference(self.ref_cfg, flops.meta_params(ref.param_shapes(self.ref_cfg)), Precision(),
                               3e-4, self.betas, 0)
        audio = torch.empty(self.plan.batch, self.plan.widths[0], device=flops.META)
        labels = torch.zeros(self.plan.batch, self.plan.label_width[0], dtype=torch.long, device=flops.META)
        return flops.counted(lambda: r.gradients(audio, labels, None))

    def kernel_bounds_s(self) -> Dict[str, float]:
        c = self.ref_cfg
        heads, frames = c.num_attention_heads, c.frames(self.plan.widths[0])
        layer = attention.bound_s(self.plan.batch, heads, frames, c.hidden_size // heads, self.dtype)
        return {"attention": c.num_hidden_layers * layer}

    def reference_steps(self, steps: int, prec: Precision):
        r = ref.WavLMReference(self.ref_cfg, {n: t.clone() for n, t in self.init.items()}, prec,
                               self.cfg["optimizer"]["lr"], self.betas, self.seed)
        with ieee_float32():
            logs = [r.train_step(b["audio"], b["phonemes_ids"]) for b in self.batches[:steps]]
        return logs, r.first_grads, r.params


def control_readings(cfg: Dict, plan: TrainPlan, seed: int, device) -> Dict[str, float]:
    """The control for IEEE float32: the reference in the program's place,
    its products in TF32, held to the reference in IEEE float32."""
    s = TrainSession(cfg, plan, seed, device)
    s.free()
    s.logs, s.first_grads, params = s.reference_steps(session.CHECK_STEPS, Precision(tf32=True))
    s.change = s.changes(params)
    del params
    return s.check()
