"""wav2vec2-base fine-tuned for CTC: the program's train step and its check
against the plain reference.

``Wav2Vec2STPTask.train_step`` of the port, built as wav2vec2_for_stp.yaml
states it (the from_pretrained config's dropout, SpecAugment and LayerDrop;
the feature encoder frozen; Adam as adam.yaml), IEEE float32, checked as
``portbench/session.py`` sets out.  Left out of the change by the rule on
the reference's gradient: attention's key biases, which softmax ignores,
and the frozen encoder, which has none.  The reference draws its dropout,
SpecAugment and LayerDrop masks from the same (seed, step) generator in the
same order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from portbench import session, synth, weights
from portbench.count import flops
from portbench.reference import wav2vec2 as ref
from portbench.reference.common import Precision, ieee_float32
from portbench.traffic import TrainPlan


def build_task(cfg: Dict, device):
    from vibravox_tpu_torch.core.optim import adam
    from vibravox_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC
    from vibravox_tpu_torch.tasks.wav2vec2_stp import Wav2Vec2STPTask

    fields = {f.name for f in dataclasses.fields(Wav2Vec2Config)}
    model_cfg = Wav2Vec2Config(**{k: v for k, v in cfg["model"].items() if k in fields})
    with torch.device(device):
        model = Wav2Vec2ForCTC(model_cfg)
    opt = cfg["optimizer"]
    return Wav2Vec2STPTask(wav2vec2_for_ctc=model, optimizer=adam(opt["lr"], betas=tuple(opt["betas"])),
                           sample_rate=cfg["sample_rate"], freeze_feature_encoder=cfg["freeze_feature_encoder"],
                           compute_dtype=cfg["train"]["compute_dtype"], device=device)


class TrainSession(session.TrainSession):
    def __init__(self, cfg: Dict, plan: TrainPlan, seed: int, device):
        self.cfg, self.plan, self.device, self.seed = cfg, plan, torch.device(device), int(seed)
        self.dtype = torch.float32 if cfg["train"]["compute_dtype"] is None else getattr(torch, cfg["train"]["compute_dtype"])
        self.betas = tuple(cfg["optimizer"]["betas"])
        self.ref_cfg = ref.W2V2Config.of(cfg["model"])
        gen = torch.Generator(self.device).manual_seed(self.seed & (2**63 - 1))
        self.init = weights.seeded_params(ref.param_shapes(self.ref_cfg), gen, self.device, cfg["init_gain"])
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
        return flops.w2v2_step(self.cfg["model"], self.plan.batch, self.plan.widths[0], self.plan.label_width[0])

    def kernel_bounds_s(self) -> Dict[str, float]:
        return {}  # no hand-written kernel on this path

    def reference_steps(self, steps: int, prec: Precision):
        r = ref.W2V2Reference(self.ref_cfg, {n: t.clone() for n, t in self.init.items()}, prec,
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
