"""The train steps' phase spans (``core/profiler.py::span``) on the CPU.

Under a ``torch.profiler`` trace each phase of ``EBENTask.train_step`` and
``Wav2Vec2STPTask.train_step`` is one range inside its step's root range,
in the step's order, and every aten operator the step runs lies inside a
phase (a kernel is put down to the phase that launched it, so an operator
outside every phase would leave its kernels unattributed).  Without a
profiler ``span`` is one shared null context, and a traced step computes
what an untraced one does, bit for bit.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vibravox_tpu_torch.core import profiler
from vibravox_tpu_torch.core.optim import adam
from vibravox_tpu_torch.core.profiler import StepTimer, span
from vibravox_tpu_torch.losses.gan import FeatureMatchingLoss, HingeLoss
from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
from vibravox_tpu_torch.models.eben_generator import EBENGenerator
from vibravox_tpu_torch.models.wav2vec2 import wav2vec2_for_ctc_from_config
from vibravox_tpu_torch.ops.stft import MultiResolutionSTFTLoss
from vibravox_tpu_torch.tasks.eben import EBENTask
from vibravox_tpu_torch.tasks.wav2vec2_stp import Wav2Vec2STPTask
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

EBEN_PHASES = ["eben.generator.forward", "eben.generator.balancing", "eben.generator.backward",
               "eben.generator.optimizer", "eben.discriminator.forward", "eben.discriminator.backward",
               "eben.discriminator.optimizer"]
STP_PHASES = ["stp.forward", "stp.backward", "stp.optimizer"]


def _eben(ratio: float = 1.0, track: int = -1):
    torch.manual_seed(0)
    task = EBENTask(
        sample_rate=16000,
        generator=EBENGenerator(m=4, n=32, p=2, device="cpu"),
        discriminator=DiscriminatorEBENMultiScales(q=4, min_channels=8, device="cpu"),
        generator_optimizer=adam(3e-4, betas=(0.5, 0.9)),
        discriminator_optimizer=adam(3e-4, betas=(0.5, 0.9)),
        reconstructive_loss_freq_fn=MultiResolutionSTFTLoss(
            (512,), (50,), (240,), sample_rate=16000, perceptual_weighting=True, device="cpu"),
        feature_matching_loss_fn=FeatureMatchingLoss(), adversarial_loss_fn=HingeLoss(),
        dynamic_loss_balancing="ema", update_discriminator_ratio=ratio, track_grad_norm=track, device="cpu")
    ref = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 4064, 1)).astype(np.float32))
    return task, task.init_state(0), {"audio_body_conducted": ref * 0.05, "audio_airborne": ref * 0.1}


def _stp():
    torch.manual_seed(0)
    model = wav2vec2_for_ctc_from_config(preset="tiny", device="cpu", layerdrop=0.0)
    task = Wav2Vec2STPTask(wav2vec2_for_ctc=model, optimizer=adam(3e-4, betas=(0.5, 0.9)), device="cpu")
    audio = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 8000)).astype(np.float32))
    labels = torch.full((2, 16), -100, dtype=torch.long)
    labels[:, :6] = torch.arange(1, 7)
    return task, task.init_state(0), {"audio": audio * 0.1, "phonemes_ids": labels}


def _traced_step(task, state, batch):
    """(logs, the trace's CPU events: (name, start, end)) of one step."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, logs = task.train_step(state, batch)
    return logs, [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]


def _spans(events, names):
    return sorted((e for e in events if e[0] in names), key=lambda e: e[1])


def _check_phases(events, root, phases):
    (root_span,) = _spans(events, {root})
    spans = _spans(events, set(phases))
    assert [s[0] for s in spans] == phases
    assert all(root_span[1] <= s[1] <= s[2] <= root_span[2] for s in spans)
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))  # one after another
    outside = sorted({e[0] for e in events if e[0].startswith("aten::")
                      and not any(s[1] <= e[1] and e[2] <= s[2] for s in spans)})
    assert outside == []


def test_span_is_one_shared_null_context_without_a_profiler():
    assert span("a") is span("b")
    assert isinstance(span("a"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(span("a"), torch.profiler.record_function)
    assert span("a") is span("b")


@pytest.mark.parametrize("kind", ["eben", "stp"])
def test_each_phase_once_in_order_inside_its_root(kind):
    task, state, batch = _eben() if kind == "eben" else _stp()
    _, events = _traced_step(task, state, batch)
    if kind == "eben":
        _check_phases(events, "eben.train_step", EBEN_PHASES)
    else:
        _check_phases(events, "stp.train_step", STP_PHASES)


@pytest.mark.parametrize("track", [-1, 2])
def test_a_closed_gate_has_no_discriminator_optimizer_span(track):
    """With the gate closed the discriminator's backward runs only to log the
    norm of the gradient it gates away (``track_grad_norm=2``)."""
    task, state, batch = _eben(ratio=0.0, track=track)
    _, events = _traced_step(task, state, batch)
    phases = EBEN_PHASES[:5] + (["eben.discriminator.backward"] if track == 2 else [])
    _check_phases(events, "eben.train_step", phases)
    assert not _spans(events, {"eben.discriminator.optimizer"})


@pytest.mark.parametrize("kind", ["eben", "stp"])
def test_a_traced_step_is_bit_identical_to_an_untraced_one(kind):
    make = _eben if kind == "eben" else _stp
    runs = []
    for traced in (False, True):
        task, state, batch = make()
        if traced:
            logs, _ = _traced_step(task, state, batch)
        else:
            _, logs = task.train_step(state, batch)
        nets = [task.generator, task.discriminator] if kind == "eben" else [state.model]
        runs.append(({k: v.clone() for k, v in logs.items()},
                     [p.detach().clone() for net in nets for p in net.parameters()]))
    (logs_a, params_a), (logs_b, params_b) = runs
    assert list(logs_a) == list(logs_b)
    assert all(torch.equal(logs_a[k], logs_b[k]) for k in logs_a)
    assert len(params_a) == len(params_b) and all(torch.equal(a, b) for a, b in zip(params_a, params_b))


def test_step_timer_times_the_period_from_start_to_start(monkeypatch):
    """A period runs from a step's start to the next step's start, so it
    holds the step's own time wherever its work was enqueued; ``stop``
    closes the last period and the next ``start`` opens a new chain."""
    clock = iter([0.0, 0.010, 0.030, 0.035, 1.0, 1.040, 1.050])
    monkeypatch.setattr(profiler.time, "perf_counter", lambda: next(clock))
    timer = StepTimer(warmup_steps=1)
    for call in ("start", "start", "start", "stop", "start", "start", "stop"):
        getattr(timer, call)()
    # periods 10 (warm-up), 20, 5, 40, 10 ms: 1.0 s between stop and start is in none
    assert timer.summary("t/")["t/step_ms_mean"] == pytest.approx((20 + 5 + 40 + 10) / 4)
    assert timer.summary("t/")["t/step_ms_max"] == pytest.approx(40)
