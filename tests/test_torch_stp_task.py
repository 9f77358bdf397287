"""PyTorch port: the STP train and eval steps against ``Wav2Vec2STPTask``.

The tiny wav2vec2 (``TINY_W2V2_CONFIG``, random JAX params, seed 0, loaded
into the port with the converter) with its random parts off (dropouts,
SpecAugment and layerdrop at 0), the feature encoder frozen as the
recipe's, on one batch of the synthetic STP source (B = 2, the 32000-sample
bucket, labels padded to 128).  Both sides take three steps.

The three steps use SGD (lr 1e-3), so a parameter's update is proportional
to its gradient: Adam's first steps move a parameter by about lr whatever
the size of its gradient, and gradients that are float32 noise would move
the two sides apart for no fault of the port (see
``tests/test_torch_eben_task.py``).  The configured Adam (3e-4, betas
(0.5, 0.9)) is held to optax on one step of its own, where the gradient is
above that noise.

Tolerances: the first step's loss 1e-5 relative, the next ones' 1e-4
(measured 1.4e-5 at the second step, from the first update's float32
differences); the parameters after each
step within 1e-2 of the step's update (Frobenius, per tensor); the feature
encoder bit-unchanged on both sides; ``eval_step``'s predictions equal and
its loss within 1e-5 relative; the CER equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vibravox_tpu.core.optim import adam as jax_adam
from vibravox_tpu.data.phonemes import build_phoneme_tokenizer
from vibravox_tpu.models.wav2vec2 import TINY_W2V2_CONFIG, Wav2Vec2Config, Wav2Vec2ForCTC, Wav2Vec2ForCTCModule
from vibravox_tpu.tasks.wav2vec2_stp import Wav2Vec2STPTask as JaxSTPTask
from vibravox_tpu_torch.core.optim import adam, sgd
from vibravox_tpu_torch.data.features import Wav2Vec2FeatureExtractor
from vibravox_tpu_torch.data.phonemes import load_phoneme_tokenizer
from vibravox_tpu_torch.data.stp import STPCollate, SyntheticSTPSource
from vibravox_tpu_torch.models.convert import wav2vec2_state_dict_from_jax
from vibravox_tpu_torch.models.wav2vec2 import wav2vec2_for_ctc_from_config
from vibravox_tpu_torch.tasks.wav2vec2_stp import Wav2Vec2STPTask
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

QUIET = dict(hidden_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0, mask_time_prob=0.0,
             mask_feature_prob=0.0, layerdrop=0.0)


@pytest.fixture(scope="module")
def jax_model():
    cfg = Wav2Vec2Config(**TINY_W2V2_CONFIG, **QUIET)
    module = Wav2Vec2ForCTCModule(cfg)
    params = jax.jit(lambda k: module.init({"params": k}, jnp.zeros((1, 4000)), train=False)["params"])(
        jax.random.key(0))
    return Wav2Vec2ForCTC(cfg, params=jax.device_get(params))


@pytest.fixture(scope="module")
def batch():
    tok = load_phoneme_tokenizer()
    src = SyntheticSTPSource(tok, n_utterances=2, sample_rate=16000, split="stp-train", min_seconds=0.6,
                             max_seconds=1.6)
    return STPCollate(Wav2Vec2FeatureExtractor(), tok, deterministic=True)([src[0], src[1]])


def _port_task(jax_model, optimizer, **kw):
    model = wav2vec2_for_ctc_from_config(preset="tiny", device="cpu", **QUIET)
    model.load_state_dict(wav2vec2_state_dict_from_jax(jax_model.params, jax_model.config), strict=True)
    return Wav2Vec2STPTask(wav2vec2_for_ctc=model, optimizer=optimizer, device="cpu", **kw)


def _arrays(batch):
    return {"audio": jnp.asarray(batch["audio"].numpy()), "phonemes_ids": jnp.asarray(batch["phonemes_ids"].numpy())}


@pytest.fixture(scope="module")
def jax_run(jax_model, batch):
    """The JAX task's three SGD steps: (states as numpy, losses)."""
    task = JaxSTPTask(wav2vec2_for_ctc=jax_model, optimizer=optax.sgd(1e-3))
    arrays = _arrays(batch)
    state = task.init_state(jax.random.key(0), arrays)
    step = jax.jit(task.train_step)
    states, losses = [jax.device_get(state)], []
    for _ in range(3):
        state, logs = step(state, arrays)
        states.append(jax.device_get(state))
        losses.append(float(logs["train/ctc_loss"]))
    return task, states, losses


def test_three_sgd_steps_match_jax(jax_model, jax_run, batch):
    _, states, want_losses = jax_run
    task = _port_task(jax_model, sgd(1e-3))
    state = task.init_state(0)
    cfg = jax_model.config
    encoder0 = {k: v.clone() for k, v in task.wav2vec2_for_ctc.state_dict().items() if "feature_extractor" in k}
    for i in range(3):
        state, logs = task.train_step(state, batch)
        assert state.step == i + 1
        # the first step's loss is of the same parameters; later ones carry
        # the float32 differences of the earlier updates
        np.testing.assert_allclose(float(logs["train/ctc_loss"]), want_losses[i], rtol=1e-5 if i == 0 else 1e-4)
        want = wav2vec2_state_dict_from_jax(states[i + 1].params, cfg)
        prev = wav2vec2_state_dict_from_jax(states[i].params, cfg)
        got = task.wav2vec2_for_ctc.state_dict()
        largest = max(float(torch.linalg.vector_norm(w - prev[k])) for k, w in want.items())
        for k, w in want.items():
            update = float(torch.linalg.vector_norm(w - prev[k]))
            if "attention.k_proj.bias" in k:
                # softmax ignores a shift common to all keys: its gradient
                # is 0, and what either side moves is float32 noise
                moved = float(torch.linalg.vector_norm(got[k] - prev[k]))
                assert max(update, moved) <= 1e-6 * largest, k
                continue
            assert float(torch.linalg.vector_norm(got[k] - w)) <= 1e-2 * update + 1e-7, k
    for k, v in encoder0.items():  # frozen on both sides
        assert torch.equal(task.wav2vec2_for_ctc.state_dict()[k], v), k
        assert torch.equal(wav2vec2_state_dict_from_jax(states[-1].params, cfg)[k], v), k


def test_eval_step_and_cer_match_jax(jax_model, jax_run, batch):
    jtask, states, _ = jax_run
    jtask.tokenizer = build_phoneme_tokenizer()
    want = jax.jit(jtask.eval_step)(states[0], _arrays(batch))
    want_metrics = jtask.eval_metrics({"predictions": want["predictions"],
                                       "host": {"phonemes_str": batch["phonemes_str"]}})

    task = _port_task(jax_model, adam(), tokenizer=load_phoneme_tokenizer())
    out = task.eval_step(task.init_state(0), batch)
    assert torch.equal(out["predictions"], torch.from_numpy(np.asarray(want["predictions"])).long())
    np.testing.assert_allclose(float(out["logs"]["ctc_loss"]), float(want["logs"]["ctc_loss"]), rtol=1e-5)
    metrics = task.eval_metrics({**out, "host": {"phonemes_str": batch["phonemes_str"]}})
    assert metrics == want_metrics and 0 < metrics["char_error_rate"]
    assert task.last_decoded == jtask.last_decoded
    assert task.eval_metrics(out) == {}  # no host fields, no metrics


def test_one_adam_step_matches_optax(jax_model, batch):
    """The configured Adam (3e-4, betas (0.5, 0.9)): the loss (1e-5
    relative), each moment within 5e-4 of its largest entry (measured 2.3e-4,
    the second moment of the feature projection's LayerNorm bias, whose
    gradient is the largest and sums over every frame), and the update
    within 1e-3 of lr on the entries whose first moment is at least 1e-3 of
    the largest; the frozen encoder has no Adam state and does not move.
    The attention's key biases, whose gradient is 0 but for float32 noise,
    are held by their moments only."""
    jtask = JaxSTPTask(wav2vec2_for_ctc=jax_model, optimizer=jax_adam(3e-4, betas=(0.5, 0.9)))
    arrays = _arrays(batch)
    jstate = jtask.init_state(jax.random.key(0), arrays)
    jnew, jlogs = jax.jit(jtask.train_step)(jstate, arrays)
    jnew = jax.device_get(jnew)

    task = _port_task(jax_model, adam(3e-4, betas=(0.5, 0.9)))
    state = task.init_state(0)
    before = {k: p.detach().clone() for k, p in task.wav2vec2_for_ctc.named_parameters()}
    state, logs = task.train_step(state, batch)
    np.testing.assert_allclose(float(logs["train/ctc_loss"]), float(jlogs["train/ctc_loss"]), rtol=1e-5)

    cfg = jax_model.config
    adam_state = jnew.opt_state[0]
    want = {"exp_avg": wav2vec2_state_dict_from_jax(adam_state.mu, cfg),
            "exp_avg_sq": wav2vec2_state_dict_from_jax(adam_state.nu, cfg)}
    after = wav2vec2_state_dict_from_jax(jnew.params, cfg)
    params = dict(task.wav2vec2_for_ctc.named_parameters())
    scale = {k: max(float(v.abs().max()) for v in want[k].values()) for k in want}
    held = 0
    for name, p in params.items():
        st = state.optimizer.state.get(p, {})
        if "feature_extractor" in name or name == "wav2vec2.masked_spec_embed":
            # frozen, or off the path without SpecAugment: no gradient, no
            # Adam state and no move here; zero moments and no move in optax
            assert not st and torch.equal(p.detach(), before[name]), name
            assert float(want["exp_avg"][name].abs().max()) == 0 and torch.equal(after[name], before[name])
            continue
        assert float(st["step"]) == 1, name
        for key in want:
            np.testing.assert_allclose(st[key].numpy(), want[key][name].numpy(), rtol=0,
                                       atol=5e-4 * scale[key], err_msg=f"{name} {key}")
        big = want["exp_avg"][name].abs() >= 1e-3 * scale["exp_avg"]
        if "attention.k_proj.bias" in name:
            assert not big.any(), name
            continue
        held += int(big.sum())
        moved, want_moved = p.detach() - before[name], after[name] - before[name]
        np.testing.assert_allclose(moved[big].numpy(), want_moved[big].numpy(), rtol=0, atol=1e-3 * 3e-4,
                                   err_msg=name)
    assert held > 0


def test_bfloat16_step_is_close_to_float32(jax_model, batch):
    """``compute_dtype="bfloat16"`` (the trainer's bf16-mixed): the loss
    within 2e-2 relative of the float32 step's."""
    losses = []
    for dtype in (None, "bfloat16"):
        task = _port_task(jax_model, sgd(1e-2), compute_dtype=dtype)
        _, logs = task.train_step(task.init_state(0), batch)
        losses.append(float(logs["train/ctc_loss"]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=2e-2)


@pytest.mark.parametrize("kw", [{"accumulate_grad_batches": 2}, {"flatten_optimizer": True}])
def test_task_refuses_what_is_not_ported(jax_model, kw):
    """``accumulate_grad_batches`` is ported (Adam inside ``MultiSteps``);
    ``flatten_optimizer``, an optax knob, is refused."""
    if "accumulate_grad_batches" in kw:
        from vibravox_tpu_torch.core.optim import MultiSteps

        opt = _port_task(jax_model, adam(), **kw).init_state(0).optimizer
        assert isinstance(opt, MultiSteps) and opt.every_k == 2 and isinstance(opt.inner, torch.optim.Adam)
        return
    with pytest.raises(NotImplementedError):
        _port_task(jax_model, adam(), **kw)


def test_checkpoint_state_round_trip(jax_model, batch):
    """``state_dict`` / ``load_state_dict`` carry the model, Adam (its step
    counts back on the CPU), the step and the seed."""
    task = _port_task(jax_model, adam(3e-4, betas=(0.5, 0.9)))
    state = task.init_state(7)
    state, _ = task.train_step(state, batch)
    sd = {k: (v if not isinstance(v, dict) else dataclasses.replace(state).state_dict()[k])
          for k, v in state.state_dict().items()}
    other = _port_task(jax_model, adam(3e-4, betas=(0.5, 0.9)))
    restored = other.init_state(0)
    restored.load_state_dict(sd)
    assert (restored.step, restored.seed) == (1, 7)
    for a, b in zip(restored.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    _, la = task.train_step(state, batch)
    _, lb = other.train_step(restored, batch)
    assert torch.equal(la["train/ctc_loss"], lb["train/ctc_loss"])
