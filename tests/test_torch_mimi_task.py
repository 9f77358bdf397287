"""PyTorch port: the regressive-Mimi train and eval steps against ``RegressiveMimiTask``.

The tiny codec (JAX's random params, seed 0, loaded into the port with
``mimi_state_dict_from_jax``), the configured Adam (lr 3e-4, betas
(0.5, 0.9)) fresh on both sides, on one batch of synthetic BWE speech at
24 kHz whose length is no whole number of frames.  Both sides take three
steps.

Tolerances: each step's loss 1e-5 relative; after each step the encoder
side's parameters within 1e-2 of the step's update (Frobenius, per
tensor); the decoder, decoder transformer, upsample, quantizer and the
frozen copy bit-unchanged on the port's side; the eval step's enhanced
audio 1e-4 of scale and its ``l1_latent_loss`` 1e-5 relative; the SE
metrics of its outputs equal to the JAX ``SEMetrics`` of JAX's (SI-SDR
1e-3 dB, STOI 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibravox_tpu.core.config import compose as jax_compose
from vibravox_tpu.core.optim import adam as jax_adam
from vibravox_tpu.models.mimi.mimi import Mimi as JaxMimi
from vibravox_tpu.models.mimi.mimi import MimiModule, _tiny_config
from vibravox_tpu.tasks.regressive_mimi import RegressiveMimiTask as JaxTask
from vibravox_tpu.tasks.se_metrics import SEMetrics as JaxSEMetrics
from vibravox_tpu_torch.core.config import compose
from vibravox_tpu_torch.core.optim import adam
from vibravox_tpu_torch.data.sources import SyntheticVibravoxSource
from vibravox_tpu_torch.models.mimi.convert import mimi_state_dict_from_jax
from vibravox_tpu_torch.models.mimi.mimi import ENCODER_SIDE, Mimi
from vibravox_tpu_torch.run import CONFIG_DIR
from vibravox_tpu_torch.tasks.regressive_mimi import RegressiveMimiTask
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

T_TRAIN = 8 * 16 + 5  # no whole number of the tiny codec's 16-sample frames


def _batch(t, n=2):
    source = SyntheticVibravoxSource(n_utterances=n, sample_rate=24000, split="speech_clean-train")
    items = [source[i] for i in range(n)]
    return {k: np.stack([it[k][1000:1000 + t] for it in items]).astype(np.float32)[:, :, None]
            for k in ("audio_body_conducted", "audio_airborne")}


@pytest.fixture(scope="module")
def jax_task():
    cfg = _tiny_config()
    params = jax.jit(MimiModule(cfg).init)(jax.random.key(0), jnp.zeros((1, 4 * cfg.hop_length, 1)))
    return JaxTask(mimi=JaxMimi(config=cfg, params=jax.device_get(params)),
                   optimizer=jax_adam(3e-4, betas=(0.5, 0.9)))


@pytest.fixture()
def pair(jax_task):
    """The JAX task and a port task (a fresh model) with the same params."""
    model = Mimi(preset="tiny", device="cpu")
    model.load_state_dict(mimi_state_dict_from_jax(jax_task.mimi.params, model.config), strict=True)
    return jax_task, RegressiveMimiTask(mimi=model, optimizer=adam(3e-4, betas=(0.5, 0.9)), device="cpu")


def _port_view(jax_params, config):
    return {k: v.numpy() for k, v in mimi_state_dict_from_jax(jax.device_get(jax_params), config).items()}


def test_three_train_steps_match_jax(pair):
    jax_task, task = pair
    batch = _batch(T_TRAIN)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jstate = jax_task.init_state(jax.random.key(0), jbatch)
    jstep = jax.jit(jax_task.train_step)
    state = task.init_state(0)
    config = task.mimi.config
    before = {k: v.clone() for k, v in task.mimi.state_dict().items()}
    frozen_before = {k: v.clone() for k, v in state.frozen.state_dict().items()}
    prev = {k: v.numpy().copy() for k, v in before.items()}
    for step in range(3):
        jstate, jlogs = jstep(jstate, jbatch)
        state, logs = task.train_step(state, tbatch)
        want, got = float(jlogs["train/l1_latent_loss"]), float(logs["train/l1_latent_loss"])
        assert abs(got - want) <= 1e-5 * abs(want), (step, got, want)
        ref = _port_view(jstate.params, config)
        ours = {k: v.detach().numpy() for k, v in task.mimi.state_dict().items()}
        for k in ENCODER_SIDE:
            for name in (n for n in ours if n.startswith(k + ".")):
                update = np.linalg.norm(ref[name] - prev[name])
                assert np.linalg.norm(ours[name] - ref[name]) <= 1e-2 * update + 1e-9, (step, name)
        prev = ref
    assert state.step == 3
    after = task.mimi.state_dict()
    for k, v in before.items():
        if k.split(".")[0] in ENCODER_SIDE:
            continue
        assert torch.equal(after[k], v), k  # decoder side and quantizer frozen
    assert any(not torch.equal(after[k], v) for k, v in before.items() if k.startswith("encoder."))
    assert all(torch.equal(state.frozen.state_dict()[k], v) for k, v in frozen_before.items())
    # the frozen copy is the encoder side as it was when the state was made
    assert all(torch.equal(v, before[k]) for k, v in frozen_before.items())


def test_eval_step_and_metrics_match_jax(pair):
    jax_task, task = pair
    batch = _batch(24000 + 7, n=1)  # 1 s, long enough for STOI
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = jax_task.init_state(jax.random.key(0), jbatch)
    jout = jax.jit(jax_task.eval_step)(jstate, jbatch)
    state = task.init_state(0)
    out = task.eval_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(out) == {"corrupted", "enhanced", "reference", "logs"}
    padded = task.mimi.valid_length(24000 + 7)
    for key in ("corrupted", "reference"):
        assert out[key].shape == (1, padded, 1) and np.array_equal(out[key].numpy(), np.asarray(jout[key]))
    ref = np.asarray(jout["enhanced"])
    assert out["enhanced"].shape == ref.shape == (1, padded, 1)
    assert float(np.abs(out["enhanced"].numpy() - ref).max() / np.abs(ref).max()) <= 1e-4
    want = float(jout["logs"]["l1_latent_loss"])
    assert abs(float(out["logs"]["l1_latent_loss"]) - want) <= 1e-5 * want
    metrics = task.eval_metrics(out)
    jmetrics = JaxSEMetrics(24000)({k: jout[k] for k in ("enhanced", "reference")})
    assert set(metrics) == {"torchmetrics_si_sdr", "torchmetrics_stoi"} <= set(jmetrics)
    assert abs(metrics["torchmetrics_si_sdr"] - float(jmetrics["torchmetrics_si_sdr"])) <= 1e-3
    assert abs(metrics["torchmetrics_stoi"] - float(jmetrics["torchmetrics_stoi"])) <= 1e-4
    no_ref = task.eval_step(state, {"audio_body_conducted": torch.from_numpy(batch["audio_body_conducted"])})
    assert "reference" not in no_ref and no_ref["logs"] == {}


def test_pad_to_frame_matches_jax(pair):
    jax_task, task = pair
    audio = np.random.default_rng(3).standard_normal((2, 37, 1)).astype(np.float32)
    ours = task.pad_to_frame(torch.from_numpy(audio)).numpy()
    assert ours.shape == (2, 48, 1)
    np.testing.assert_array_equal(ours, np.asarray(jax_task.pad_to_frame(jnp.asarray(audio))))
    assert task.pad_to_frame(torch.zeros(1, 32, 1)).shape == (1, 32, 1)
    with pytest.raises(ValueError, match="24 kHz"):
        RegressiveMimiTask(mimi=task.mimi, optimizer=adam(), sample_rate=16000, device="cpu")


@pytest.mark.parametrize("override,augmentation_rate", [("lightning_datamodule.sample_rate=24000", 16000),
                                                        ("sample_rate=24000", 24000)])
def test_sample_rate_overrides_compose_as_jax(override, augmentation_rate):
    """The published run's ``lightning_datamodule.sample_rate=24000`` leaves
    the augmentation at the top-level 16 kHz; ``sample_rate=24000`` sets
    both.  The port composes as the JAX package does."""
    overrides = ["lightning_datamodule=bwe", "lightning_module=regressive_mimi", override]
    ours, want = compose(CONFIG_DIR, "run", overrides), jax_compose(CONFIG_DIR, "run", overrides)
    for cfg in (ours, want):
        dm = cfg.lightning_datamodule
        assert (dm.sample_rate, dm.data_augmentation.sample_rate, cfg.lightning_module.sample_rate) == (
            24000, augmentation_rate, 24000)
    assert ours.lightning_module.mimi == want.lightning_module.mimi
