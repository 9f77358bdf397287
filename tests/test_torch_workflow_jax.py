"""PyTorch port: the BWE/EBEN eval path, its metrics and the CLI's config
against the JAX package.

Sizes: the full-width generator, the discriminator at q = 4 /
min_channels = 8, one STFT resolution 512/50/240 with A-weighting, feature
matching and hinge, batch 1, T = 4500 (cut to 4320), float32.  The port's
random weights are converted to the JAX package's layout with its own
converters (``vibravox_tpu/models/convert.py``), so no JAX init compiles.

Tolerances: the eval step's logs 1e-4 relative and its outputs 1e-4 of
their scale (float32 summed in other orders); SI-SDR 1e-5 absolute (dB);
STOI 1e-9 (the same float64 numpy on both sides); the 48 kHz -> 16 kHz
resample 1e-5 of scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vibravox_tpu.core.callbacks import ModelSummary as JaxModelSummary
from vibravox_tpu.core.config import compose as jax_compose
from vibravox_tpu.losses.gan import FeatureMatchingLoss as JaxFeatureMatchingLoss
from vibravox_tpu.losses.gan import HingeLoss as JaxHingeLoss
from vibravox_tpu.metrics.audio import si_sdr as jax_si_sdr
from vibravox_tpu.metrics.audio import stoi as jax_stoi
from vibravox_tpu.models.convert import (
    eben_discriminator_params_from_torch,
    eben_generator_params_from_torch,
)
from vibravox_tpu.models.eben_discriminator import (
    DiscriminatorEBENMultiScales as JaxDiscriminatorEBENMultiScales,
)
from vibravox_tpu.models.eben_generator import EBENGenerator as JaxEBENGenerator
from vibravox_tpu.ops.resample import resample as jax_resample
from vibravox_tpu.ops.stft import MultiResolutionSTFTLoss as JaxMultiResolutionSTFTLoss
from vibravox_tpu.tasks.eben import EBENTask as JaxEBENTask
from vibravox_tpu.tasks.eben import EBENTrainState as JaxEBENTrainState
from vibravox_tpu.tasks.se_metrics import SEMetrics as JaxSEMetrics
from vibravox_tpu_torch.core.callbacks import ModelSummary
from vibravox_tpu_torch.core.config import compose
from vibravox_tpu_torch.core.optim import sgd
from vibravox_tpu_torch.data.sources import SyntheticVibravoxSource
from vibravox_tpu_torch.losses.gan import FeatureMatchingLoss, HingeLoss
from vibravox_tpu_torch.metrics.audio import si_sdr, stoi
from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
from vibravox_tpu_torch.models.eben_generator import EBENGenerator
from vibravox_tpu_torch.ops.resample import resample
from vibravox_tpu_torch.ops.stft import MultiResolutionSTFTLoss
from vibravox_tpu_torch.run import CONFIG_DIR, port_targets
from vibravox_tpu_torch.tasks.eben import EBENTask
from vibravox_tpu_torch.tasks.se_metrics import SEMetrics
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)


T = 4500


def _utterance(split="speech_clean-test", idx=0):
    item = SyntheticVibravoxSource(idx + 1, split=split)[idx]
    return item["audio_airborne"], item["audio_body_conducted"]


@pytest.fixture(scope="module")
def tasks():
    """The port task with random weights from seed 0, the JAX task and a
    JAX train state holding the same weights."""
    torch.manual_seed(0)
    task = EBENTask(
        sample_rate=16000,
        generator=EBENGenerator(m=4, n=32, p=2, device="cpu"),
        discriminator=DiscriminatorEBENMultiScales(q=4, min_channels=8, device="cpu"),
        generator_optimizer=sgd(1e-2), discriminator_optimizer=sgd(1e-2),
        reconstructive_loss_freq_fn=MultiResolutionSTFTLoss(
            (512,), (50,), (240,), sample_rate=16000, perceptual_weighting=True, device="cpu"),
        feature_matching_loss_fn=FeatureMatchingLoss(), adversarial_loss_fn=HingeLoss(),
        dynamic_loss_balancing="ema", device="cpu",
    )
    jtask = JaxEBENTask(
        sample_rate=16000,
        generator=JaxEBENGenerator(m=4, n=32, p=2),
        discriminator=JaxDiscriminatorEBENMultiScales(q=4, min_channels=8),
        generator_optimizer=optax.sgd(1e-2), discriminator_optimizer=optax.sgd(1e-2),
        reconstructive_loss_freq_fn=JaxMultiResolutionSTFTLoss(
            (512,), (50,), (240,), sample_rate=16000, perceptual_weighting=True),
        feature_matching_loss_fn=JaxFeatureMatchingLoss(), adversarial_loss_fn=JaxHingeLoss(),
        dynamic_loss_balancing="ema",
    )
    numpy_sd = lambda m: {k: v.detach().numpy() for k, v in m.state_dict().items()}
    jstate = JaxEBENTrainState(
        step=jnp.zeros((), jnp.int32),
        gen_params=eben_generator_params_from_torch(numpy_sd(task.generator)),
        disc_params=eben_discriminator_params_from_torch(numpy_sd(task.discriminator)),
        gen_opt_state=None, disc_opt_state=None,
        atomic_norms_ema=jnp.zeros((4,), jnp.float32), rng=None,
    )
    return task, task.init_state(0), jtask, jstate


def test_eval_step_matches_jax(tasks):
    task, state, jtask, jstate = tasks
    reference, body = _utterance()
    batch = {"audio_body_conducted": body[None, :T, None], "audio_airborne": reference[None, :T, None]}
    want = jax.device_get(jax.jit(jtask.eval_step)(jstate, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = task.eval_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got["logs"]) == set(want["logs"]) == {
        "generator/reconstructive_loss_freq", "generator/feature_matching_loss",
        "generator/adv_loss_gen", "discriminator/real_loss", "discriminator/fake_loss"}
    for k, v in want["logs"].items():
        np.testing.assert_allclose(float(got["logs"][k]), float(v), rtol=1e-4, err_msg=k)
    assert set(got) == set(want)
    for k in ("corrupted", "enhanced", "reference"):
        ref = np.asarray(want[k])
        assert got[k].shape == ref.shape == (1, 4320, 1), k
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=k)


def test_model_summary_totals_match_jax(tasks):
    _, state, _, jstate = tasks
    got, want = ModelSummary(3).summarize(state), JaxModelSummary(3).summarize(jstate)
    assert got.splitlines()[-1] == want.splitlines()[-1] == "total: 21,294,160"
    assert got.splitlines()[0] == "generator: 1,945,984 params"
    assert want.splitlines()[0] == "gen_params: 1,945,984 params"


@pytest.mark.parametrize("zero_mean", [False, True])
def test_si_sdr_matches_jax(zero_mean):
    reference, body = _utterance()
    preds = np.stack([body, 0.5 * reference + 0.1 * body])
    target = np.stack([reference, reference])
    want = float(jax_si_sdr(jnp.asarray(preds), jnp.asarray(target), zero_mean=zero_mean))
    got = float(si_sdr(torch.from_numpy(preds), torch.from_numpy(target), zero_mean=zero_mean))
    assert abs(got - want) <= 1e-5


@pytest.mark.parametrize("fs", [16000, 10000])
def test_stoi_matches_jax(fs):
    """At 16 kHz both sides resample to 10 kHz first (Kaiser); at 10 kHz not."""
    reference, body = _utterance()
    assert abs(stoi(reference, body, fs=fs) - jax_stoi(reference, body, fs=fs)) <= 1e-9


@pytest.mark.parametrize("window", ["hann", "kaiser"])
def test_resample_48k_to_16k_matches_jax(window):
    x = np.random.default_rng(0).standard_normal((2, 48001)).astype(np.float32) * 0.1
    want = np.asarray(jax_resample(jnp.asarray(x), 48000, 16000, window=window))
    got = resample(torch.from_numpy(x), 48000, 16000, window=window).numpy()
    assert got.shape == want.shape == (2, 16001)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # (B, T, 1) keeps its layout
    got3 = resample(torch.from_numpy(x[:, :, None]), 48000, 16000, window=window).numpy()
    assert np.array_equal(got3[:, :, 0], got)


def test_se_metrics_match_jax():
    """One batch of two whole utterances: the same keys, SI-SDR within 1e-5,
    STOI within 1e-9, and the first clean batch kept."""
    pairs = [_utterance("speech_clean-validation", i) for i in range(2)]
    n = min(len(r) for r, _ in pairs)
    reference = np.stack([r[:n] for r, _ in pairs])[:, :, None]
    enhanced = np.stack([b[:n] for _, b in pairs])[:, :, None]
    ours, theirs = SEMetrics(16000), JaxSEMetrics(16000)
    got = ours({"enhanced": torch.from_numpy(enhanced), "reference": torch.from_numpy(reference)})
    want = theirs({"enhanced": jnp.asarray(enhanced), "reference": jnp.asarray(reference)})
    assert set(got) == set(want) == {"torchmetrics_si_sdr", "torchmetrics_stoi"}
    assert abs(got["torchmetrics_si_sdr"] - want["torchmetrics_si_sdr"]) <= 1e-5
    assert abs(got["torchmetrics_stoi"] - want["torchmetrics_stoi"]) <= 1e-9
    assert np.array_equal(ours.first_sample, theirs.first_sample)


def _unport(node):
    """The port's composed config with its rewrite undone: JAX targets and
    no ``device`` keys."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k == "device" and "_target_" in node:
                continue
            if k == "_target_" and v.startswith("vibravox_tpu_torch."):
                v = "vibravox_tpu." + v[len("vibravox_tpu_torch."):]
            out[k] = _unport(v)
        return out
    if isinstance(node, list):
        return [_unport(v) for v in node]
    return node


def test_composed_config_matches_jax_after_the_target_rewrite():
    overrides = ["lightning_datamodule=bwe", "lightning_module=eben", "callbacks=bwe_checkpoint",
                 "logging=csv", "lightning_datamodule.dataset_name_principal=synthetic",
                 "~lightning_datamodule.data_augmentation", "++trainer.max_epochs=2",
                 "++run_dir=outputs/fixed"]
    cfg = compose(CONFIG_DIR, "run", overrides)
    want = jax_compose(CONFIG_DIR, "run", overrides)
    assert cfg == want
    port_targets(cfg, "cpu")
    targets = []

    def walk(node):
        if isinstance(node, dict):
            if "_target_" in node:
                targets.append((node["_target_"], node.get("device")))
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(cfg)
    assert all(t.startswith(("vibravox_tpu_torch.", "builtins.")) for t, _ in targets)
    with_device = {t for t, d in targets if d == "cpu"}
    assert with_device == {
        "vibravox_tpu_torch.data.bwe.BWEDataModule", "vibravox_tpu_torch.tasks.eben.EBENTask",
        "vibravox_tpu_torch.models.eben_generator.EBENGenerator",
        "vibravox_tpu_torch.models.eben_discriminator.DiscriminatorEBENMultiScales",
        "vibravox_tpu_torch.ops.stft.MultiResolutionSTFTLoss"}
    # the trainer runs on its task's device
    assert ("vibravox_tpu_torch.core.loop.Trainer", None) in targets
    assert _unport(cfg) == want
    assert "data_augmentation" not in cfg.lightning_datamodule
