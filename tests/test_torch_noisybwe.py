"""PyTorch port: the noisy BWE data module and the reference-free eval path
against the JAX package.

The synthetic noise source (the JAX one seeded as the port's: its own
``hash(split)`` seed differs from process to process), the mix of speech
and noise (exact: the same slice starts from generators in the same
state), the real noisy batches (pad only, no reference), the loader dicts,
and the EBEN eval step and SE metrics on a batch without a reference: no
losses, no reference, the enhanced audio within 1e-4 of its scale (the
full-width generator in float32, as ``tests/test_torch_workflow_jax.py``),
and no metric without SQUIM.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vibravox_tpu.data.noisybwe import NoisyBWECollate as JaxNoisyBWECollate
from vibravox_tpu.data.noisybwe import NoisyBWEDataModule as JaxNoisyBWEDataModule
from vibravox_tpu.data.noisybwe import _SyntheticNoiseSource as JaxSyntheticNoiseSource
from vibravox_tpu.models.convert import eben_generator_params_from_torch
from vibravox_tpu.models.eben_generator import EBENGenerator as JaxEBENGenerator
from vibravox_tpu.native import pipeline as jax_native
from vibravox_tpu.tasks.eben import EBENTask as JaxEBENTask
from vibravox_tpu.tasks.eben import EBENTrainState as JaxEBENTrainState
from vibravox_tpu.tasks.se_metrics import SEMetrics as JaxSEMetrics
from vibravox_tpu_torch.core.optim import sgd
from vibravox_tpu_torch.data.noisybwe import (
    NOISE_KEY,
    NoisyBWECollate,
    NoisyBWEDataModule,
    _SyntheticNoiseSource,
    mix_noise,
)
from vibravox_tpu_torch.data.sources import SyntheticVibravoxSource
from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
from vibravox_tpu_torch.models.eben_generator import EBENGenerator
from vibravox_tpu_torch.tasks.eben import EBENTask
from vibravox_tpu_torch.tasks.se_metrics import SEMetrics
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)


@pytest.fixture(autouse=True)
def jax_numpy_collate(monkeypatch):
    monkeypatch.setattr(jax_native, "native_available", lambda: False)


def _noise(split="noise-train", n=2, seconds=0.5):
    ours = _SyntheticNoiseSource(n, 16000, split, seconds=seconds)
    ref = JaxSyntheticNoiseSource(n, 16000, split, seconds=seconds)
    ref.base_seed = ours.base_seed
    return ours, ref


def test_synthetic_noise_source_matches_jax_and_is_stable():
    ours, ref = _noise()
    for i in range(2):
        assert ours[i][NOISE_KEY].tobytes() == ref[i][NOISE_KEY].tobytes()
        assert ours[i][NOISE_KEY].shape == (8000,)
    assert ours.base_seed == _SyntheticNoiseSource(2, 16000, "noise-train").base_seed
    assert ours.base_seed != _SyntheticNoiseSource(2, 16000, "noise-validation").base_seed


@pytest.mark.parametrize("deterministic", [False, True])
def test_noisy_mix_and_collate_are_jaxs(deterministic):
    """Speech longer and shorter than its noise (tiled), crops and pads:
    the same slice starts and crops from generators in the same state, so
    the batches are byte-equal."""
    noise, _ = _noise(seconds=0.3)
    speech = SyntheticVibravoxSource(3, min_seconds=0.2, max_seconds=0.6, split="speech_clean-train")
    samples = [dict(speech[i], **{NOISE_KEY: noise[i % 2][NOISE_KEY]}) for i in range(3)]
    ours = NoisyBWECollate(16000, "constant_length-250-ms", deterministic=deterministic, seed=5)
    ref = JaxNoisyBWECollate(16000, "constant_length-250-ms", deterministic=deterministic, seed=5)
    for _ in range(2):
        got, want = ours(samples), ref(samples)
        assert set(got) == set(want) == {"audio_body_conducted", "audio_airborne"}
        for k in want:
            assert got[k].shape == want[k].shape == (3, 4000, 1)
            assert got[k].numpy().tobytes() == want[k].tobytes(), k
    rng = np.random.default_rng(0)
    s, n = speech[0]["audio_body_conducted"], noise[0][NOISE_KEY]
    start = int(np.random.default_rng(0).integers(0, len(np.tile(n, -(-len(s) // len(n)))) - len(s) + 1))
    assert np.array_equal(mix_noise(s, n, rng), s + np.tile(n, -(-len(s) // len(n)))[start:start + len(s)])


def test_real_noisy_batches_are_pad_only_as_jaxs():
    items = [{"audio_body_conducted": SyntheticVibravoxSource(2, min_seconds=0.1, max_seconds=0.3,
                                                              split="speech_noisy-test")[i]["audio_body_conducted"]}
             for i in range(2)]
    got = NoisyBWECollate(16000, deterministic=True)(items)
    want = JaxNoisyBWECollate(16000, deterministic=True)(items)
    assert set(got) == set(want) == {"audio_body_conducted"}
    assert got["audio_body_conducted"].numpy().tobytes() == want["audio_body_conducted"].tobytes()
    assert got["audio_body_conducted"].shape[1] == max(len(i["audio_body_conducted"]) for i in items)


def test_loader_dicts_and_their_batches():
    """Validation and test are {"synthetic", "real"} dicts of batch-1
    loaders; the real batches equal the JAX module's (no draws), the
    synthetic ones are the speech mixed with the keyed noise pairing."""
    kw = dict(dataset_name="synthetic", collate_strategy="constant_length-250-ms", batch_size=2, synthetic_size=4)
    dm = NoisyBWEDataModule(num_workers=0, device="cpu", **kw)
    ref = JaxNoisyBWEDataModule(**kw)
    for stage, get in (("validate", "val_dataloader"), ("test", "test_dataloader")):
        dm.setup(stage), ref.setup(stage)
        loaders, ref_loaders = getattr(dm, get)(), getattr(ref, get)()
        assert set(loaders) == set(ref_loaders) == {"synthetic", "real"}
        real, ref_real = list(loaders["real"]), list(ref_loaders["real"])
        assert len(real) == len(ref_real) == 2
        for a, b in zip(real, ref_real):
            assert set(a) == set(b) == {"audio_body_conducted"}
            assert a["audio_body_conducted"].numpy().tobytes() == b["audio_body_conducted"].tobytes()
        synth = list(loaders["synthetic"])
        assert len(synth) == 4 and all(b["audio_airborne"].shape == (1, 4000, 1) for b in synth)
    source = dm._sources["test_synth"]
    item = source.keyed_item(1, 0)
    assert np.array_equal(item[NOISE_KEY], source.noise[source.noise_index(1, 0)][NOISE_KEY])
    collate = NoisyBWECollate(16000, "constant_length-250-ms", deterministic=True, seed=dm.seed)
    want = collate.keyed([item], (0, 1), [1])
    assert torch.equal(synth[1]["audio_body_conducted"], want["audio_body_conducted"])
    assert not torch.equal(synth[1]["audio_body_conducted"], synth[1]["audio_airborne"])


def test_reference_free_eval_step_and_metrics_match_jax(monkeypatch):
    monkeypatch.delenv("VIBRAVOX_SQUIM_DIR", raising=False)
    torch.manual_seed(0)
    task = EBENTask(16000, EBENGenerator(m=4, n=32, p=2, device="cpu"),
                    DiscriminatorEBENMultiScales(q=4, min_channels=8, device="cpu"), sgd(1e-2), sgd(1e-2),
                    device="cpu")
    jtask = JaxEBENTask(16000, JaxEBENGenerator(m=4, n=32, p=2), None, optax.sgd(1e-2), optax.sgd(1e-2))
    params = eben_generator_params_from_torch({k: v.detach().numpy() for k, v in task.generator.state_dict().items()})
    jstate = JaxEBENTrainState(step=jnp.zeros((), jnp.int32), gen_params=params, disc_params=None,
                               gen_opt_state=None, disc_opt_state=None,
                               atomic_norms_ema=jnp.zeros((4,), jnp.float32), rng=None)
    body = SyntheticVibravoxSource(1, split="speech_noisy-test")[0]["audio_body_conducted"][None, :4500, None]
    want = jax.device_get(jax.jit(jtask.eval_step)(jstate, {"audio_body_conducted": jnp.asarray(body)}))
    got = task.eval_step(task.init_state(0), {"audio_body_conducted": torch.from_numpy(body)})
    assert set(got) == set(want) == {"corrupted", "enhanced", "logs"} and got["logs"] == want["logs"] == {}
    for k in ("corrupted", "enhanced"):
        ref = np.asarray(want[k])
        assert got[k].shape == ref.shape == (1, 4320, 1)
        assert np.abs(got[k].numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), k
    outputs = {"enhanced": got["enhanced"]}
    assert SEMetrics(16000)(outputs) == JaxSEMetrics(16000)({"enhanced": jnp.asarray(want["enhanced"])}) == {}
