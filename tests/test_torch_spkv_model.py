"""PyTorch port: the speaker embedders and their front end against the JAX package.

The log-mel front end (the plain version of K3 on the CPU), ``ECAPA2`` at
the tiny preset with its BatchNorm statistics randomised, its bf16 trunk,
the full preset's parameter shapes, ``ECAPATDNN`` at a narrow width, the
converters from JAX variables, and a torch checkpoint file loaded by both
packages' ``SPKVTask``.  Inputs come from numpy seeds; JAX runs under
``jax.jit`` on the CPU.

Tolerances:
* the mel filterbank is byte-equal (the same numpy code);
* log-mel features: 1e-5 absolute on the mel bins whose power is at least
  1e-3 of their frame's largest, 1e-4 on every bin.  Both packages compute
  the STFT in float32 (JAX as a DFT matmul, the port with ``torch.stft``),
  whose error in a bin's power is a fraction of the frame's energy, so the
  error of a log grows as the bin's power falls: measured 2.0e-5 (noise)
  and 4.1e-5 (the synthetic speech) on every bin, each package within
  3.5e-5 of a float64 evaluation, and at most 5.5e-6 above the floor;
* float32 embeddings: 2e-5 of their scale, the JAX package's own bar for
  its converter (measured 3.7e-7; ECAPA-TDNN 8.6e-7);
* the bf16 trunk against JAX's bf16 trunk: 1e-2 of scale (measured
  1.1e-3; each package's bf16 against its float32 is 1.7e-3 to 1.8e-3);
  the two round the same casts but sum in another order;
* scores of the shared checkpoint: 1e-6 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibravox_tpu.models.ecapa2 import ECAPA2 as JaxECAPA2
from vibravox_tpu.models.ecapa2 import PRESETS as JAX_PRESETS
from vibravox_tpu.models.ecapa_tdnn import ECAPATDNN as JaxECAPATDNN
from vibravox_tpu.ops.mel import log_mel_spectrogram as jax_log_mel
from vibravox_tpu.ops.mel import mel_filterbank as jax_mel_filterbank
from vibravox_tpu_torch.data.sources import SyntheticVibravoxSource
from vibravox_tpu_torch.models.convert import ecapa2_state_dict_from_jax, ecapa_tdnn_state_dict_from_jax
from vibravox_tpu_torch.models.ecapa2 import ECAPA2, PRESETS, ecapa2_from_config
from vibravox_tpu_torch.models.ecapa_tdnn import ECAPATDNN
from vibravox_tpu_torch.ops.mel import log_mel_spectrogram, mel_filterbank
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

TINY = JAX_PRESETS["tiny"]()
TDNN = dict(channels=32, embed_dim=16, scale=4)


def _audio(seed, shape=(2, 16000)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _randomise(variables, seed):
    """numpy variables with every BatchNorm's scale, bias and running
    statistics drawn at random, so that the comparisons exercise them."""
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(np.array, variables)

    def walk(params, stats):
        for k, v in params.items():
            if isinstance(v, dict) and "scale" in v:
                v["scale"] = (rng.random(v["scale"].shape) + 0.5).astype(np.float32)
                v["bias"] = (rng.standard_normal(v["bias"].shape) * 0.1).astype(np.float32)
                stats[k]["mean"] = (rng.standard_normal(stats[k]["mean"].shape) * 0.2).astype(np.float32)
                stats[k]["var"] = (rng.random(stats[k]["var"].shape) + 0.5).astype(np.float32)
            elif isinstance(v, dict):
                walk(v, stats.get(k, {}))

    walk(variables["params"], variables["batch_stats"])
    return variables


def _scale_err(ours, ref):
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def tiny_variables():
    init = JaxECAPA2(TINY).init(jax.random.key(0), jnp.zeros((1, 16000)))
    return _randomise(init, 1)


@pytest.mark.parametrize("sample_rate,n_fft,n_mels,htk", [(16000, 512, 80, True), (16000, 400, 40, True),
                                                          (8000, 256, 24, False)])
def test_mel_filterbank_is_byte_equal(sample_rate, n_fft, n_mels, htk):
    ours = mel_filterbank(sample_rate, n_fft, n_mels, htk=htk)
    ref = jax_mel_filterbank(sample_rate, n_fft, n_mels, htk=htk)
    assert ours.dtype == ref.dtype and ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("source", ["noise", "synthetic"])
def test_log_mel_spectrogram_matches_jax(source):
    if source == "noise":
        audio = _audio(0, (2, 16000))
    else:
        items = SyntheticVibravoxSource(n_utterances=2, split="spkv-test", with_metadata=True)
        audio = np.stack([items[i]["audio_body_conducted"][:32000] for i in range(2)]).astype(np.float32)
    ref = np.asarray(jax.jit(jax_log_mel)(jnp.asarray(audio)))
    ours = log_mel_spectrogram(torch.from_numpy(audio)).numpy()
    assert ours.shape == ref.shape == (2, 1 + audio.shape[1] // 160, 80) and ours.dtype == np.float32
    power = np.exp(ref)
    loud = power >= 1e-3 * power.max(axis=-1, keepdims=True)
    err = np.abs(ours - ref)
    assert err[loud].max() <= 1e-5 and err.max() <= 1e-4


def test_ecapa2_tiny_matches_jax(tiny_variables):
    audio = _audio(2)
    ref = np.asarray(jax.jit(JaxECAPA2(TINY).apply)(tiny_variables, jnp.asarray(audio)))
    model = ECAPA2(PRESETS["tiny"](), device="cpu")
    model.load_state_dict(ecapa2_state_dict_from_jax(tiny_variables, model.config), strict=True)
    with torch.no_grad():
        ours = model(torch.from_numpy(audio)).numpy()
    assert ours.shape == (2, 16)
    assert _scale_err(ours, ref) <= 2e-5


def test_batch_norm_uses_running_statistics_in_train_mode(tiny_variables):
    model = ECAPA2(PRESETS["tiny"](), device="cpu")
    model.load_state_dict(ecapa2_state_dict_from_jax(tiny_variables, model.config), strict=True)
    x = torch.from_numpy(_audio(3))
    with torch.no_grad():
        evaluated = model.eval()(x)
        trained = model.train()(x)
    assert torch.equal(evaluated, trained)
    assert all(int(m.num_batches_tracked) == 0 for m in model.modules() if isinstance(m, torch.nn.BatchNorm1d))


def test_bf16_trunk_matches_jax_bf16(tiny_variables):
    audio = _audio(4)
    jax16 = JaxECAPA2(dataclasses.replace(TINY, compute_dtype="bfloat16"))
    ref = np.asarray(jax.jit(jax16.apply)(tiny_variables, jnp.asarray(audio)))
    model = ecapa2_from_config("tiny", device="cpu", compute_dtype="bfloat16")
    model.load_state_dict(ecapa2_state_dict_from_jax(tiny_variables, model.config), strict=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        ours = model(torch.from_numpy(audio))
    assert ours.dtype == torch.float32
    assert _scale_err(ours.numpy(), ref) <= 1e-2


@pytest.mark.parametrize("samples", [8000, 24000])
def test_time_resolution_is_kept_for_any_length(tiny_variables, samples):
    """The LFE strides frequency only: any length gives one embedding, and
    the port equals JAX at each."""
    audio = _audio(5, (1, samples))
    ref = np.asarray(jax.jit(JaxECAPA2(TINY).apply)(tiny_variables, jnp.asarray(audio)))
    model = ECAPA2(PRESETS["tiny"](), device="cpu")
    model.load_state_dict(ecapa2_state_dict_from_jax(tiny_variables, model.config), strict=True)
    with torch.no_grad():
        ours = model(torch.from_numpy(audio)).numpy()
    assert ours.shape == (1, 16) and _scale_err(ours, ref) <= 2e-5


def test_full_preset_parameter_shapes_equal_jax():
    shapes = jax.eval_shape(JaxECAPA2(JAX_PRESETS["full"]()).init, jax.random.key(0), jnp.zeros((1, 16000)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    converted = ecapa2_state_dict_from_jax(zeros, PRESETS["full"]())
    ours = ECAPA2(device="cpu").state_dict()
    assert set(converted) == set(ours)
    assert {k: tuple(v.shape) for k, v in converted.items()} == {k: tuple(v.shape) for k, v in ours.items()}
    cfg = ECAPA2(device="cpu").config
    assert (cfg.n_mels, cfg.stem_channels, cfg.gfe_channels, cfg.res2_scale, cfg.embed_dim) == (80, 64, 1024, 8, 192)
    assert ours["gfe_proj.weight"].shape == (1024, 5 * 128, 1)  # frequency 80 -> 5 after four stages


def test_ecapa_tdnn_matches_jax():
    audio = _audio(6)
    jax_model = JaxECAPATDNN(**TDNN)
    variables = _randomise(jax_model.init(jax.random.key(1), jnp.zeros((1, 16000))), 7)
    ref = np.asarray(jax.jit(jax_model.apply)(variables, jnp.asarray(audio)))
    model = ECAPATDNN(**TDNN, device="cpu")
    model.load_state_dict(ecapa_tdnn_state_dict_from_jax(variables, scale=TDNN["scale"]), strict=True)
    with torch.no_grad():
        ours = model(torch.from_numpy(audio)).numpy()
    assert ours.shape == (2, 16) and _scale_err(ours, ref) <= 2e-5


@pytest.mark.parametrize("which", ["ecapa2", "ecapa_tdnn"])
def test_converters_raise_on_a_stray_leaf(tiny_variables, which):
    if which == "ecapa2":
        variables = jax.tree_util.tree_map(np.array, tiny_variables)
        variables["params"]["mystery"] = {"kernel": np.zeros((1,), np.float32)}
        convert = lambda v: ecapa2_state_dict_from_jax(v, PRESETS["tiny"]())  # noqa: E731
    else:
        shapes = jax.eval_shape(JaxECAPATDNN(**TDNN).init, jax.random.key(0), jnp.zeros((1, 16000)))
        variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
        variables["batch_stats"]["block_1"]["stray"] = {"mean": np.zeros((1,), np.float32)}
        convert = lambda v: ecapa_tdnn_state_dict_from_jax(v, scale=TDNN["scale"])  # noqa: E731
    with pytest.raises(ValueError, match="unconsumed"):
        convert(variables)


def test_checkpoint_file_loads_into_both_tasks_with_equal_scores(tiny_variables, tmp_path):
    """A torch state dict in the converter layout, given to both packages'
    ``SPKVTask`` through ``checkpoint_path``: the same scores."""
    from vibravox_tpu.tasks.ecapa2_spkv import SPKVTask as JaxSPKVTask
    from vibravox_tpu_torch.tasks.ecapa2_spkv import SPKVTask

    model = ECAPA2(PRESETS["tiny"](), device="cpu")
    model.load_state_dict(ecapa2_state_dict_from_jax(tiny_variables, model.config), strict=True)
    path = tmp_path / "ecapa2_state.pt"
    torch.save(model.state_dict(), path)

    a, b = _audio(8, (3, 12000)), _audio(9, (3, 12000))
    jax_task = JaxSPKVTask(embedder=JaxECAPA2(TINY), checkpoint_path=str(path))
    jax_state = jax_task.init_state(jax.random.key(0), {})
    ref = jax.jit(jax_task.eval_step)(jax_state, {"sensor_a_audio": jnp.asarray(a), "sensor_b_audio": jnp.asarray(b)})

    task = SPKVTask(embedder=ecapa2_from_config("tiny", device="cpu"), checkpoint_path=str(path), device="cpu")
    state = task.init_state(0)
    ours = task.eval_step(state, {"sensor_a_audio": torch.from_numpy(a), "sensor_b_audio": torch.from_numpy(b)})
    for key in ("cosine", "euclidean"):
        assert ours[key].shape == (3,)
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), rtol=0, atol=1e-6)


def test_random_weights_follow_the_seed_only():
    """Without a checkpoint the embedder's weights come from the trainer's
    seed, whatever torch's global generator holds."""
    from vibravox_tpu_torch.tasks.ecapa2_spkv import SPKVTask

    def weights(seed, global_seed):
        torch.manual_seed(global_seed)
        task = SPKVTask(embedder=ecapa2_from_config("tiny", device="cpu"), device="cpu")
        return task.init_state(seed).embedder.state_dict()

    first, again, other = weights(3, 0), weights(3, 1), weights(4, 0)
    assert all(torch.equal(first[k], again[k]) for k in first)
    assert not torch.equal(first["embedding.weight"], other["embedding.weight"])
