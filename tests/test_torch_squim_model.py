"""PyTorch port: the SQUIM networks against the JAX package.

* ``_chunk`` / ``_merge`` equal JAX's (chunks, gap and overlap-add) over
  ``tests/test_squim.py``'s cases, the base model's T' = 1249 at 2.5 s and
  T % chunk == 0.
* The tiny objective (``TINY_OBJ``'s values) over both weight routes: a
  torchaudio-schema state dict through JAX's
  ``squim_objective_params_from_torch`` and the port's strict load, and JAX
  params through ``squim_objective_state_dict_from_jax``.  Every leaf is
  randomised first (norm scales and biases, PReLU slopes, ``alpha``), so no
  layer is an identity.  Bar: 1e-5 of each score's scale.
* The tiny subjective (``TINY_W2V2_CONFIG``'s values, projector and
  attention width 8) over the same two routes, 1e-5 of scale.
* ``_align``; the ``*_base()`` parameter counts against JAX's, from shapes.

Inputs are float32 from a numpy seed; JAX runs on the CPU under ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibravox_tpu.models import squim as jsquim
from vibravox_tpu.models.wav2vec2 import TINY_W2V2_CONFIG as JAX_TINY_W2V2
from vibravox_tpu.models.wav2vec2 import Wav2Vec2Config as JaxWav2Vec2Config
from vibravox_tpu_torch.models import squim
from vibravox_tpu_torch.models.convert import (
    squim_objective_state_dict_from_jax,
    squim_subjective_state_dict_from_jax,
)
from vibravox_tpu_torch.models.wav2vec2 import TINY_W2V2_CONFIG, Wav2Vec2Config
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

TINY_OBJ = dict(feat_dim=8, win_len=16, d_model=8, nhead=2, hidden_dim=8, num_blocks=1, chunk_size=7)
SSL = dict(vocab_size=1, apply_spec_augment=False, layerdrop=0.0)
TOL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jittered(tree, seed: int):
    """Every leaf plus 0.1 x a standard normal draw (numpy)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x))).astype(np.float32), tree)


def _tiny(make, config, seed: int):
    """A tiny network with torch's default random weights from ``seed``."""
    torch.manual_seed(seed)
    return make(config).eval()


def _jittered_state_dict(sd, seed: int):
    return {k: torch.from_numpy(v) for k, v in _jittered({k: v.numpy() for k, v in sd.items()}, seed).items()}


@pytest.mark.parametrize("t,chunk", [(100, 7), (71, 71), (256, 8), (33, 10), (1249, 71), (213, 71)])
def test_chunk_and_merge_match_jax(t, chunk):
    x = np.random.default_rng(t).standard_normal((2, t, 3)).astype(np.float32)
    want, want_gap = jsquim._chunk(jnp.asarray(x), chunk)
    got, gap = squim._chunk(torch.from_numpy(x), chunk)
    assert gap == want_gap and got.shape == want.shape
    assert np.array_equal(got.numpy(), np.asarray(want))
    merged = squim._merge(got, gap, chunk)
    assert np.array_equal(merged.numpy(), np.asarray(jsquim._merge(want, want_gap, chunk)))
    np.testing.assert_allclose(merged.numpy(), 2 * x, atol=1e-6)
    if (t, chunk) == (1249, 71):  # the base model at 2.5 s of 16 kHz audio
        assert (gap, got.shape[1]) == (65, 38)


@pytest.fixture(scope="module")
def objective_pair():
    """(JAX model, its apply, the port's tiny config)."""
    jcfg = jsquim.SquimObjectiveConfig(**TINY_OBJ)
    model = jsquim.SquimObjective(jcfg)
    return model, jax.jit(model.apply), squim.SquimObjectiveConfig(**TINY_OBJ)


@pytest.mark.parametrize("route", ["torchaudio_state_dict", "jax_params"])
def test_tiny_objective_matches_jax(objective_pair, route):
    jmodel, apply, cfg = objective_pair
    if route == "torchaudio_state_dict":
        sd = _jittered_state_dict(_tiny(squim.SquimObjective, cfg, 1).state_dict(), 0)
        params = jsquim.squim_objective_params_from_torch({k: v.numpy() for k, v in sd.items()}, jmodel.config)
    else:
        params = _jittered(jax.device_get(jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 800)))), 1)
        sd = squim_objective_state_dict_from_jax(params, cfg)
    port = _tiny(squim.SquimObjective, cfg, 2)
    port.load_state_dict(sd, strict=True)
    x = np.random.default_rng(3).standard_normal((2, 1600)).astype(np.float32)
    want = apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for name, g, w in zip(("stoi", "pesq", "sisdr"), got, want):
        assert g.shape == (2,) and _rel(g, w) <= TOL, (name, _rel(g, w))
    assert all(bool(((0 <= s) & (s <= 1)).all()) for s in got[:1])
    assert bool(((1 <= got[1]) & (got[1] <= 4.5)).all())


@pytest.fixture(scope="module")
def subjective_pair():
    jcfg = jsquim.SquimSubjectiveConfig(proj_dim=8, att_dim=8, ssl=JaxWav2Vec2Config(**JAX_TINY_W2V2, **SSL))
    cfg = squim.SquimSubjectiveConfig(proj_dim=8, att_dim=8, ssl=Wav2Vec2Config(**TINY_W2V2_CONFIG, **SSL))
    model = jsquim.SquimSubjective(jcfg)
    return model, jax.jit(model.apply), cfg


@pytest.mark.parametrize("route", ["torchaudio_state_dict", "jax_params"])
def test_tiny_subjective_matches_jax(subjective_pair, route):
    jmodel, apply, cfg = subjective_pair
    rng = np.random.default_rng(4)
    est = rng.standard_normal((2, 4000)).astype(np.float32)
    ref = rng.standard_normal((2, 2500)).astype(np.float32)
    port = _tiny(squim.SquimSubjective, cfg, 5)
    if route == "torchaudio_state_dict":
        source = _tiny(squim.SquimSubjective, cfg, 6)
        sd = _jittered_state_dict(source.torchaudio_state_dict(), 2)
        params = jsquim.squim_subjective_params_from_torch({k: v.numpy() for k, v in sd.items()}, jmodel.config)
        port.load_torchaudio_state_dict(sd)
    else:
        init = jax.jit(jmodel.init)(jax.random.key(1), jnp.zeros((1, 4000)), jnp.zeros((1, 4000)))
        params = _jittered(jax.device_get(init), 3)
        port.load_state_dict(squim_subjective_state_dict_from_jax(params, cfg), strict=True)
    want = apply(params, jnp.asarray(est), jnp.asarray(ref))
    with torch.no_grad():
        got = port(torch.from_numpy(est), torch.from_numpy(ref))
    assert got.shape == (2,) and _rel(got, want) <= TOL, _rel(got, want)


def test_align_tiles_and_crops():
    out = squim.SquimSubjective._align(torch.zeros(1, 10), torch.arange(4.0)[None])
    want = jsquim.SquimSubjective()._align(jnp.zeros((1, 10)), jnp.arange(4.0)[None])
    assert out[0].tolist() == [0, 1, 2, 3, 0, 1, 2, 3, 0, 1] == np.asarray(want)[0].tolist()


def _jax_count(model, *inputs) -> int:
    shapes = jax.eval_shape(model.init, jax.random.key(0), *inputs)
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))


def test_base_parameter_counts_match_jax():
    """The published architectures, counted from shapes (no forward): the
    objective's 7.39 M, less torch's second LSTM bias (flax keeps one bias
    per gate, the sum of torch's two), and the subjective's wav2vec2-base and
    head without the port's unused one-row CTC head."""
    obj = squim.squim_objective_base(device="cpu")
    n_obj = sum(p.numel() for p in obj.parameters())
    n_bias_hh = sum(p.numel() for k, p in obj.named_parameters() if ".bias_hh_l0" in k)
    assert n_obj == 7_387_658 and n_bias_hh == 8 * 1024
    assert n_obj - n_bias_hh == _jax_count(jsquim.squim_objective_base(), jnp.zeros((1, 16000)))
    with torch.device("meta"):
        subj = squim.SquimSubjective()
    n_subj = sum(v.numel() for v in subj.torchaudio_state_dict().values())
    audio = jnp.zeros((1, 16000))
    assert n_subj == _jax_count(jsquim.squim_subjective_base(), audio, audio)
    assert 94e6 < n_subj < 96e6
