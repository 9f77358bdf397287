"""PyTorch port: the SQUIM metrics and the SE eval's SQUIM slots against JAX.

* ``SEMetrics`` with the same tiny predictors injected into both packages
  (a torchaudio-schema state dict, every leaf randomised, loaded by each):
  a reference-free batch before any clean one, a batch with a reference,
  a reference-free batch, and one of another size (``first_sample`` tiled):
  the same keys, values within 1e-5 (relative above 1); ``update`` /
  ``compute`` accumulate as JAX's do.
* ``load_squim_predictors`` on a directory holding a full-width random
  objective (``squim_objective.pt``, ~30 MB): the port's predictor against
  JAX's ``load_squim_objective`` on 0.5 s of audio, 1e-5 of scale.
* The full-width subjective by its keys only: JAX's
  ``squim_subjective_params_from_torch`` consumes the port's
  ``squim_subjective_base()`` state dict whole (no forward, no file).
* An empty ``VIBRAVOX_SQUIM_DIR`` gives no slots in either package;
  ``compute()`` with nothing accumulated raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibravox_tpu.metrics import squim as jmetrics
from vibravox_tpu.models import squim as jsquim
from vibravox_tpu.models.wav2vec2 import TINY_W2V2_CONFIG as JAX_TINY_W2V2
from vibravox_tpu.models.wav2vec2 import Wav2Vec2Config as JaxWav2Vec2Config
from vibravox_tpu.tasks.se_metrics import SEMetrics as JaxSEMetrics
from vibravox_tpu_torch.metrics import squim as metrics
from vibravox_tpu_torch.models import squim
from vibravox_tpu_torch.models.wav2vec2 import TINY_W2V2_CONFIG, Wav2Vec2Config
from vibravox_tpu_torch.tasks.se_metrics import SEMetrics
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

TINY_OBJ = dict(feat_dim=8, win_len=16, d_model=8, nhead=2, hidden_dim=8, num_blocks=1, chunk_size=7)
SSL = dict(vocab_size=1, apply_spec_augment=False, layerdrop=0.0)


def _jittered(sd, seed: int):
    rng = np.random.default_rng(seed)
    return {k: (v.numpy() + 0.1 * rng.standard_normal(tuple(v.shape))).astype(np.float32) for k, v in sd.items()}


def _close(got: float, want: float) -> bool:
    return abs(got - want) <= 1e-5 * max(1.0, abs(want))


@pytest.fixture(scope="module")
def predictors():
    """Tiny (port, JAX) predictor pairs, the same weights in each."""
    torch.manual_seed(0)
    obj = squim.SquimObjective(squim.SquimObjectiveConfig(**TINY_OBJ)).eval()
    obj_sd = _jittered(obj.state_dict(), 0)
    obj.load_state_dict({k: torch.from_numpy(v) for k, v in obj_sd.items()}, strict=True)
    jobj_cfg = jsquim.SquimObjectiveConfig(**TINY_OBJ)
    jobj = jax.jit(jsquim.SquimObjective(jobj_cfg).apply)

    subj_cfg = squim.SquimSubjectiveConfig(proj_dim=8, att_dim=8, ssl=Wav2Vec2Config(**TINY_W2V2_CONFIG, **SSL))
    subj = squim.SquimSubjective(subj_cfg).eval()
    subj_sd = _jittered(subj.torchaudio_state_dict(), 1)
    subj.load_torchaudio_state_dict({k: torch.from_numpy(v) for k, v in subj_sd.items()})
    jsubj_cfg = jsquim.SquimSubjectiveConfig(proj_dim=8, att_dim=8, ssl=JaxWav2Vec2Config(**JAX_TINY_W2V2, **SSL))
    jsubj = jax.jit(jsquim.SquimSubjective(jsubj_cfg).apply)

    port = ((lambda m, x: m(x)[0].detach(), obj), (lambda m, e, r: m(e, r).detach(), subj))
    jax_side = ((lambda p, x: np.asarray(jobj(p, jnp.asarray(x))[0]),
                 jsquim.squim_objective_params_from_torch(obj_sd, jobj_cfg)),
                (lambda p, e, r: np.asarray(jsubj(p, jnp.asarray(e), jnp.asarray(r))),
                 jsquim.squim_subjective_params_from_torch(subj_sd, jsubj_cfg)))
    return port, jax_side


def test_se_metrics_squim_slots_match_jax(predictors, monkeypatch):
    monkeypatch.delenv("VIBRAVOX_SQUIM_DIR", raising=False)
    (pobj, psubj), (jobj, jsubj) = predictors
    ours, theirs = SEMetrics(16000), JaxSEMetrics(16000)
    ours.squim_stoi, ours.noresqa_mos = metrics.TorchsquimSTOI(pobj), metrics.NoresqaMOS(predictor=psubj)
    theirs.squim_stoi, theirs.noresqa_mos = jmetrics.TorchsquimSTOI(jobj), jmetrics.NoresqaMOS(predictor=jsubj)
    rng = np.random.default_rng(7)

    def audio(b):
        return (0.1 * rng.standard_normal((b, 4800, 1))).astype(np.float32)

    steps = [("reference_free_first", {"enhanced": audio(2)}),
             ("reference", {"enhanced": audio(2), "reference": audio(2)}),
             ("reference_free", {"enhanced": audio(2)}),
             ("reference_free_tiled", {"enhanced": audio(3)})]
    want_keys = {"reference_free_first": {"torchsquim_stoi"},
                 "reference": {"torchmetrics_si_sdr", "torchmetrics_stoi", "torchsquim_stoi", "noresqa_mos"},
                 "reference_free": {"torchsquim_stoi", "noresqa_mos"},
                 "reference_free_tiled": {"torchsquim_stoi", "noresqa_mos"}}
    for name, batch in steps:
        got = ours({k: torch.from_numpy(v) for k, v in batch.items()})
        want = theirs({k: jnp.asarray(v) for k, v in batch.items()})
        assert set(got) == set(want) == want_keys[name], name
        assert all(_close(got[k], want[k]) for k in want), (name, got, want)
        assert all(isinstance(v, float) for v in got.values())
    assert np.array_equal(ours.first_sample, theirs.first_sample)
    for a, b in ((ours.squim_stoi, theirs.squim_stoi), (ours.noresqa_mos, theirs.noresqa_mos)):
        assert a.count == b.count and _close(a.compute(), b.compute())

    # update / compute accumulate as JAX's
    x, r = audio(2)[:, :, 0], audio(2)[:, :, 0]
    a, b = metrics.TorchsquimSTOI(pobj), jmetrics.TorchsquimSTOI(jobj)
    c, d = metrics.NoresqaMOS(predictor=psubj), jmetrics.NoresqaMOS(predictor=jsubj)
    for _ in range(2):
        a.update(torch.from_numpy(x))
        b.update(x)
        c.update(x, r)
        d.update(x, r)
    assert (a.count, c.count) == (b.count, d.count) == (2, 4)
    assert _close(a.compute(), b.compute()) and _close(c.compute(), d.compute())
    a.reset()
    with pytest.raises(metrics.MissingPretrainedPredictor):
        a.compute()


def test_full_width_objective_file_matches_jax_loader(tmp_path):
    model = squim.squim_objective_base(seed=0, device="cpu")
    torch.save(model.state_dict(), tmp_path / "squim_objective.pt")
    objective, subjective = metrics.load_squim_predictors(tmp_path, device="cpu")
    assert subjective is None and objective is not None
    apply_fn, loaded = objective
    assert next(loaded.parameters()).device == torch.device("cpu") and not loaded.training
    x = (0.1 * np.random.default_rng(8).standard_normal((1, 8000))).astype(np.float32)
    got = apply_fn(loaded, torch.from_numpy(x))
    japply, jparams = jmetrics.load_squim_objective(tmp_path / "squim_objective.pt")
    want = japply(jparams, x)
    assert got.shape == want.shape == (1,) and not got.requires_grad
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * float(np.abs(want).max())


def test_full_width_subjective_keys_are_consumed_by_jax():
    sd = squim.squim_subjective_base(seed=0, device="cpu").torchaudio_state_dict()
    assert all(k.startswith(("ssl_model.feature_extractor.", "ssl_model.encoder.feature_projection.",
                             "ssl_model.encoder.transformer.", "projector.", "predictor.")) for k in sd)
    params = jsquim.squim_subjective_params_from_torch({k: v.numpy() for k, v in sd.items()})
    audio = jnp.zeros((1, 16000))
    shapes = jax.eval_shape(jsquim.squim_subjective_base().init, jax.random.key(0), audio, audio)
    # the converter adds the backbone's unused CTC head and mask embedding
    ssl = {k: v for k, v in params["params"]["ssl"].items() if k not in ("lm_head", "masked_spec_embed")}
    got = jax.tree_util.tree_map(np.shape, {**params["params"], "ssl": ssl})
    assert got == jax.tree_util.tree_map(lambda s: s.shape, shapes["params"])


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_empty_squim_dir_gives_no_slots(tmp_path, monkeypatch, how):
    if how == "environment":
        monkeypatch.setenv("VIBRAVOX_SQUIM_DIR", str(tmp_path))
        pair = SEMetrics(16000), JaxSEMetrics(16000)
    else:
        monkeypatch.delenv("VIBRAVOX_SQUIM_DIR", raising=False)
        pair = SEMetrics(16000, squim_dir=str(tmp_path)), JaxSEMetrics(16000, squim_dir=str(tmp_path))
    for se in pair:
        assert se.squim_stoi is None and se.noresqa_mos is None
    assert metrics.load_squim_predictors(tmp_path) == (None, None)


def test_compute_with_nothing_accumulated_raises():
    for metric in (metrics.TorchsquimSTOI(), metrics.NoresqaMOS()):
        with pytest.raises(metrics.MissingPretrainedPredictor, match="no accumulated values"):
            metric.compute()
    with pytest.raises(metrics.MissingPretrainedPredictor, match="VIBRAVOX_SQUIM_DIR"):
        metrics.TorchsquimSTOI()(np.zeros((1, 800), np.float32))
    with pytest.raises(ValueError, match="16 kHz"):
        metrics.NoresqaMOS(sample_rate=8000)
