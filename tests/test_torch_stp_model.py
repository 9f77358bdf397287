"""PyTorch port: the wav2vec2-CTC model against the JAX package.

Two configurations: ``TINY_W2V2_CONFIG`` (the base layout: GroupNorm after
conv 0, no conv bias, an even positional kernel, 16) and a variant with a
LayerNorm after every conv, conv biases and an odd positional kernel (15).
The JAX params (random, seed 0) go through the port's converter and load
with ``strict=True``; the inputs are (2, 8000) float32 from a numpy seed.

Tolerances, relative to the largest reference value ("of scale"):
* eval logits and ``return_features`` in float32: 1e-5;
* eval logits with ``compute_dtype="bfloat16"``: 2e-2 (bf16 has 8 bits of
  mantissa; the two sides round at the same points but sum in other orders);
* every parameter's gradient of the task's mean CTC loss, with the feature
  encoder frozen and not: 1e-4 of the largest entry over all gradients;
* SpecAugment: the port's span expansion equals JAX's given the same
  starts, and the masked share of a train forward is held statistically.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vibravox_tpu.models.wav2vec2 import Wav2Vec2ForCTCModule, _compute_span_mask
from vibravox_tpu.models.wav2vec2 import wav2vec2_params_to_torch
from vibravox_tpu.tasks.wav2vec2_stp import Wav2Vec2STPTask as JaxSTPTask
from vibravox_tpu_torch.core.optim import adam
from vibravox_tpu_torch.models.convert import wav2vec2_state_dict_from_jax
from vibravox_tpu_torch.models.wav2vec2 import span_mask, span_starts, wav2vec2_for_ctc_from_config
from vibravox_tpu_torch.tasks.wav2vec2_stp import Wav2Vec2STPTask
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

CONFIGS = {
    "tiny": {},
    "layer_norm_bias_odd_kernel": dict(feat_extract_norm="layer", conv_bias=True, num_conv_pos_embeddings=15),
}


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _jax_model(seed=0, **kw):
    """The JAX factory's model, its params initialised under ``jax.jit``
    (the eager init dispatches op by op)."""
    from vibravox_tpu.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC

    cfg = Wav2Vec2Config(**kw)
    module = Wav2Vec2ForCTCModule(cfg)
    params = jax.jit(lambda k: module.init({"params": k}, jnp.zeros((1, 4000)), train=False)["params"])(
        jax.random.key(seed))
    return Wav2Vec2ForCTC(cfg, params=params)


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(JAX model, port model with the JAX params, JAX params as numpy)."""
    from vibravox_tpu.models.wav2vec2 import TINY_W2V2_CONFIG

    jm = _jax_model(**{**TINY_W2V2_CONFIG, **CONFIGS[request.param]})
    params = jax.device_get(jm.params)
    tm = wav2vec2_for_ctc_from_config(preset="tiny", device="cpu", **CONFIGS[request.param])
    tm.load_state_dict(wav2vec2_state_dict_from_jax(params, jm.config), strict=True)
    return jm, tm, params


@pytest.fixture(scope="module")
def audio():
    return np.random.default_rng(0).standard_normal((2, 8000)).astype(np.float32) * 0.3


@pytest.fixture(scope="module")
def labels():
    """(2, 12) phoneme ids padded with -100, 9 and 6 of them (a repeat in
    the first), feasible in the 24 frames of 8000 samples."""
    lab = np.full((2, 12), -100, np.int32)
    lab[0, :9] = [3, 7, 7, 12, 0, 33, 20, 5, 9]
    lab[1, :6] = [1, 2, 33, 4, 30, 32]
    return lab


def _with_dtype(jm, dtype):
    cfg = dataclasses.replace(jm.config, compute_dtype=dtype)
    return Wav2Vec2ForCTCModule(cfg)


def test_state_dict_keys_are_the_jax_converters(pair):
    jm, tm, params = pair
    assert set(tm.state_dict()) == set(wav2vec2_params_to_torch(params, jm.config))


def test_eval_logits_match_jax(pair, audio):
    jm, tm, params = pair
    want = np.asarray(jax.jit(jm.module.apply)({"params": params}, jnp.asarray(audio)))
    with torch.no_grad():
        got = tm(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (2, jm.config.feat_extract_output_length(8000), 38)
    assert got.dtype == np.float32
    assert _rel(got, want) <= 1e-5


def test_return_features_match_jax(pair, audio):
    jm, tm, params = pair
    want = np.asarray(jax.jit(lambda p, x: jm.module.apply({"params": p}, x, return_features=True))(
        params, jnp.asarray(audio)))
    with torch.no_grad():
        got = tm(torch.from_numpy(audio), return_features=True).numpy()
    assert got.shape == want.shape == (2, 24, jm.config.hidden_size)
    assert _rel(got, want) <= 1e-5


def test_bfloat16_logits_match_jax(pair, audio):
    jm, tm, params = pair
    want = np.asarray(jax.jit(_with_dtype(jm, "bfloat16").apply)({"params": params}, jnp.asarray(audio)))
    cfg = tm.config
    tm.config = dataclasses.replace(cfg, compute_dtype="bfloat16")
    try:
        with torch.no_grad():
            got = tm(torch.from_numpy(audio))
    finally:
        tm.config = cfg
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 2e-2


@pytest.mark.parametrize("freeze", [True, False])
def test_mean_ctc_gradients_match_jax(pair, audio, labels, freeze):
    jm, tm, params = pair
    jtask = JaxSTPTask(wav2vec2_for_ctc=jm, optimizer=optax.sgd(1e-2), freeze_feature_encoder=freeze)

    def loss_fn(p):
        return jtask._ctc_loss(jtask._forward(p, jnp.asarray(audio), train=False), jnp.asarray(labels))

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = wav2vec2_state_dict_from_jax(jax.device_get(grads), jm.config)

    task = Wav2Vec2STPTask(wav2vec2_for_ctc=tm, optimizer=adam(), freeze_feature_encoder=freeze, device="cpu")
    tm.zero_grad(set_to_none=True)
    loss = task._ctc_loss(task._forward(torch.from_numpy(audio), train=False), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    # the weight-norm gain and direction of the port are the JAX params, so
    # their gradients compare entry for entry
    got = {k: p.grad for k, p in tm.named_parameters()}
    scale = max(float(v.abs().max()) for v in want.values())
    encoder = [k for k in got if ".feature_extractor." in k]
    assert encoder
    for k, g in want.items():
        if freeze and k in encoder:
            assert got[k] is None and float(g.abs().max()) == 0.0, k
            continue
        if k == "wav2vec2.masked_spec_embed":  # not on the eval path
            assert got[k] is None and float(g.abs().max()) == 0.0
            continue
        assert float((got[k] - g).abs().max()) <= 1e-4 * scale, k
    tm.zero_grad(set_to_none=True)


@pytest.mark.parametrize("batch,length,prob,span,min_masks", [
    (8, 149, 0.05, 10, 2),      # the recipe's time mask: 3 s at the base stack
    (8, 768, 0.1024, 64, 0),    # the recipe's feature mask over the base width
    (4, 50, 0.5, 5, 1),         # many overlapping spans
])
def test_span_mask_equals_jax_given_its_starts(batch, length, prob, span, min_masks):
    """The port draws the same number of spans in the same range as JAX, and
    expands JAX's starts into JAX's mask."""
    rng = jax.random.key(3)
    want = np.asarray(_compute_span_mask(rng, (batch, length), prob, span, min_masks))
    num_spans = max(min_masks, int(prob * length / span))
    jax_starts = np.array(jax.random.randint(rng, (batch, num_spans), 0, length - span))
    assert np.array_equal(span_mask(torch.from_numpy(jax_starts), length, span).numpy(), want)
    starts = span_starts(torch.Generator().manual_seed(0), batch, length, prob, span, min_masks, "cpu")
    assert starts.shape == (batch, num_spans)
    assert int(starts.min()) >= 0 and int(starts.max()) < length - span
    assert span_starts(torch.Generator(), batch, span, prob, span, min_masks, "cpu") is None


def test_spec_augment_masks_at_jax_rates():
    """Masked shares of a train forward's SpecAugment over many draws, port
    and JAX alike, against each other (2% absolute) at the recipe's time mask
    and a wide feature mask: the starts are uniform in both, so the rates
    agree though the streams differ."""
    length, width, n = 149, 256, 400
    gen = torch.Generator().manual_seed(1)
    t_port = np.mean([span_mask(span_starts(gen, 8, length, 0.05, 10, 2, "cpu"), length, 10).float().mean()
                      for _ in range(n)])
    f_port = np.mean([span_mask(span_starts(gen, 8, width, 0.1024, 16, 0, "cpu"), width, 16).float().mean()
                      for _ in range(n)])
    keys = jax.random.split(jax.random.key(1), 2 * n)
    t_jax = np.mean([np.asarray(_compute_span_mask(k, (8, length), 0.05, 10, 2)).mean() for k in keys[:n]])
    f_jax = np.mean([np.asarray(_compute_span_mask(k, (8, width), 0.1024, 16, 0)).mean() for k in keys[n:]])
    assert abs(t_port - t_jax) < 0.02 and abs(f_port - f_jax) < 0.02
    assert 0.10 < t_port < 0.14 and 0.05 < f_port < 0.07


def test_train_forward_draws_from_its_generator(pair, audio):
    """Dropout, SpecAugment and layerdrop come from the generator given:
    the same seed gives the same logits, another seed others, and eval
    ignores it; with every random part off a train forward is the eval
    forward."""
    _, tm, _ = pair
    cfg = tm.config
    x = torch.from_numpy(audio)
    tm.config = dataclasses.replace(cfg, layerdrop=0.5, mask_feature_prob=0.2, mask_feature_length=4)
    try:
        with torch.no_grad():
            a = tm(x, train=True, generator=torch.Generator().manual_seed(5))
            b = tm(x, train=True, generator=torch.Generator().manual_seed(5))
            c = tm(x, train=True, generator=torch.Generator().manual_seed(6))
            e = tm(x)
            tm.config = dataclasses.replace(cfg, hidden_dropout=0.0, activation_dropout=0.0,
                                            feat_proj_dropout=0.0, apply_spec_augment=False)
            quiet = tm(x, train=True, generator=torch.Generator().manual_seed(5))
    finally:
        tm.config = cfg
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, e)
    assert torch.equal(quiet, e)


def test_dropout_and_layerdrop_rates():
    """A train forward's dropout keeps 1 - p of the entries, scaled by
    1 / (1 - p); layerdrop keeps a layer with probability 1 - p."""
    from vibravox_tpu_torch.models.wav2vec2 import _dropout

    gen = torch.Generator().manual_seed(0)
    y = _dropout(torch.ones(200_000), 0.1, gen)
    kept = float((y > 0).float().mean())
    assert abs(kept - 0.9) < 0.005 and torch.allclose(y[y > 0], torch.tensor(1 / 0.9))
    gates = torch.rand(20_000, generator=gen) >= 0.05
    assert abs(float(gates.float().mean()) - 0.95) < 0.005
    assert torch.equal(_dropout(torch.ones(4), 0.1, None), torch.ones(4))


def test_random_init_follows_the_jax_initialisers():
    """At a quarter of the base width, the base layout (seed 0 on both
    sides): the same parameter count, and each family's standard deviation
    within 2% of JAX's."""
    kw = dict(hidden_size=192, intermediate_size=768, num_hidden_layers=4, num_attention_heads=3,
              conv_dim=(128,) * 7)
    params = jax.device_get(_jax_model(**kw).params)
    tm = wav2vec2_for_ctc_from_config(seed=0, device="cpu", **kw)
    assert sum(v.size for v in jax.tree_util.tree_leaves(params)) == sum(p.numel() for p in tm.parameters())
    pos = tm.wav2vec2.encoder.pos_conv_embed.conv.parametrizations.weight
    pairs = [
        (params["layer_0"]["q_proj"]["kernel"], tm.wav2vec2.encoder.layers[0].attention.q_proj.weight),
        (params["layer_3"]["intermediate_dense"]["kernel"],
         tm.wav2vec2.encoder.layers[3].feed_forward.intermediate_dense.weight),
        (params["feature_encoder"]["conv_0"]["kernel"], tm.wav2vec2.feature_extractor.conv_layers[0].conv.weight),
        (params["feature_encoder"]["conv_3"]["kernel"], tm.wav2vec2.feature_extractor.conv_layers[3].conv.weight),
        (params["pos_conv_embed"]["conv_v"], pos.original1),
        (params["lm_head"]["kernel"], tm.lm_head.weight),
    ]
    for want, got in pairs:
        assert abs(float(got.detach().std()) / float(np.std(want)) - 1) < 0.02
    np.testing.assert_allclose(pos.original0.detach().numpy().reshape(-1),
                               np.linalg.norm(pos.original1.detach().numpy(), axis=(0, 1)), rtol=1e-5)
    embed = tm.wav2vec2.masked_spec_embed.detach()
    assert 0 <= float(embed.min()) and float(embed.max()) < 1
