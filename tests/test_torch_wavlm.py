"""PyTorch port: WavLM-CTC (``models/wavlm.py``) against the plain reference
``portbench/reference/wavlm.py``, which imports nothing of the port.

The tiny preset (``TINY_WAVLM_CONFIG``: 3 pre-norm layers of 32, 2 heads,
32 buckets reaching 20 frames) on seeded random weights, on 1 s and 0.8 s
of audio (49 frames, past the bucket clamp), with every random part on
(dropouts, SpecAugment's time and feature spans, LayerDrop), so both sides
draw the same masks from the same (seed, step) generator.  The JAX package
has no WavLM; the reference is written from the layer equations.

Tolerances: logits within 1e-5 of their largest magnitude, the loss 1e-5
relative, each leaf's gradient within 1e-4 of its norm plus 1e-6 of the
largest leaf's (the two sides sum in other orders: SDPA against an explicit
softmax, the gate's product on another layout; measured: logits 3.9e-7,
the worst leaf 1.9e-5); a
key bias's gradient, 0 but for float32 noise (softmax ignores a shift
common to all keys), within 1e-6 of the largest.  Three SGD steps (lr
1e-3, so an update is proportional to its gradient, as in
``test_torch_stp_task.py``): the first loss 1e-5 relative, the next 1e-4,
and each parameter within 1e-2 of its step's update.
"""

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import wavlm as ref  # noqa: E402
from portbench.reference.common import Precision  # noqa: E402
from portbench.reference.wav2vec2 import ctc_mean_loss  # noqa: E402
from vibravox_tpu_torch.core.optim import sgd  # noqa: E402
from vibravox_tpu_torch.models import wavlm  # noqa: E402
from vibravox_tpu_torch.models.wav2vec2 import wav2vec2_for_ctc_from_config  # noqa: E402
from vibravox_tpu_torch.models.wavlm import (  # noqa: E402
    TINY_WAVLM_CONFIG,
    relative_position_bucket,
    wavlm_for_ctc_from_config,
    wavlm_for_ctc_from_pretrained,
)
from vibravox_tpu_torch.parallel.tp import ModelShard, shard_transformer_, transformer_tp_spec  # noqa: E402
from vibravox_tpu_torch.tasks.wav2vec2_stp import Wav2Vec2STPTask, step_generator  # noqa: E402
from torch_support import one_thread  # noqa: E402,F401  (autouse: torch on one thread)

NOISY = dict(hidden_dropout=0.1, activation_dropout=0.1, feat_proj_dropout=0.1, layerdrop=0.3,
             mask_time_prob=0.05, mask_feature_prob=0.25, mask_feature_length=4)
SEED = 2**31 + 11


def _model(seed=0, **kw):
    return wavlm_for_ctc_from_config(preset="tiny", seed=seed, device="cpu", **{**NOISY, **kw})


def _ref_cfg(model):
    return ref.WavLMRefConfig.of(dataclasses.asdict(model.config))


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def batch():
    gen = torch.Generator().manual_seed(3)
    audio = torch.randn(2, 16000, generator=gen)
    audio[1, 12800:] = 0.0
    labels = torch.randint(0, 33, (2, 12), generator=gen)
    labels[1, 7:] = -100
    return {"audio": audio, "phonemes_ids": labels}


def test_bucket_function_against_a_hand_written_table():
    """(r, bucket) at the published 320 buckets / 800 frames and the tiny
    preset's 32 / 20: exact below a quarter of the buckets, logarithmic
    after (80 + floor(80 log10(|r| / 80)) at 320 / 800), clamped past the
    reach, the upper half for r > 0."""
    table = {
        (320, 800): [(0, 0), (1, 161), (-1, 1), (79, 239), (-79, 79), (80, 240), (-80, 80), (100, 247), (-100, 87),
                     (160, 264), (200, 271), (-400, 135), (799, 319), (800, 319), (-800, 159), (998, 319),
                     (-998, 159)],
        (32, 20): [(0, 0), (3, 19), (-7, 7), (8, 24), (-10, 9), (19, 31), (20, 31), (-20, 15), (48, 31), (-48, 15)],
    }
    for (buckets, reach), pairs in table.items():
        r = torch.tensor([p[0] for p in pairs])
        want = torch.tensor([p[1] for p in pairs])
        assert torch.equal(relative_position_bucket(r, buckets, reach), want), (buckets, reach)
        assert torch.equal(ref.bucket(r, buckets, reach), want), (buckets, reach)
    full = torch.arange(-998, 999)
    assert torch.equal(relative_position_bucket(full, 320, 800), ref.bucket(full, 320, 800))


def test_logits_loss_and_every_gradient_match_the_reference(batch):
    model = _model()
    cfg = _ref_cfg(model)
    t = cfg.frames(batch["audio"].shape[1])
    assert t > model.config.max_bucket_distance  # the clamp is in the table
    task = Wav2Vec2STPTask(wav2vec2_for_ctc=model, optimizer=sgd(1e-3), device="cpu")
    logits = model(batch["audio"], train=True, generator=step_generator(SEED, 0, torch.device("cpu")),
                   freeze_feature_encoder=True)
    loss = task._ctc_loss(logits, batch["phonemes_ids"])
    trainable = {n: p for n, p in model.named_parameters() if not n.startswith("wavlm.feature_extractor.")}
    got = dict(zip(trainable, torch.autograd.grad(loss, list(trainable.values()))))

    params = _params(model)
    for n in trainable:
        params[n].requires_grad_(True)
    want_logits = ref.forward(params, cfg, batch["audio"], Precision(),
                              step_generator(SEED, 0, torch.device("cpu")))
    want_loss = ctc_mean_loss(want_logits, batch["phonemes_ids"], cfg.pad_token_id)
    want = dict(zip(trainable, torch.autograd.grad(want_loss, [params[n] for n in trainable])))

    assert logits.shape == (2, t, 38)
    scale = float(want_logits.detach().abs().max())
    assert float((logits - want_logits).detach().abs().max()) <= 1e-5 * scale
    assert abs(float(loss.detach()) - float(want_loss.detach())) <= 1e-5 * abs(float(want_loss.detach()))
    largest = max(float(g.norm()) for g in want.values())
    for n, g in want.items():
        err = float((got[n] - g).norm())
        if n.endswith("attention.k_proj.bias"):
            assert max(float(g.norm()), err) <= 1e-6 * largest, n
        else:
            assert err <= 1e-4 * float(g.norm()) + 1e-6 * largest, n
    # the gate trains in every layer that LayerDrop kept, layer 0 among them
    kept = [i for i in range(3) if float(want[f"wavlm.encoder.layers.{i}.attention.out_proj.weight"].norm()) > 0]
    assert kept[0] == 0 and len(kept) >= 2
    for i in kept:
        for n in ("gru_rel_pos_linear.weight", "gru_rel_pos_const"):
            assert float(want[f"wavlm.encoder.layers.{i}.attention.{n}"].norm()) > 0
    assert float(want["wavlm.encoder.layers.0.attention.rel_attn_embed.weight"].norm()) > 0


def test_three_sgd_steps_match_the_reference(batch):
    model = _model(seed=1)
    cfg = _ref_cfg(model)
    params = _params(model)
    reference = ref.WavLMReference(cfg, params, Precision(), 1e-3, (0.5, 0.9), SEED)
    task = Wav2Vec2STPTask(wav2vec2_for_ctc=model, optimizer=sgd(1e-3), device="cpu")
    state = task.init_state(SEED)
    for i in range(3):
        prev = {n: p.detach().clone() for n, p in params.items()}
        want_loss, grads = reference.gradients(batch["audio"], batch["phonemes_ids"],
                                               step_generator(SEED, i, torch.device("cpu")))
        with torch.no_grad():
            for n, g in grads.items():
                params[n] -= 1e-3 * g
        state, logs = task.train_step(state, batch)
        rel = 1e-5 if i == 0 else 1e-4
        want_loss = float(want_loss.detach())
        assert abs(float(logs["train/ctc_loss"]) - want_loss) <= rel * want_loss
        got = dict(model.named_parameters())
        for n, g in grads.items():
            update = float((params[n] - prev[n]).detach().norm())
            if n.endswith("attention.k_proj.bias"):
                continue  # its update is float32 noise on both sides (above)
            assert float((got[n] - params[n]).detach().norm()) <= 1e-2 * update + 1e-7, (i, n)
    assert all(torch.equal(p.detach(), params[n]) for n, p in model.named_parameters()
               if n.startswith("wavlm.feature_extractor."))


def test_layer_zero_is_never_dropped(batch):
    """LayerDrop 1 drops every layer but layer 0, which makes the position
    table: the features are a one-layer model's, in the program and the
    reference alike."""
    quiet = dict(hidden_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0, mask_time_prob=0.0,
                 mask_feature_prob=0.0)
    model = _model(seed=2, **quiet, layerdrop=1.0)
    one = _model(seed=2, **quiet, num_hidden_layers=1)
    one.load_state_dict({k: v for k, v in model.state_dict().items() if k in one.state_dict()}, strict=True)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        dropped = model(batch["audio"], train=True, generator=gen, return_features=True)
        assert torch.equal(dropped, one(batch["audio"], return_features=True))
        assert not torch.equal(dropped, model(batch["audio"], return_features=True))
        logits = ref.forward(_params(model), _ref_cfg(model), batch["audio"], Precision(),
                             torch.Generator().manual_seed(0))
        want = ref.forward(_params(one), _ref_cfg(one), batch["audio"], Precision(), None)
    assert torch.equal(logits, want)


def test_attention_calls_sdpa_with_the_gated_bias_and_wav2vec2_without_a_mask(batch, monkeypatch):
    calls = []
    sdpa = F.scaled_dot_product_attention

    def recorded(*args, **kwargs):
        calls.append((len(args), dict(kwargs)))
        return sdpa(*args, **kwargs)

    monkeypatch.setattr(F, "scaled_dot_product_attention", recorded)
    base = wav2vec2_for_ctc_from_config(preset="tiny", device="cpu")
    with torch.no_grad():
        base(batch["audio"])
    assert calls == [(3, {})] * base.config.num_hidden_layers

    calls.clear()
    before = wavlm.wavlm_attention.calls, wavlm.wavlm_attention.bias_elements
    model = _model()
    model(batch["audio"], train=True, generator=torch.Generator().manual_seed(0))
    t = _ref_cfg(model).frames(batch["audio"].shape[1])
    assert [c[0] for c in calls] == [3] * 3 and all(set(kw) == {"attn_mask"} for _, kw in calls)
    assert wavlm.wavlm_attention.calls - before[0] == 3
    assert wavlm.wavlm_attention.bias_elements - before[1] == 3 * 2 * 2 * t * t


def _save(model, directory: Path, base: bool) -> None:
    """HF's layout: ``config.json`` and ``pytorch_model.bin``; ``base``: a
    ``WavLMModel``'s checkpoint, unprefixed, with the old weight-norm names
    and no CTC head."""
    directory.mkdir(parents=True, exist_ok=True)
    cfg = {k: (list(v) if isinstance(v, tuple) else v) for k, v in dataclasses.asdict(model.config).items()}
    cfg["architectures"] = ["WavLMModel" if base else "WavLMForCTC"]
    (directory / "config.json").write_text(json.dumps(cfg))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    if base:
        sd = {k[len("wavlm."):]: v for k, v in sd.items() if k.startswith("wavlm.")}
        conv = "encoder.pos_conv_embed.conv"
        sd[f"{conv}.weight_g"] = sd.pop(f"{conv}.parametrizations.weight.original0")
        sd[f"{conv}.weight_v"] = sd.pop(f"{conv}.parametrizations.weight.original1")
    torch.save(sd, directory / "pytorch_model.bin")


def test_from_pretrained_round_trip_with_hf_names(tmp_path, batch):
    model = _model(seed=4)
    names = set(model.state_dict())
    layers = "wavlm.encoder.layers"
    assert {f"{layers}.0.attention.rel_attn_embed.weight", f"{layers}.2.attention.gru_rel_pos_const",
            f"{layers}.1.attention.gru_rel_pos_linear.bias", "lm_head.weight"} <= names
    assert not any("layers.1.attention.rel_attn_embed" in n for n in names)
    _save(model, tmp_path / "ctc", base=False)
    again = wavlm_for_ctc_from_pretrained(str(tmp_path / "ctc"), device="cpu")
    assert again.load_report == {"dropped": [], "initialised": []}
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in again.state_dict().items())
    _save(model, tmp_path / "base", base=True)
    base = wavlm_for_ctc_from_pretrained(str(tmp_path / "base"), device="cpu")
    assert base.load_report["initialised"] == ["lm_head.weight", "lm_head.bias"]
    with torch.no_grad():
        assert torch.equal(base(batch["audio"], return_features=True), model(batch["audio"], return_features=True))
    with pytest.raises(FileNotFoundError, match="never downloads"):
        wavlm_for_ctc_from_pretrained("microsoft/wavlm-large", device="cpu")


def test_tensor_parallelism_refuses_wavlm():
    model = _model()
    with pytest.raises(NotImplementedError, match="WavLM"):
        shard_transformer_(model, ModelShard(None, 2, 0))
    path = ("wavlm", "encoder", "layers", "0", "attention", "gru_rel_pos_linear", "kernel")
    with pytest.raises(NotImplementedError, match="WavLM"):
        transformer_tp_spec(path, (16, 8), 2)
    assert transformer_tp_spec(path, (16, 8), 1) == ()
    assert shard_transformer_(model, ModelShard(None, 1, 0)) == 0


def test_large_preset_is_the_published_width():
    cfg = wavlm.WavLMConfig()
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads, cfg.intermediate_size,
            cfg.num_buckets, cfg.max_bucket_distance, cfg.feat_extract_norm) == (1024, 24, 16, 4096, 320, 800, "layer")
    with torch.device("meta"):
        n = sum(p.numel() for p in wavlm.WavLMForCTC(cfg).parameters())
    assert 315e6 < n < 318e6
    assert TINY_WAVLM_CONFIG["max_bucket_distance"] < 49
