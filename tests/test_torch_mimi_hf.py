"""PyTorch port: the Mimi codec from an HF ``MimiModel`` state dict, without JAX.

A tiny randomly initialised ``transformers.MimiModel`` (its EMA codebook
buffers randomised, as ``tests/test_mimi.py`` does for the JAX converter)
converted with ``mimi_state_dict_from_hf`` and ``mimi_config_from_hf`` (the
``config.json`` as a plain dict), at the bars of ``tests/test_mimi.py``:
encoder latents within 1e-4, RVQ codes equal, the decode of HF's codes
within 1e-4; and the converter's refusal of a key it does not consume.
"""

import numpy as np
import pytest
import torch

from vibravox_tpu_torch.models.mimi.convert import mimi_config_from_hf, mimi_state_dict_from_hf
from vibravox_tpu_torch.models.mimi.mimi import MimiModule
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def converted():
    torch.manual_seed(0)
    hf_cfg = transformers.MimiConfig(
        sampling_rate=24000, hidden_size=32, num_filters=4, upsampling_ratios=[4, 2], num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=2, head_dim=16, intermediate_size=64, sliding_window=10,
        codebook_dim=16, vector_quantization_hidden_dimension=16, num_quantizers=4, codebook_size=64,
        compress=2, upsample_groups=32,
    )
    hf = transformers.MimiModel(hf_cfg).eval()
    with torch.no_grad():
        for q in (hf.quantizer.semantic_residual_vector_quantizer, hf.quantizer.acoustic_residual_vector_quantizer):
            for layer in q.layers:
                usage = torch.rand_like(layer.codebook.cluster_usage) + 0.5
                layer.codebook.cluster_usage.copy_(usage)
                layer.codebook.embed_sum.copy_(torch.randn_like(layer.codebook.embed_sum) * usage[:, None])
    config = mimi_config_from_hf(hf_cfg.to_dict())
    model = MimiModule(config).eval()
    model.load_state_dict(mimi_state_dict_from_hf(hf.state_dict(), config), strict=True)
    return hf, model


@pytest.fixture(scope="module")
def audio(converted):
    hop = converted[1].config.hop_length
    return torch.from_numpy(np.random.default_rng(1).standard_normal((2, 4 * hop)).astype(np.float32) * 0.3)


def test_config_from_hf_dict(converted):
    hf, model = converted
    cfg = model.config
    assert (cfg.dimension, cfg.n_filters, cfg.ratios, cfg.transformer_layers, cfg.sliding_window, cfg.rvq_n_q,
            cfg.rvq_codebook_size, cfg.downsample, cfg.hop_length) == (32, 4, (4, 2), 2, 10, 4, 64, 2, 16)
    bad = dict(hf.config.to_dict(), num_key_value_heads=1)
    with pytest.raises(ValueError, match="GQA"):
        mimi_config_from_hf(bad)
    with pytest.raises(ValueError, match="eps"):
        mimi_config_from_hf(dict(hf.config.to_dict(), norm_eps=1e-6))


def test_encoder_latents_match_hf(converted, audio):
    hf, model = converted
    with torch.no_grad():
        emb = hf.encoder(audio[:, None, :])
        emb = hf.encoder_transformer(emb.transpose(1, 2))[0].transpose(1, 2)
        want = hf.downsample(emb).transpose(1, 2)
        ours = model.encode_to_latent(audio[:, :, None])
    torch.testing.assert_close(ours, want, atol=1e-4, rtol=0)


def test_rvq_codes_match_hf(converted, audio):
    hf, model = converted
    with torch.no_grad():
        want = hf.encode(audio[:, None, :]).audio_codes  # (B, n_q, T')
        ours = model.encode(audio[:, :, None])  # (n_q, B, T')
    assert torch.equal(ours, want.transpose(0, 1))


def test_decode_matches_hf(converted, audio):
    hf, model = converted
    with torch.no_grad():
        codes = hf.encode(audio[:, None, :]).audio_codes
        want = hf.decode(codes).audio_values[:, 0, :]
        ours = model.decode(codes.transpose(0, 1))[:, :, 0]
    torch.testing.assert_close(ours, want, atol=1e-4, rtol=0)


def test_converter_refuses_unconsumed_keys(converted):
    hf, model = converted
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    sd["surprise.weight"] = np.zeros((1,), np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        mimi_state_dict_from_hf(sd, model.config)
