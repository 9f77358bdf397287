"""PyTorch port: the Mimi codec against the JAX package.

The SEANet convs (causal padding at lengths that are no multiple of the
stride, dilations 1 and 2, edge padding, the depthwise transposed conv),
RoPE and a transformer layer whose sliding window (4) is shorter than its
13 frames, the SEANet encoder and decoder, the split RVQ, and the whole
codec at the ``tiny`` preset from the same params (JAX's, through
``mimi_state_dict_from_jax``); then the published ``MimiConfig()``'s
parameter shapes against ``jax.eval_shape`` and the port's initialisers
against flax's.  Inputs come from numpy seeds; JAX runs under ``jax.jit``
on the CPU.

Tolerances (float32 unless said): single layers 1e-5 of their output's
scale; RVQ codes equal and the quantized output 1e-5 of scale;
``encode_to_latent`` 1e-5 of scale (measured 4.7e-7), ``decode`` and
``decode_latent`` 1e-4 (3.8e-7).  The bf16 path against JAX's bf16 path,
1e-2 of scale (measured 2.0e-3 for the latents, 6.2e-3 decoded): both
round the same casts, but PyTorch adds a conv's bias inside the conv where
flax adds it after, in bf16, and the two sum in other orders.  Initial
kernels: each standard deviation within 10% of flax's truncated
``lecun_normal`` (1 / sqrt(fan_in) over flax's fan-in).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibravox_tpu.models.mimi import rvq as jax_rvq
from vibravox_tpu.models.mimi import seanet as jax_seanet
from vibravox_tpu.models.mimi import transformer as jax_transformer
from vibravox_tpu.models.mimi.mimi import MimiConfig as JaxMimiConfig
from vibravox_tpu.models.mimi.mimi import MimiModule as JaxMimiModule
from vibravox_tpu.models.mimi.mimi import _tiny_config
from vibravox_tpu_torch.models.mimi.convert import mimi_state_dict_from_jax
from vibravox_tpu_torch.models.mimi.mimi import ENCODER_SIDE, Mimi, MimiConfig, MimiModule, tiny_config
from vibravox_tpu_torch.models.mimi.rvq import SplitResidualVectorQuantizer
from vibravox_tpu_torch.models.mimi.seanet import CausalConv, CausalConvTranspose
from vibravox_tpu_torch.models.mimi.transformer import TransformerLayer, rope
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _scale_err(ours, ref):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _jax_init(module, x):
    params = jax.jit(module.init)(jax.random.key(0), x)
    return jax.device_get(params)


def _conv_weight(node):
    return torch.from_numpy(np.array(np.transpose(node["kernel"], (2, 1, 0))))


def _load_conv(conv, node, transposed=False):
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.array(node["kernel"])) if transposed else _conv_weight(node))
        if conv.bias is not None:
            conv.bias.copy_(torch.from_numpy(np.array(node["bias"])))
    return conv


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny codec (seed 0) as numpy params and the port's with them."""
    cfg = _tiny_config()
    params = _jax_init(JaxMimiModule(cfg), jnp.zeros((1, 4 * cfg.hop_length, 1)))
    model = MimiModule(tiny_config())
    model.load_state_dict(mimi_state_dict_from_jax(params, model.config), strict=True)
    return params, model.eval()


def _jax_method(cfg, method):
    return jax.jit(lambda p, x: JaxMimiModule(cfg).apply(p, x, method=method))


@pytest.mark.parametrize("kernel,stride,dilation,length,pad_mode,bias", [
    (7, 1, 1, 37, "zeros", True),     # the stems
    (3, 1, 2, 37, "zeros", True),     # a dilated residual conv
    (8, 4, 1, 37, "zeros", True),     # a downsampling conv, 37 no multiple of 4
    (10, 5, 1, 53, "zeros", True),
    (4, 2, 1, 21, "replicate", False),  # the codec's downsample
    (1, 1, 1, 9, "zeros", True),
])
def test_causal_conv_matches_jax(kernel, stride, dilation, length, pad_mode, bias):
    x = _np(kernel + length, (2, length, 6))
    jmod = jax_seanet.CausalConv(5, kernel, stride=stride, dilation=dilation, use_bias=bias, pad_mode=pad_mode)
    params = _jax_init(jmod, jnp.asarray(x))
    if bias:  # flax initialises biases at 0; exercise them
        params["params"]["bias"] = _np(1, (5,))
    ref = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    conv = _load_conv(CausalConv(6, 5, kernel, stride, dilation, bias=bias, pad_mode=pad_mode), params["params"])
    with torch.no_grad():
        ours = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert ours.shape == ref.shape == (2, -(-length // stride), 5)
    assert _scale_err(ours, ref) <= 1e-5


@pytest.mark.parametrize("kernel,stride,channels,groups,bias", [
    (8, 4, (6, 4), 1, True), (12, 6, (4, 6), 1, True), (4, 2, (6, 6), 6, False)])  # last: the upsample
def test_causal_conv_transpose_matches_jax(kernel, stride, channels, groups, bias):
    cin, cout = channels
    x = _np(kernel, (2, 9, cin))
    jmod = jax_seanet.CausalConvTranspose(cout, kernel, stride=stride, groups=groups, use_bias=bias)
    params = _jax_init(jmod, jnp.asarray(x))
    if bias:
        params["params"]["bias"] = _np(2, (cout,))
    ref = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    conv = _load_conv(CausalConvTranspose(cin, cout, kernel, stride, groups, bias), params["params"], transposed=True)
    with torch.no_grad():
        ours = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert ours.shape == ref.shape == (2, 9 * stride, cout)
    assert _scale_err(ours, ref) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    q, k = _np(3, (2, 13, 2, 8)), _np(4, (2, 13, 2, 8))
    jdt = jnp.dtype(dtype)
    ref = jax.jit(jax_transformer._rope)(jnp.asarray(q, jdt), jnp.asarray(k, jdt))
    ours = rope(torch.from_numpy(q).to(getattr(torch, dtype)), torch.from_numpy(k).to(getattr(torch, dtype)))
    for a, b in zip(ours, ref):
        assert a.dtype == getattr(torch, dtype)
        assert _scale_err(a.float().numpy(), np.asarray(b, np.float32)) <= (1e-6 if dtype == "float32" else 1e-2)


def _transformer_sd(node):
    sd = {}
    for name, leaf in node.items():
        if name.startswith("layer_scale"):
            sd[name] = leaf
        elif "kernel" in leaf:
            sd[f"{name}.weight"] = leaf["kernel"].T
        else:
            sd[f"{name}.weight"], sd[f"{name}.bias"] = leaf["scale"], leaf["bias"]
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@pytest.mark.parametrize("window", [4, None])
def test_transformer_layer_matches_jax_with_a_sliding_window(window):
    """13 frames against a window of 4: the band masks keys 4 or more frames
    back, which the window-None case shows changes the output."""
    x = _np(5, (2, 13, 16))
    jmod = jax_transformer.TransformerLayer(16, 2, 32, sliding_window=window)
    params = _jax_init(jmod, jnp.asarray(x))
    # layer scales of 1 and random norms, so attention and feed-forward show
    rng = np.random.default_rng(6)
    for name in ("layer_scale_1", "layer_scale_2"):
        params["params"][name] = np.ones(16, np.float32)
    for name in ("norm1", "norm2"):
        params["params"][name] = {"scale": (rng.random(16) + 0.5).astype(np.float32),
                                  "bias": (rng.standard_normal(16) * 0.1).astype(np.float32)}
    ref = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    layer = TransformerLayer(16, 2, 32, sliding_window=window)
    layer.load_state_dict(_transformer_sd(params["params"]), strict=True)
    with torch.no_grad():
        ours = layer(torch.from_numpy(x)).numpy()
        full = TransformerLayer(16, 2, 32, sliding_window=None)
        full.load_state_dict(layer.state_dict())
        unbanded = full(torch.from_numpy(x)).numpy()
    assert _scale_err(ours, ref) <= 1e-5
    if window is not None:
        assert _scale_err(unbanded, ref) > 1e-2


@pytest.mark.parametrize("length", [128, 131])
def test_seanet_encoder_and_decoder_match_jax(tiny, length):
    params, model = tiny
    x = _np(7, (2, length, 1))
    jenc = jax_seanet.SEANetEncoder(dimension=32, n_filters=4, ratios=(4, 2))
    ref = np.asarray(jax.jit(jenc.apply)({"params": params["params"]["encoder"]}, jnp.asarray(x)))
    z = _np(8, (2, 9, 32))
    jdec = jax_seanet.SEANetDecoder(dimension=32, n_filters=4, ratios=(4, 2))
    ref_dec = np.asarray(jax.jit(jdec.apply)({"params": params["params"]["decoder"]}, jnp.asarray(z)))
    with torch.no_grad():
        ours = model.encoder(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
        ours_dec = model.decoder(torch.from_numpy(z).transpose(1, 2)).transpose(1, 2).numpy()
    assert ours.shape == ref.shape == (2, -(-length // 8), 32)
    assert _scale_err(ours, ref) <= 1e-5
    assert ours_dec.shape == ref_dec.shape == (2, 72, 1)
    assert _scale_err(ours_dec, ref_dec) <= 1e-5


def test_split_rvq_matches_jax(tiny):
    params, model = tiny
    x = _np(9, (2, 8, 32), 3.0)
    jq = jax_rvq.SplitResidualVectorQuantizer(16, 32, 32, 4, 64)
    node = {"params": params["params"]["quantizer"]}
    ref_q, ref_codes = jax.jit(jq.apply)(node, jnp.asarray(x))
    ref_dec = jax.jit(lambda p, c: jq.apply(p, c, method="decode"))(node, ref_codes)
    assert isinstance(model.quantizer, SplitResidualVectorQuantizer)
    with torch.no_grad():
        q, codes = model.quantizer(torch.from_numpy(x))
        dec = model.quantizer.decode(codes)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    assert len(np.unique(codes.numpy())) > 8  # many codes in use
    assert _scale_err(q.numpy(), ref_q) <= 1e-5 and _scale_err(dec.numpy(), ref_dec) <= 1e-5


def test_codec_matches_jax(tiny):
    params, model = tiny
    cfg = _tiny_config()
    x = _np(10, (2, 8 * cfg.hop_length, 1), 0.3)
    latent = np.array(_jax_method(cfg, "encode_to_latent")(params, jnp.asarray(x)))
    codes = np.array(_jax_method(cfg, "encode")(params, jnp.asarray(x)))
    decoded = np.asarray(_jax_method(cfg, "decode")(params, jnp.asarray(codes)))
    round_trip = np.asarray(_jax_method(cfg, "decode_latent")(params, jnp.asarray(latent)))
    quantized = np.asarray(_jax_method(cfg, "quantize_latent")(params, jnp.asarray(latent)))
    with torch.no_grad():
        ours = model.encode_to_latent(torch.from_numpy(x))
        ours_codes = model.encode(torch.from_numpy(x))
        ours_dec = model.decode(torch.from_numpy(codes))
        ours_rt = model.decode_latent(torch.from_numpy(latent))
        ours_q = model.quantize_latent(torch.from_numpy(latent))
        whole = model(torch.from_numpy(x))
    assert ours.dtype == torch.float32 and ours.shape == (2, 8, 32)
    assert _scale_err(ours.numpy(), latent) <= 1e-5
    np.testing.assert_array_equal(ours_codes.numpy(), codes)
    assert _scale_err(ours_q.numpy(), quantized) <= 1e-5
    assert ours_dec.shape == (2, 8 * cfg.hop_length, 1)
    assert _scale_err(ours_dec.numpy(), decoded) <= 1e-4 and _scale_err(ours_rt.numpy(), round_trip) <= 1e-4
    assert _scale_err(whole.numpy(), round_trip) <= 1e-4


def test_bf16_codec_matches_jax_bf16(tiny):
    params, model = tiny
    cfg16 = dataclasses.replace(_tiny_config(), compute_dtype="bfloat16")
    x = _np(11, (2, 8 * cfg16.hop_length, 1), 0.3)
    latent = np.array(_jax_method(cfg16, "encode_to_latent")(params, jnp.asarray(x)))
    round_trip = np.asarray(_jax_method(cfg16, "decode_latent")(params, jnp.asarray(latent)))
    model16 = MimiModule(dataclasses.replace(model.config, compute_dtype="bfloat16"))
    model16.load_state_dict(model.state_dict())
    with torch.no_grad():
        ours = model16.encode_to_latent(torch.from_numpy(x))
        ours_rt = model16.decode_latent(torch.from_numpy(latent))
        f32 = model.encode_to_latent(torch.from_numpy(x)).numpy()
    assert ours.dtype == torch.float32 and ours_rt.dtype == torch.float32
    assert _scale_err(ours.numpy(), latent) <= 1e-2 and _scale_err(ours_rt.numpy(), round_trip) <= 1e-2
    assert _scale_err(ours.numpy(), f32) > 1e-4  # it did run in bf16


@pytest.fixture(scope="module")
def full_shapes():
    """The published codec's parameter shapes (JAX layout), traced, not made."""
    shapes = jax.eval_shape(lambda k: JaxMimiModule(JaxMimiConfig()).init(k, jnp.zeros((1, 4 * 1920, 1))),
                            jax.random.key(0))
    return dict(jax.tree_util.tree_flatten_with_path(shapes["params"])[0])


def test_full_width_shapes_match_jax(full_shapes):
    """``MimiConfig()`` at full width: every JAX leaf converts to a port key
    of the right shape and none is left over; 96.09 M parameters, 38.87 M
    of them on the encoder side."""
    zeros = {}
    for path, leaf in full_shapes.items():
        node = zeros
        for key in path[:-1]:
            node = node.setdefault(key.key, {})
        node[path[-1].key] = np.broadcast_to(np.float32(0), leaf.shape)
    with torch.device("meta"):
        model = MimiModule(MimiConfig())
    sd = mimi_state_dict_from_jax({"params": zeros}, model.config)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    total = sum(p.numel() for p in model.parameters())
    assert total == sum(math.prod(leaf.shape) for leaf in full_shapes.values())
    trainable = sum(p.numel() for name in ENCODER_SIDE for p in getattr(model, name).parameters())
    assert round(total / 1e6, 2) == 96.09 and round(trainable / 1e6, 2) == 38.87


def test_initialisers_follow_flax(full_shapes):
    """The full codec made from a seed: each kernel's standard deviation
    within 10% of flax's truncated lecun_normal over flax's fan-in (every
    axis of the JAX kernel but the last), none beyond two deviations;
    codebooks normal(1); biases 0, LayerNorms (1, 0), layer scales 0.01."""
    model = Mimi(seed=0, device="cpu")
    sd = model.state_dict()
    jax_keys = {".".join(k.key for k in path): leaf.shape for path, leaf in full_shapes.items()}
    checked = 0
    for name, shape in jax_keys.items():
        *module, leaf = name.split(".")
        if leaf == "kernel":
            ours = sd[".".join((*module, "weight"))]
            std = 1.0 / math.sqrt(math.prod(shape[:-1]))
            assert abs(float(ours.std()) / std - 1) <= 0.1, name
            assert float(ours.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7, name
            checked += 1
        elif leaf == "codebooks":
            ours = sd[name]
            assert abs(float(ours.std()) - 1) <= 0.1 and abs(float(ours.mean())) <= 0.01
        elif leaf == "bias":
            assert not sd[name].any(), name
        elif leaf == "scale":
            assert bool((sd[".".join((*module, "weight"))] == 1).all())
        else:
            assert leaf.startswith("layer_scale") and bool((sd[name] == 0.01).all()), name
    assert checked == sum(k.endswith("kernel") for k in jax_keys) > 50
    tiny_sd = Mimi(preset="tiny", seed=0, device="cpu").state_dict()
    assert all(torch.equal(v, Mimi(preset="tiny", seed=0, device="cpu").state_dict()[k]) for k, v in tiny_sd.items())


def test_mimi_wrapper():
    model = Mimi(preset="tiny", seed=3, device="cpu", compute_dtype="bfloat16")
    assert model.config == dataclasses.replace(tiny_config(), compute_dtype="bfloat16")
    assert model.frame_size == 16 and model.valid_length(1) == 16 and model.valid_length(32) == 32
    assert MimiConfig().hop_length == 1920 and Mimi.__mro__[1] is MimiModule
    with pytest.raises(ValueError, match="unknown Mimi preset"):
        Mimi(preset="small", device="cpu")
