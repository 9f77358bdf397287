"""PyTorch port: the EBEN generator against the JAX package.

The JAX generator is initialised with ``jax.random.key(0)``; its params are
converted with the port's ``eben_generator_params_from_jax`` and loaded with
``strict=True``.  Outputs are held to atol 5e-5, the bar the JAX package
holds its own fused path to (``tests/test_fused_residual.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibravox_tpu.models.convert import eben_generator_params_to_torch
from vibravox_tpu.models.eben_generator import EBENGenerator as JaxEBENGenerator
from vibravox_tpu_torch.models.convert import eben_generator_params_from_jax
from vibravox_tpu_torch.models.eben_generator import EBENGenerator


@pytest.fixture(scope="module")
def pair():
    """(JAX params as numpy, the port generator with them, input, JAX outputs)."""
    jgen = JaxEBENGenerator(m=4, n=32, p=2)
    t = jgen.valid_length(6000)
    x = np.random.default_rng(0).standard_normal((2, t, 1)).astype(np.float32) * 0.1
    params = jax.device_get(jgen.init(jax.random.key(0), jnp.asarray(x)))
    enhanced, decomposed = jgen.apply(params, jnp.asarray(x))
    gen = EBENGenerator(m=4, n=32, p=2, device="cpu")
    gen.load_state_dict(eben_generator_params_from_jax(params), strict=True)
    return params, gen, x, (np.asarray(enhanced), np.asarray(decomposed))


def test_outputs_match_jax(pair):
    _, gen, x, (ref_enh, ref_dec) = pair
    with torch.no_grad():
        enhanced, decomposed = gen(torch.from_numpy(x))
    assert enhanced.shape == ref_enh.shape == x.shape
    assert decomposed.shape == ref_dec.shape == (2, (x.shape[1] + 30) // 4 + 1, 4)
    np.testing.assert_allclose(enhanced.numpy(), ref_enh, atol=5e-5, rtol=0)
    np.testing.assert_allclose(decomposed.numpy(), ref_dec, atol=5e-5, rtol=0)


def test_state_dict_matches_jax_exporter(pair):
    params = pair[0]
    ours = eben_generator_params_from_jax(params)
    ref = eben_generator_params_to_torch(params)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == v.shape, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_reference_state_dict_names():
    """Default-initialised port: the reference checkpoint names, every one
    of which the JAX exporter also writes."""
    gen = EBENGenerator(device="cpu")
    names = set(gen.state_dict())
    assert "encoder_blocks.2.residuals.1.dilated_conv.parametrizations.weight.original0" in names
    assert "decoder_blocks.0.conv_trans.parametrizations.weight.original1" in names
    assert {"first_conv.weight", "last_conv.weight", "pqmf.analysis_weights"} <= names
    g = gen.state_dict()["decoder_blocks.0.conv_trans.parametrizations.weight.original0"]
    assert tuple(g.shape) == (256, 1, 1)  # transposed conv: gain per input channel


def test_front_tail_split_and_lengths(pair):
    _, gen, x, _ = pair
    jgen = JaxEBENGenerator(m=4, n=32, p=2)
    for n in (6000, 8192, 16000, 16031):
        assert gen.valid_length(n) == jgen.valid_length(n)
    assert gen.multiple == jgen.multiple
    xt = torch.from_numpy(x)
    assert gen.cut_to_valid_length(torch.zeros(1, 6100, 1)).shape[1] == jgen.valid_length(6100)
    with torch.no_grad():
        features, first_bands = gen.front(xt.transpose(1, 2))
        enhanced, decomposed = gen.tail(features, first_bands)
        direct = gen(xt)
    assert features.shape[1] == 32 and first_bands.shape[1] == 2
    torch.testing.assert_close(enhanced.transpose(1, 2), direct[0], atol=0, rtol=0)
    torch.testing.assert_close(decomposed.transpose(1, 2), direct[1], atol=0, rtol=0)
