"""PyTorch port: the EBEN discriminators and GAN losses against the JAX package.

``DiscriminatorEBENMultiScales(q=4, min_channels=8)`` at T = 4064 (the
sizes of ``tests/test_eben_task.py``) is initialised in JAX, converted with
the port's ``eben_discriminator_params_from_jax`` and loaded with
``strict=True``.  Every embedding is held to atol 2e-5, the JAX package's own
bar for its discriminators; the GAN losses on those embeddings to 1e-6
relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibravox_tpu.losses.gan import feature_matching_loss as jax_feature_matching_loss
from vibravox_tpu.losses.gan import hinge_loss as jax_hinge_loss
from vibravox_tpu.models.eben_discriminator import (
    DiscriminatorEBENMultiScales as JaxDiscriminatorEBENMultiScales,
)
from vibravox_tpu.models.melgan_discriminator import DiscriminatorMelGAN as JaxDiscriminatorMelGAN
from vibravox_tpu_torch.losses.gan import FeatureMatchingLoss, HingeLoss, feature_matching_loss, hinge_loss
from vibravox_tpu_torch.losses.simple import L1Loss
from vibravox_tpu_torch.models.convert import eben_discriminator_params_from_jax
from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
from vibravox_tpu_torch.models.melgan_discriminator import DiscriminatorMelGAN
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)


T = 4064


def _inputs(seed):
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((2, (T + 30) // 4 + 1, 4)).astype(np.float32) * 0.3
    audio = rng.standard_normal((2, T, 1)).astype(np.float32) * 0.1
    return bands, audio


@pytest.fixture(scope="module")
def pair():
    jdisc = JaxDiscriminatorEBENMultiScales(q=4, min_channels=8)
    bands, audio = _inputs(0)
    params = jax.device_get(jdisc.init(jax.random.key(3), jnp.asarray(bands), jnp.asarray(audio)))
    disc = DiscriminatorEBENMultiScales(q=4, min_channels=8, device="cpu")
    disc.load_state_dict(eben_discriminator_params_from_jax(params), strict=True)
    return jdisc, params, disc


def _both(pair, seed):
    jdisc, params, disc = pair
    bands, audio = _inputs(seed)
    ref = jdisc.apply(params, jnp.asarray(bands), jnp.asarray(audio))
    with torch.no_grad():
        out = disc(torch.from_numpy(bands), torch.from_numpy(audio))
    return ref, out


def test_every_embedding_matches_jax(pair):
    ref, out = _both(pair, 1)
    assert [len(s) for s in out] == [len(s) for s in ref] == [9, 9, 9, 8]
    for scale_ref, scale_out in zip(ref, out):
        for r, o in zip(scale_ref, scale_out):
            assert tuple(o.shape) == r.shape
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5, rtol=0)


def test_state_dict_names_are_the_reference_names(pair):
    names = set(pair[2].state_dict())
    assert "pqmf_discriminators.2.discriminator.0.1.parametrizations.weight.original0" in names
    assert "pqmf_discriminators.0.discriminator.7.bias" in names
    assert "melgan_discriminator.discriminator.6.parametrizations.weight.original1" in names
    assert "melgan_discriminator.discriminator.3.0.bias" in names


def test_melgan_alone_matches_jax():
    rng = np.random.default_rng(4)
    audio = rng.standard_normal((2, 3001, 1)).astype(np.float32) * 0.1
    jm = JaxDiscriminatorMelGAN(0.2)
    params = jax.device_get(jm.init(jax.random.key(5), jnp.asarray(audio)))
    m = DiscriminatorMelGAN(device="cpu")
    full = {}
    node = params["params"]
    for i, name in enumerate(["discriminator.0.1"] + [f"discriminator.{j}.0" for j in range(1, 6)]
                             + ["discriminator.6"]):
        c = node[f"conv_{i}"]
        full[f"{name}.parametrizations.weight.original0"] = torch.tensor(np.asarray(c["kernel_g"]).reshape(-1, 1, 1))
        full[f"{name}.parametrizations.weight.original1"] = torch.tensor(np.transpose(np.asarray(c["kernel_v"]), (2, 1, 0)))
        full[f"{name}.bias"] = torch.tensor(np.asarray(c["bias"]))
    m.load_state_dict(full, strict=True)
    ref = jm.apply(params, jnp.asarray(audio))
    with torch.no_grad():
        out = m(torch.from_numpy(audio))
    assert len(out) == len(ref) == 8
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5, rtol=0)


def test_gan_losses_match_jax(pair):
    ref_a, out_a = _both(pair, 1)
    ref_b, out_b = _both(pair, 2)
    for target in (1, -1):
        np.testing.assert_allclose(
            float(hinge_loss(out_a, target)), float(jax_hinge_loss(ref_a, target)), rtol=1e-6
        )
        assert float(HingeLoss()(out_a, target)) == float(hinge_loss(out_a, target))
    want = float(jax_feature_matching_loss(ref_a, ref_b))
    np.testing.assert_allclose(float(feature_matching_loss(out_a, out_b)), want, rtol=1e-6)
    assert float(FeatureMatchingLoss()(out_a, out_b)) == float(feature_matching_loss(out_a, out_b))


def test_feature_matching_keeps_the_last_scale_layer_count():
    """The reference divides by the LAST scale's hidden-layer count: 6 for
    the MelGAN, though the three band discriminators before it have 7."""
    a = [[torch.ones(1, 1, 4)] * 9] * 3 + [[torch.ones(1, 1, 4)] * 8]
    b = [[torch.zeros(1, 1, 4)] * 9] * 3 + [[torch.zeros(1, 1, 4)] * 8]
    # every hidden layer contributes 1; 3 * 7 + 6 = 27 over 4 scales x 6 layers
    assert float(feature_matching_loss(a, b)) == pytest.approx(27 / 24)


def test_l1_loss():
    x, y = torch.tensor([1.0, -2.0, 3.0]), torch.tensor([0.0, 0.0, 1.0])
    assert float(L1Loss()(x, y)) == pytest.approx(5 / 3)
