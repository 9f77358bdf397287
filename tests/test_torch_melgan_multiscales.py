"""PyTorch port: the multi-scale MelGAN discriminator against the JAX package.

``MelganMultiScalesDiscriminator(sample_rate=16000, scales=3)`` on
(4, 15679, 1), the shapes of ``tests/test_eben_models.py``, is initialised
in JAX, converted with ``melgan_multiscales_params_from_jax`` and loaded
with ``strict=True``.  Every scale's resampled input and embeddings are held
to 2e-5 of each tensor's scale (float32 on both sides; the deep layers
reach scales in the tens, where 2e-5 absolute would be below float32's
resolution), and, on one row of that length, the gradient of a fixed
linear read-out of every embedding with respect to the audio, which flows
through both resamplers, to 1e-4 of its scale.  The published ``melgan_multi_scales_from_scratch``
config instantiates through the port's target rewrite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibravox_tpu.models.melgan_discriminator import (
    MelganMultiScalesDiscriminator as JaxMelganMultiScalesDiscriminator,
)
from vibravox_tpu_torch.models.convert import melgan_multiscales_params_from_jax
from vibravox_tpu_torch.models.melgan_discriminator import MelganMultiScalesDiscriminator
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

SHAPE = (4, 15679, 1)
EMB_TOL, GRAD_TOL = 2e-5, 1e-4


def _close(got: np.ndarray, want: np.ndarray, tol: float) -> None:
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def pair():
    audio = np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)
    jdisc = JaxMelganMultiScalesDiscriminator(sample_rate=16000, scales=3)
    params = jax.device_get(jax.jit(jdisc.init)(jax.random.key(2), jnp.asarray(audio)))
    disc = MelganMultiScalesDiscriminator(16000, scales=3, device="cpu")
    disc.load_state_dict(melgan_multiscales_params_from_jax(params), strict=True)
    return jdisc, params, disc


def test_every_scale_matches_jax(pair):
    jdisc, params, disc = pair
    audio = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32) * 0.3
    ref = jax.jit(jdisc.apply)(params, jnp.asarray(audio))
    want_down = jdisc.apply(params, jnp.asarray(audio), method="get_downsampled_versions")
    with torch.no_grad():
        out = disc(torch.from_numpy(audio))
        down = disc.get_downsampled_versions(torch.from_numpy(audio))
    assert [len(s) for s in out] == [len(s) for s in ref] == [8, 8, 8]
    assert [d.shape[1] for d in down] == [15679, 7840, 3920]
    for d, w in zip(down, want_down):
        _close(d.numpy(), np.asarray(w), EMB_TOL)
    for scale_ref, scale_out in zip(ref, out):
        for r, o in zip(scale_ref, scale_out):
            _close(o.numpy(), np.asarray(r), EMB_TOL)


def test_audio_gradient_through_the_resamplers_matches_jax(pair):
    jdisc, params, disc = pair
    rng = np.random.default_rng(2)
    audio = rng.standard_normal((1,) + SHAPE[1:]).astype(np.float32) * 0.3
    with torch.no_grad():
        shapes = [[tuple(e.shape) for e in s] for s in disc(torch.from_numpy(audio))]
    heads = [[rng.standard_normal(s).astype(np.float32) for s in scale] for scale in shapes]

    def jax_loss(a):
        return sum(jnp.sum(e * h) for es, hs in zip(jdisc.apply(params, a), heads) for e, h in zip(es, hs))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(audio)))
    x = torch.from_numpy(audio).requires_grad_(True)
    loss = sum((e * torch.from_numpy(h)).sum() for es, hs in zip(disc(x), heads) for e, h in zip(es, hs))
    loss.backward()
    _close(x.grad.numpy(), want, GRAD_TOL)


def test_published_config_instantiates_through_the_port():
    from vibravox_tpu_torch.core.config import compose, instantiate
    from vibravox_tpu_torch.run import CONFIG_DIR, port_targets

    cfg = compose(CONFIG_DIR, "run", [
        "lightning_datamodule=bwe", "lightning_module=eben",
        "lightning_module/dnn_module@lightning_module.discriminator=melgan_multi_scales_from_scratch",
        "++lightning_module.description=melgan"])
    port_targets(cfg, "cpu")
    node = cfg.lightning_module.discriminator
    assert node["_target_"] == "vibravox_tpu_torch.models.melgan_discriminator.MelganMultiScalesDiscriminator"
    disc = instantiate(node)
    assert isinstance(disc, MelganMultiScalesDiscriminator)
    assert (disc.sample_rate, disc.scales, len(disc.discriminators)) == (16000, 3, 3)
    assert next(disc.parameters()).device == torch.device("cpu")
    assert "discriminators.2.discriminator.6.parametrizations.weight.original1" in disc.state_dict()
