"""PyTorch port: the fused residual stack against the JAX package.

On the CPU the port's ``residual_stack`` runs its plain version; it is held
to the JAX ``_plain_stack`` and to the JAX ``residual_stack`` with
``VIBRAVOX_FUSED_RU=1``, which runs the Pallas K1 kernel in interpret mode
(signals shorter than its edge window take the JAX plain path).  Tolerance
2e-5 of the output's largest magnitude: float32 sums in another order
through a chain of six convolutions.  The CUDA kernel against this plain
version needs a GPU: ``tests/test_torch_cuda_kernels.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibravox_tpu.ops.fused_residual import _plain_stack
from vibravox_tpu.ops.fused_residual import residual_stack as jax_residual_stack
from vibravox_tpu_torch.ops.fused_residual import residual_stack

CASES = [(32, 700), (16, 1025), (64, 512), (32, 40)]


def _inputs(c, t, seed=0):
    """x (2, t, c) NWC and per unit (wd (3, c, c), wp (1, c, c)) WIO, float32."""
    rng = np.random.default_rng(seed)
    scale = 0.5 / np.sqrt(3 * c)  # keeps the residual chain O(1)
    x = rng.standard_normal((2, t, c)).astype(np.float32) * 0.5
    ks = [
        (rng.standard_normal((3, c, c)).astype(np.float32) * scale,
         rng.standard_normal((1, c, c)).astype(np.float32) * scale)
        for _ in range(3)
    ]
    return x, ks


def _port(x, ks):
    """Run the port on the same numbers: NCW activations, (out, in, k) kernels."""
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    kt = tuple(
        (torch.from_numpy(np.ascontiguousarray(wd.transpose(2, 1, 0))),
         torch.from_numpy(np.ascontiguousarray(wp.transpose(2, 1, 0))))
        for wd, wp in ks
    )
    before = residual_stack.launches
    y = residual_stack(xt, kt)
    assert residual_stack.launches == before, "the CPU path must not count a kernel launch"
    return y.numpy().transpose(0, 2, 1)


def _jax_kernels(ks):
    return tuple((jnp.asarray(wd), jnp.asarray(wp)) for wd, wp in ks)


@pytest.mark.parametrize("c,t", CASES)
def test_matches_jax_plain_stack(c, t):
    x, ks = _inputs(c, t)
    ref = np.asarray(_plain_stack(jnp.asarray(x), _jax_kernels(ks), (1, 3, 9), 0.01))
    out = _port(x, ks)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("c,t", CASES)
def test_matches_jax_interpret_kernel(c, t, monkeypatch):
    monkeypatch.setenv("VIBRAVOX_FUSED_RU", "1")
    x, ks = _inputs(c, t, seed=1)
    ref = np.asarray(jax_residual_stack(jnp.asarray(x), _jax_kernels(ks)))
    out = _port(x, ks)
    np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


def test_unsupported_device_raises():
    x = torch.empty(1, 32, 40, device="meta")
    w = (torch.empty(32, 32, 3, device="meta"), torch.empty(32, 32, 1, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        residual_stack(x, (w, w, w))
