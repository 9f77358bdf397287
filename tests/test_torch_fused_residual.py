"""PyTorch port: the fused residual stack against the JAX package.

On the CPU the port's ``residual_stack`` runs its plain version; it is held
to the JAX ``_plain_stack`` and to the JAX ``residual_stack`` with
``VIBRAVOX_FUSED_RU=1``, which runs the Pallas K1 kernel in interpret mode
(signals shorter than its edge window take the JAX plain path).  Tolerance
2e-5 of the output's largest magnitude: float32 sums in another order
through a chain of six convolutions.  The CUDA kernel against this plain
version needs a GPU: ``tests/test_torch_cuda_kernels.py``.

The CUDA kernel's bf16 walk (tensor cores fed by ldmatrix, emulated in
float64 in ``tests/test_torch_residual_fwd_mma.py``), rounding h1, the leaky
output and each unit's output to bf16 as the kernel does, is held to the
JAX ``residual_stack`` in bf16 through interpret-mode Pallas within 2e-2 of
scale: JAX stitches the edge rows from its plain bf16 convolutions, which
round h2 to bf16 before the leaky, and sums in another order.

Gradients (dx and all six dW, relaid from WIO) are held to ``jax.vjp`` of
``_plain_stack`` and of the interpret-mode fused path (K1 forward, K2
backward) at C = 32, T = 700, B = 2, with the JAX package's own bars for its
fused backward: dx 1e-4 and dW 2e-4 of the largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibravox_tpu.ops.fused_residual import _plain_stack
from vibravox_tpu.ops.fused_residual import residual_stack as jax_residual_stack
from tests.test_torch_residual_fwd_mma import bf16, emulate_stack
from vibravox_tpu_torch.ops.fused_residual import (
    plain_residual_stack_backward,
    residual_stack,
    residual_stack_backward,
)
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)


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


@pytest.mark.parametrize("c,t", [(32, 700), (64, 512), (128, 300)])
def test_bf16_kernel_walk_matches_jax_bf16(c, t, monkeypatch):
    monkeypatch.setenv("VIBRAVOX_FUSED_RU", "1")
    x, ks = _inputs(c, t, seed=5)
    # bf16 values, as both sides take them
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    ks = [tuple(np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32)) for w in pair) for pair in ks]
    ref = jax_residual_stack(jnp.asarray(x, jnp.bfloat16),
                             tuple((jnp.asarray(wd, jnp.bfloat16), jnp.asarray(wp, jnp.bfloat16)) for wd, wp in ks))
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    xt, kt = _torch_layout(x, ks)
    out = emulate_stack(xt.double(), tuple((wd.double(), wp.double()) for wd, wp in kt), rnd=bf16)
    assert torch.equal(out, bf16(out)), "the walk's outputs are bf16 values"
    out = out.numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(out, ref, atol=2e-2 * np.abs(ref).max(), rtol=0)


def test_unsupported_device_raises():
    x = torch.empty(1, 32, 40, device="meta")
    w = (torch.empty(32, 32, 3, device="meta"), torch.empty(32, 32, 1, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        residual_stack(x, (w, w, w))


def _torch_layout(x, ks):
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    kt = tuple(
        (torch.from_numpy(np.ascontiguousarray(wd.transpose(2, 1, 0))),
         torch.from_numpy(np.ascontiguousarray(wp.transpose(2, 1, 0))))
        for wd, wp in ks
    )
    return xt, kt


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "pallas_interpret"])
def test_gradients_match_jax(fused, monkeypatch):
    if fused:
        monkeypatch.setenv("VIBRAVOX_FUSED_RU", "1")
    x, ks = _inputs(32, 700, seed=2)
    g = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def jax_fn(xx, kflat):
        kk = ((kflat[0], kflat[1]), (kflat[2], kflat[3]), (kflat[4], kflat[5]))
        return jax_residual_stack(xx, kk) if fused else _plain_stack(xx, kk, (1, 3, 9), 0.01)

    kflat = [jnp.asarray(w) for pair in ks for w in pair]
    _, vjp = jax.vjp(jax_fn, jnp.asarray(x), kflat)
    ref_dx, ref_dk = vjp(jnp.asarray(g))

    xt, kt = _torch_layout(x, ks)
    gt = torch.from_numpy(np.ascontiguousarray(g.transpose(0, 2, 1)))
    before = residual_stack_backward.launches
    dx, dws = residual_stack_backward(xt, kt, gt)
    assert residual_stack_backward.launches == before, "the CPU path must not count a kernel launch"
    ref_dx = np.asarray(ref_dx)
    np.testing.assert_allclose(dx.numpy().transpose(0, 2, 1), ref_dx, atol=1e-4 * np.abs(ref_dx).max(), rtol=0)
    for dw, ref in zip([w for pair in dws for w in pair], ref_dk):
        ref = np.asarray(ref).transpose(2, 1, 0)  # WIO -> (out, in, k)
        assert dw.shape == ref.shape
        np.testing.assert_allclose(dw.numpy(), ref, atol=2e-4 * np.abs(ref).max(), rtol=0)


def test_autograd_through_the_cpu_stack_is_the_plain_backward():
    x, ks = _inputs(32, 300, seed=4)
    xt, kt = _torch_layout(x, ks)
    xt.requires_grad_(True)
    for w in [w for pair in kt for w in pair]:
        w.requires_grad_(True)
    g = torch.randn(xt.shape, generator=torch.Generator().manual_seed(0))
    residual_stack(xt, kt).backward(g)
    dx, dws = plain_residual_stack_backward(xt.detach(), kt, g)
    torch.testing.assert_close(xt.grad, dx, atol=0, rtol=0)
    for w, dw in zip([w for pair in kt for w in pair], [w for pair in dws for w in pair]):
        torch.testing.assert_close(w.grad, dw, atol=0, rtol=0)


def test_backward_unsupported_device_raises():
    x = torch.empty(1, 32, 40, device="meta")
    w = (torch.empty(32, 32, 3, device="meta"), torch.empty(32, 32, 1, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        residual_stack_backward(x, (w, w, w), x)
