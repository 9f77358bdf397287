"""PyTorch port: the STFT magnitude, the A-weighting prefilter and the
multi-resolution STFT loss against the JAX package.

On the CPU ``framed_dft_magnitude`` runs its plain version (``torch.stft``);
it is held to the JAX ``stft_magnitude`` (XLA path) and to the JAX
``framed_dft_magnitude``, which runs the Pallas K3/K4 kernels in interpret
mode here.  Tolerances as ``tests/test_dsp_ops.py`` holds the Pallas path:
values 1e-5 of the largest magnitude, gradients 2e-4 of the largest
gradient.  The loss with A-weighting at the ``multi_stft.yaml`` resolutions:
value 1e-5 relative, gradient 5e-3 of its largest (the log-magnitude term
divides by |X|, which amplifies float32 noise near the power clamp, the
bar ``tests/test_dsp_ops.py`` uses for the same loss).  The K3/K4 CUDA
kernels against this plain version need a GPU:
``tests/test_torch_cuda_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibravox_tpu.ops.pallas_stft import framed_dft_magnitude as jax_framed_dft_magnitude
from vibravox_tpu.ops.stft import MultiResolutionSTFTLoss as JaxMultiResolutionSTFTLoss
from vibravox_tpu.ops.stft import a_weighting_fir as jax_a_weighting_fir
from vibravox_tpu.ops.stft import apply_fir as jax_apply_fir
from vibravox_tpu.ops.stft import stft_magnitude as jax_stft_magnitude
from vibravox_tpu.ops.stft import _dft_matrices as jax_dft_matrices
from vibravox_tpu_torch.ops.pallas_stft import _dft_matrices, framed_dft_backward, framed_dft_magnitude
from vibravox_tpu_torch.ops.stft import MultiResolutionSTFTLoss, a_weighting_fir, apply_fir

RESOLUTIONS = [(512, 50, 240), (1024, 120, 600), (2048, 240, 1200)]


@pytest.fixture(scope="module")
def signal():
    return np.random.default_rng(11).standard_normal((2, 6000)).astype(np.float32)


def _port_mag_and_grad(x_np, g_np, fft, hop, win):
    x = torch.from_numpy(x_np).requires_grad_(True)
    before = (framed_dft_magnitude.launches, framed_dft_backward.launches)
    mag = framed_dft_magnitude(x, fft, hop, win)
    mag.backward(torch.from_numpy(g_np))
    assert (framed_dft_magnitude.launches, framed_dft_backward.launches) == before
    return mag.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("fft,hop,win", RESOLUTIONS)
@pytest.mark.parametrize("jax_fn", [jax_stft_magnitude, jax_framed_dft_magnitude],
                         ids=["xla", "pallas_interpret"])
def test_magnitude_and_gradient_match_jax(fft, hop, win, jax_fn, signal):
    ref, vjp = jax.vjp(lambda a: jax_fn(a, fft, hop, win), jnp.asarray(signal))
    g = np.random.default_rng(fft).standard_normal(ref.shape).astype(np.float32)
    (ref_dx,) = vjp(jnp.asarray(g))
    mag, dx = _port_mag_and_grad(signal, g, fft, hop, win)
    assert mag.shape == ref.shape == (2, 1 + 6000 // hop, fft // 2 + 1)
    np.testing.assert_allclose(mag, np.asarray(ref), atol=1e-5 * float(np.max(ref)), rtol=0)
    np.testing.assert_allclose(dx, np.asarray(ref_dx), atol=2e-4 * float(np.abs(ref_dx).max()), rtol=0)


def test_cpu_backward_wrapper_is_autograd_of_the_plain_magnitude(signal):
    x = torch.from_numpy(signal)
    mag = framed_dft_magnitude(x, 512, 50, 240)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(mag.shape).astype(np.float32))
    _, dx = _port_mag_and_grad(signal, g.numpy(), 512, 50, 240)
    torch.testing.assert_close(framed_dft_backward(x, mag, g, 512, 50, 240), torch.from_numpy(dx))


def test_dft_matrices_and_a_weighting_are_the_jax_numbers():
    for fft, hop, win in RESOLUTIONS:
        pad_l = (fft - win) // 2  # the window's rows of JAX's fft-long matrices
        for ours, ref in zip(_dft_matrices(fft, win), jax_dft_matrices(fft, hop, win)[:2]):
            assert ours.dtype == np.float32 and ours.shape == (win, fft // 2 + 1)
            np.testing.assert_array_equal(ours, ref[pad_l : pad_l + win])
    np.testing.assert_array_equal(a_weighting_fir(16000), jax_a_weighting_fir(16000))
    assert a_weighting_fir(16000).shape == (101,)


@pytest.mark.parametrize("t", [1000, 1001])
def test_apply_fir_matches_jax(t):
    rng = np.random.default_rng(t)
    x_np = rng.standard_normal((3, t)).astype(np.float32)
    g_np = rng.standard_normal((3, t)).astype(np.float32)
    taps = a_weighting_fir(16000)
    ref, vjp = jax.vjp(lambda a: jax_apply_fir(a, jnp.asarray(taps)), jnp.asarray(x_np))
    x = torch.from_numpy(x_np).requires_grad_(True)
    y = apply_fir(x, torch.from_numpy(taps))
    y.backward(torch.from_numpy(g_np))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g_np))[0]), atol=1e-5, rtol=0)


def test_multi_resolution_loss_matches_jax():
    """The ``multi_stft.yaml`` loss (three resolutions, A-weighting) on
    (B, T, 1) audio, value and gradient with respect to the first signal."""
    kw = dict(fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50), win_lengths=(600, 1200, 240),
              sample_rate=16000, perceptual_weighting=True)
    rng = np.random.default_rng(5)
    x_np = rng.standard_normal((2, 6000, 1)).astype(np.float32) * 0.1
    y_np = rng.standard_normal((2, 6000, 1)).astype(np.float32) * 0.1
    jloss = JaxMultiResolutionSTFTLoss(**kw)
    ref, ref_dx = jax.value_and_grad(lambda a: jloss(a, jnp.asarray(y_np)))(jnp.asarray(x_np))
    loss_fn = MultiResolutionSTFTLoss(**kw, device="cpu")
    x = torch.from_numpy(x_np).requires_grad_(True)
    loss = loss_fn(x, torch.from_numpy(y_np))
    loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_dx), atol=5e-3 * float(np.abs(ref_dx).max()), rtol=0)


def test_loss_device_policy_and_unsupported_device():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MultiResolutionSTFTLoss((512,), (50,), (240,))
    with pytest.raises(ValueError, match="cpu or cuda"):
        framed_dft_magnitude(torch.empty(1, 1000, device="meta"), 512, 50, 240)
