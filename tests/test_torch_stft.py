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
``tests/test_torch_cuda_kernels.py``.  Here a float64 emulation of their
arithmetic (the Stockham FFT's stages, the two-frame packing, the in-kernel
reflect mirror, gom, the inverse FFT, K4's per-chunk partial sums and their
ordered sum with the reflect fold) is held to the plain version at 1e-10."""

import math

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
from vibravox_tpu_torch.ops.pallas_stft import (
    MAX_FFT,
    MIN_FFT,
    _check_cuda,
    _chunking,
    _kernel_tables,
    _pairs_per_chunk,
    framed_dft_backward,
    framed_dft_magnitude,
    hann_window,
    plain_framed_dft_backward,
    plain_framed_dft_magnitude,
)
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
    """The kernels' tables: the twiddles are exp(-2 pi i m / fft) rounded to
    float32, and window x twiddle rebuilds JAX's window-folded DFT matrices
    (to float32 rounding); the A-weighting FIR is JAX's, bit for bit."""
    for fft, hop, win in RESOLUTIONS:
        twiddles, window = _kernel_tables(fft, win)
        assert twiddles.dtype == window.dtype == np.float32
        assert twiddles.shape == (fft, 2) and window.shape == (fft,)
        exact = np.exp(-2j * np.pi * np.arange(fft) / fft)
        np.testing.assert_array_equal(twiddles[:, 0], exact.real.astype(np.float32))
        np.testing.assert_array_equal(twiddles[:, 1], exact.imag.astype(np.float32))
        t, k = np.arange(fft)[:, None], np.arange(fft // 2 + 1)[None, :]
        tw = twiddles[(t * k) % fft].astype(np.float64)
        wre, wim, _ = jax_dft_matrices(fft, hop, win)
        np.testing.assert_allclose(window[:, None] * tw[..., 0], wre[:fft], atol=2e-7, rtol=0)
        np.testing.assert_allclose(window[:, None] * tw[..., 1], wim[:fft], atol=2e-7, rtol=0)
    np.testing.assert_array_equal(a_weighting_fir(16000), jax_a_weighting_fir(16000))
    assert a_weighting_fir(16000).shape == (101,)


# --------------------------------------------------------------------------- #
# float64 emulation of the K3/K4 kernels (csrc/framed_dft.cu), step by step
# --------------------------------------------------------------------------- #


def _turns(m, d):
    """exp(-2 pi i m / d) in complex128."""
    return torch.polar(torch.ones(m.shape, dtype=torch.float64), -2 * math.pi * m.double() / d)


def _stockham(z: torch.Tensor) -> torch.Tensor:
    """The kernels' forward FFT over the last axis (a power of two): Stockham
    autosort stages, the odd radix-2 or radix-4 stage first, then radix 8;
    stage (ns, r) reads x[j + q n / r], twiddles the q-th value by
    exp(-2 pi i q k / (ns r)) with k = j mod ns, takes an r-point DFT and
    writes y[(j - k) r + k + s ns]."""
    n = z.shape[-1]
    log2n = n.bit_length() - 1
    radices = {0: [], 1: [2], 2: [4]}[log2n % 3] + [8] * (log2n // 3)
    ns = 1
    for r in radices:
        j = torch.arange(n // r)
        k = j & (ns - 1)
        q = torch.arange(r)
        a = z[..., j[:, None] + q[None, :] * (n // r)]  # (..., n / r, r)
        b = (a * _turns(q[None, :] * k[:, None], ns * r)) @ _turns(torch.outer(q, q), r)
        out = torch.empty_like(z)
        out[..., ((j - k) * r + k)[:, None] + q[None, :] * ns] = b
        z, ns = out, ns * r
    return z


def _window64(fft, win):
    """The kernels' fft-long window table, in float64."""
    window = torch.zeros(fft, dtype=torch.float64)
    window[(fft - win) // 2 : (fft - win) // 2 + win] = hann_window(win, torch.float64)
    return window


def _load_frames(x, f, fft, hop, win):
    """Frames f of the reflect-padded signal as the kernels load them: the
    window's taps through the mirrored index, zero elsewhere and for f past
    the last frame.  (B, len(f), fft)."""
    t_len = x.shape[1]
    n = torch.arange(fft)
    pad_l = (fft - win) // 2
    g = f[:, None] * hop + n[None, :] - fft // 2
    g = torch.where(g < 0, -g, g)
    g = torch.where(g > t_len - 1, 2 * (t_len - 1) - g, g)
    keep = (f[:, None] < 1 + t_len // hop) & (n >= pad_l) & (n < pad_l + win)
    return torch.where(keep, x[:, g.clamp(0, t_len - 1)], torch.zeros((), dtype=x.dtype))


def _chunk_spectra(x, fc, fft, hop, win):
    """K3's transform of one chunk of frames fc, fc + 1, ...: frames 2p and
    2p + 1 packed as the real and imaginary part of one complex FFT,
    windowed in its first stage, then separated.  (Xa, Xb), each (B, P,
    fft / 2 + 1)."""
    p = _pairs_per_chunk(fft)
    window = _window64(fft, win)
    fr = _load_frames(x, fc + torch.arange(2 * p), fft, hop, win)
    zz = _stockham((fr[:, 0::2] + 1j * fr[:, 1::2]) * window)
    k = torch.arange(fft // 2 + 1)
    z, zc = zz[..., k], zz[..., (-k) % fft].conj()
    return (z + zc) / 2, (z - zc) / 2j


def _emulate_k3(x, fft, hop, win, eps):
    n_frames = 1 + x.shape[1] // hop
    mags = []
    for fc in range(0, n_frames, 2 * _pairs_per_chunk(fft)):  # one block per chunk
        xa, xb = _chunk_spectra(x, fc, fft, hop, win)
        spec = torch.stack([xa, xb], 2).flatten(1, 2)  # frames in order
        mags.append(torch.sqrt(torch.clamp(spec.real**2 + spec.imag**2, min=eps)))
    return torch.cat(mags, 1)[:, :n_frames]


def _emulate_k4(x, mag, g, fft, hop, win, eps):
    """K4: one block per chunk of frames, as K3, sums its frames' windowed
    gradients over its span of padded positions into its own partial row;
    the second pass gives each sample the partials at its padded position
    and at its reflect mirrors, in chunk order."""
    b_len, t_len = x.shape
    n_frames, pad, pad_l = 1 + t_len // hop, fft // 2, (fft - win) // 2
    p = _pairs_per_chunk(fft)
    n_chunks, span = _chunking(fft, hop, win, n_frames)
    window = _window64(fft, win)
    k = torch.arange(fft // 2 + 1)
    half = torch.where((k == 0) | (k == fft // 2), 1.0, 0.5).double()
    inner = k[(k > 0) & (k < fft // 2)]
    gom = torch.where(mag > math.sqrt(eps), g / mag, torch.zeros((), dtype=x.dtype))
    gom = torch.cat([gom, torch.zeros(b_len, 2 * p, fft // 2 + 1, dtype=x.dtype)], 1)  # frames past the last
    partial = torch.zeros(b_len, n_chunks, span, dtype=x.dtype)
    for c in range(n_chunks):
        fc = 2 * p * c
        xa, xb = _chunk_spectra(x, fc, fft, hop, win)
        ya = xa * gom[:, fc : fc + 2 * p : 2] * half
        yb = xb * gom[:, fc + 1 : fc + 2 * p : 2] * half
        v = torch.zeros(b_len, p, fft, dtype=torch.complex128)
        v[..., k] = ya + 1j * yb
        v[..., fft - inner] = ya[..., inner].conj() + 1j * yb[..., inner].conj()
        r = _stockham(v.conj())  # the inverse as conj(FFT(conj V))
        du = torch.stack([r.real, -r.imag], 2).flatten(1, 2)  # (B, 2P, fft), frames in order
        q = fc * hop + pad_l + torch.arange(span)
        for fl in range(2 * p):
            n = q - (fc + fl) * hop
            hit = (n >= pad_l) & (n < pad_l + win) & (fc + fl < n_frames)
            nn = n.clamp(0, fft - 1)
            partial[:, c] += torch.where(hit, window[nn] * du[:, fl, nn], torch.zeros((), dtype=x.dtype))

    def chunk_sum(q):
        s = torch.zeros(b_len, t_len, dtype=x.dtype)
        for c in range(n_chunks):
            j = q - pad_l - 2 * p * hop * c
            hit = (j >= 0) & (j < span)
            s += torch.where(hit, partial[:, c, j.clamp(0, span - 1)], torch.zeros((), dtype=x.dtype))
        return s

    t = torch.arange(t_len)
    zero = torch.zeros((), dtype=x.dtype)
    return (chunk_sum(t + pad)
            + torch.where((t >= 1) & (t <= pad), chunk_sum(pad - t), zero)
            + torch.where((t >= t_len - 1 - pad) & (t <= t_len - 2), chunk_sum(pad + 2 * (t_len - 1) - t), zero))


@pytest.mark.parametrize("fft", [2**e for e in range(MIN_FFT.bit_length() - 1, MAX_FFT.bit_length())])
def test_stockham_stages_are_the_dft_at_every_kernel_fft(fft):
    gen = torch.Generator().manual_seed(fft)
    z = torch.complex(torch.randn(2, fft, generator=gen, dtype=torch.float64),
                      torch.randn(2, fft, generator=gen, dtype=torch.float64))
    ref = torch.fft.fft(z)
    assert (_stockham(z) - ref).abs().max() <= 1e-12 * ref.abs().max()


# (fft, hop, win, T, silence): the loss's resolutions, a hop < 32, T = fft / 2
# + 1, and near silence (x scaled by 1e-7) over `silence` samples from T / 3,
# longer than the window, so whole frames clamp at eps and gom is 0 there
EMULATED = [(fft, hop, win, 2999, 0) for fft, hop, win in RESOLUTIONS] + [
    (256, 16, 200, 2999, 0), (2048, 240, 1200, 1025, 0), (512, 50, 240, 2999, 1024)]


@pytest.mark.parametrize("fft,hop,win,t_len,silence", EMULATED)
def test_kernel_arithmetic_matches_plain_in_float64(fft, hop, win, t_len, silence):
    gen = torch.Generator().manual_seed(fft + hop)
    x = torch.randn(2, t_len, generator=gen, dtype=torch.float64)
    x[:, t_len // 3 : t_len // 3 + silence] *= 1e-7
    ref = plain_framed_dft_magnitude(x, fft, hop, win)
    assert (ref <= math.sqrt(1e-8)).any() == bool(silence)
    mag = _emulate_k3(x, fft, hop, win, 1e-8)
    assert mag.shape == ref.shape == (2, 1 + t_len // hop, fft // 2 + 1)
    assert (mag - ref).abs().max() <= 1e-10 * ref.abs().max()
    g = torch.randn(ref.shape, generator=gen, dtype=torch.float64)
    ref_dx = plain_framed_dft_backward(x, g, fft, hop, win)
    dx = _emulate_k4(x, ref, g, fft, hop, win, 1e-8)
    assert (dx - ref_dx).abs().max() <= 1e-10 * ref_dx.abs().max()


@pytest.mark.parametrize("shape,dtype,fft,hop,win,error,match", [
    ((2, 3000), torch.float32, 1000, 50, 240, ValueError, "power-of-two fft"),
    ((2, 3000), torch.float32, 8192, 50, 240, ValueError, "power-of-two fft"),
    ((2, 3000), torch.float32, 32, 8, 32, ValueError, "power-of-two fft"),
    ((2, 3000), torch.float64, 512, 50, 240, TypeError, "float32"),
    ((2, 256), torch.float32, 512, 50, 240, ValueError, "T > 256"),
    ((2, 3000), torch.float32, 512, 50, 600, ValueError, "win <= fft"),
])
def test_cuda_path_rejects_what_the_kernels_do_not_take(shape, dtype, fft, hop, win, error, match):
    with pytest.raises(error, match=match):
        _check_cuda(torch.empty(shape, dtype=dtype), fft, hop, win)
    _check_cuda(torch.empty(2, 3000), 512, 1, 512)  # any hop, any win up to fft


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
