"""PyTorch port on the GPU: the CUDA kernels K1-K4 against their plain versions.

Every test here is marked ``gpu`` and skips without a CUDA device; a CUDA
kernel has no CPU mode.  The file imports neither JAX nor the JAX package,
so it also runs on a machine with only PyTorch (``--noconftest`` skips the
suite's JAX set-up)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q

Tolerances: float32 2e-5 of the output's largest magnitude, with the plain
version's convolutions in IEEE float32 (sums in another order); bfloat16
2e-2 of it (h1 and every unit output are rounded to bf16 in places the
plain bf16 convolutions round differently); the generator on the card
against the CPU 1e-4, at PyTorch's default TF32 settings, which the
generator overrides itself.  K2 (the residual stack's backward): float32 dx
1e-4 and dW 2e-4 of the largest magnitude, the JAX package's own bar for
its fused backward; bfloat16 dx 5e-2 and dW 1e-1 of it against the plain
version run in float32 on the same bf16 values: K2 rounds x1, x2, h1, dh2
and dh1 to bf16 as the TPU kernel did, and returns dx and dW in bf16; the
same rounding emulated on the CPU in float64 differs from the float32 plain
backward by up to 2.2e-2 (dx) and 6.8e-2 (dW) of scale at C = 32, T = 700.
K3 (the framed-DFT magnitude) 1e-5 of the largest magnitude: one float32
FFT against another (cuFFT); K4 (its backward) 2e-4 of the largest gradient.
"""

import math

import pytest
import torch

from vibravox_tpu_torch.device import strict_float32
from vibravox_tpu_torch.models.eben_generator import EBENGenerator
from vibravox_tpu_torch.ops.fused_residual import (
    plain_residual_stack,
    plain_residual_stack_backward,
    residual_stack,
    residual_stack_backward,
)
from vibravox_tpu_torch.ops.pallas_stft import (
    framed_dft_backward,
    framed_dft_magnitude,
    plain_framed_dft_backward,
    plain_framed_dft_magnitude,
)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _stack_inputs(b, c, t, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    scale = 0.5 / math.sqrt(3 * c)  # keeps the residual chain O(1)
    x = (torch.randn(b, c, t, generator=gen) * 0.5).to(device, dtype)
    ks = tuple(
        ((torch.randn(c, c, 3, generator=gen) * scale).to(device, dtype),
         (torch.randn(c, c, 1, generator=gen) * scale).to(device, dtype))
        for _ in range(3)
    )
    return x, ks


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "b,c,t", [(2, 32, 700), (2, 32, 1025), (2, 64, 512), (3, 128, 184), (2, 32, 40), (1, 128, 10)]
)
def test_residual_stack_kernel_matches_plain(b, c, t, dtype, tol, cuda):
    x, ks = _stack_inputs(b, c, t, dtype, cuda)
    before = residual_stack.launches
    with torch.no_grad(), strict_float32():
        out = residual_stack(x, ks)
        ref = plain_residual_stack(x, ks)
    torch.cuda.synchronize()
    assert residual_stack.launches == before + 1
    assert out.shape == ref.shape and out.dtype == dtype
    scale = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol * scale


def test_residual_stack_rejects_what_the_kernel_does_not_take(cuda):
    x, ks = _stack_inputs(2, 32, 64, torch.float32, cuda)
    with torch.no_grad():
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            residual_stack(x.half(), tuple((a.half(), b.half()) for a, b in ks))
        with pytest.raises(ValueError, match="contiguous"):
            residual_stack(x.transpose(1, 2).contiguous().transpose(1, 2), ks)
        with pytest.raises(ValueError, match="T >= 10"):
            residual_stack(x[:, :, :9].contiguous(), ks)
        with pytest.raises(ValueError, match="C in"):
            x48, ks48 = _stack_inputs(1, 48, 64, torch.float32, cuda)
            residual_stack(x48, ks48)
        with pytest.raises(ValueError, match="kernel 0"):
            residual_stack(x, ((ks[0][0].bfloat16(), ks[0][1]),) + ks[1:])
        with pytest.raises(ValueError, match="dilations"):
            residual_stack(x, ks, dilations=(1, 2, 4))


def test_generator_on_card_matches_cpu(cuda):
    torch.manual_seed(0)
    cpu = EBENGenerator(device="cpu")
    gpu = EBENGenerator(device=cuda)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    x = torch.randn(2, cpu.valid_length(6000), 1, generator=torch.Generator().manual_seed(1)) * 0.1
    before = residual_stack.launches
    with torch.inference_mode():
        ref_enh, ref_dec = cpu(x)
        enh, dec = gpu(x.to(cuda))
    torch.cuda.synchronize()
    assert residual_stack.launches == before + 6  # one per encoder and decoder block
    torch.testing.assert_close(enh.cpu(), ref_enh, atol=1e-4, rtol=0)
    torch.testing.assert_close(dec.cpu(), ref_dec, atol=1e-4, rtol=0)


# bf16 dW is held to its tolerance where it sums over at least this many
# (batch, time) rows: over fewer, the bf16 rounding of x1, x2 and dh1 alone
# moves the cancelling sums by up to 0.36 of scale (the same rounding
# emulated on the CPU: 0.36 at B = 2, T = 40, 0.14 at B = 3, T = 184), and
# only dx is held
BF16_DW_MIN_ROWS = 1000


def _rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("dtype,tol_dx,tol_dw", [(torch.float32, 1e-4, 2e-4), (torch.bfloat16, 5e-2, 1e-1)])
@pytest.mark.parametrize("b,c,t", [(2, 32, 700), (2, 64, 1001), (3, 128, 184), (2, 32, 40), (1, 128, 10)])
def test_residual_stack_backward_matches_plain(b, c, t, dtype, tol_dx, tol_dw, cuda):
    x, ks = _stack_inputs(b, c, t, dtype, cuda)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)).to(cuda, dtype)
    before = residual_stack_backward.launches
    with strict_float32():
        dx, dws = residual_stack_backward(x, ks, g)
        # the plain version in float32 on the same (bf16-valued) inputs: the
        # error is K2's own bf16 rounding, not the plain bf16 chain's
        ref_dx, ref_dws = plain_residual_stack_backward(
            x.float(), tuple((a.float(), b.float()) for a, b in ks), g.float())
    torch.cuda.synchronize()
    assert residual_stack_backward.launches == before + 1
    assert dx.dtype == dtype and dx.shape == x.shape
    assert _rel_err(dx, ref_dx) <= tol_dx
    for pair, ref_pair, kpair in zip(dws, ref_dws, ks):
        for dw, ref, w in zip(pair, ref_pair, kpair):
            assert dw.shape == w.shape and dw.dtype == w.dtype
            if dtype == torch.float32 or b * t >= BF16_DW_MIN_ROWS:
                assert _rel_err(dw, ref) <= tol_dw


def test_residual_stack_backward_is_deterministic(cuda):
    x, ks = _stack_inputs(4, 64, 3001, torch.float32, cuda)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(6)).to(cuda)
    dx1, dws1 = residual_stack_backward(x, ks, g)
    dx2, dws2 = residual_stack_backward(x, ks, g)
    assert torch.equal(dx1, dx2)
    for p1, p2 in zip(dws1, dws2):
        for a, b in zip(p1, p2):
            assert torch.equal(a, b)


def test_residual_stack_autograd_runs_k1_and_k2(cuda):
    x, ks = _stack_inputs(2, 32, 513, torch.float32, cuda)
    x.requires_grad_(True)
    flat = [w.requires_grad_(True) for pair in ks for w in pair]
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(7)).to(cuda)
    before = (residual_stack.launches, residual_stack_backward.launches)
    residual_stack(x, ks).backward(g)
    assert (residual_stack.launches, residual_stack_backward.launches) == (before[0] + 1, before[1] + 1)
    dx, dws = residual_stack_backward(x.detach(), tuple((a.detach(), b.detach()) for a, b in ks), g)
    assert torch.equal(x.grad, dx)
    for w, dw in zip(flat, [w for pair in dws for w in pair]):
        assert torch.equal(w.grad, dw)


RESOLUTIONS = [(512, 50, 240), (1024, 120, 600), (2048, 240, 1200)]
# (fft, hop, win, B, T): the loss's resolutions at two lengths, then a ragged
# T, B = 1, T just above fft / 2, hops below 32 and the smallest and largest fft
DFT_CASES = [(fft, hop, win, b, t) for fft, hop, win in RESOLUTIONS for b, t in [(2, 6000), (3, 39904)]] + [
    (512, 50, 240, 2, 4001), (1024, 120, 600, 1, 7777), (2048, 240, 1200, 2, 1025),
    (512, 16, 240, 2, 3000), (256, 1, 200, 1, 700), (64, 7, 64, 3, 33), (4096, 1000, 3000, 1, 9001),
]


@pytest.mark.parametrize("fft,hop,win,b,t", DFT_CASES)
def test_framed_dft_kernels_match_plain(fft, hop, win, b, t, cuda):
    gen = torch.Generator().manual_seed(fft + t)
    x = torch.randn(b, t, generator=gen).to(cuda)
    before = (framed_dft_magnitude.launches, framed_dft_backward.launches)
    mag = framed_dft_magnitude(x, fft, hop, win)
    ref = plain_framed_dft_magnitude(x, fft, hop, win)
    g = torch.randn(ref.shape, generator=gen).to(cuda)
    dx = framed_dft_backward(x, mag, g, fft, hop, win)
    ref_dx = plain_framed_dft_backward(x, g, fft, hop, win)
    torch.cuda.synchronize()
    assert (framed_dft_magnitude.launches, framed_dft_backward.launches) == (before[0] + 1, before[1] + 1)
    assert mag.shape == ref.shape == (b, 1 + t // hop, fft // 2 + 1)
    assert _rel_err(mag, ref) <= 1e-5
    assert dx.shape == x.shape and _rel_err(dx, ref_dx) <= 2e-4


@pytest.mark.parametrize("fft,hop,win,silence", [(512, 50, 240, 2048), (2048, 240, 1200, 4800),
                                                 (256, 16, 200, 1024)])
def test_framed_dft_kernels_match_plain_over_silence(fft, hop, win, silence, cuda):
    """Near silence (x scaled by 1e-7) over a stretch longer than the window:
    whole frames clamp at eps, where K4's gom is 0 (mag <= sqrt(eps)) as the
    plain autograd's gradient is."""
    gen = torch.Generator().manual_seed(silence)
    x = torch.randn(2, 12000, generator=gen)
    x[:, 4000 : 4000 + silence] *= 1e-7
    x = x.to(cuda)
    mag = framed_dft_magnitude(x, fft, hop, win)
    ref = plain_framed_dft_magnitude(x, fft, hop, win)
    g = torch.randn(ref.shape, generator=gen).to(cuda)
    dx = framed_dft_backward(x, mag, g, fft, hop, win)
    ref_dx = plain_framed_dft_backward(x, g, fft, hop, win)
    assert (ref <= math.sqrt(1e-8)).any()
    assert _rel_err(mag, ref) <= 1e-5
    assert _rel_err(dx, ref_dx) <= 2e-4


def test_framed_dft_backward_is_deterministic(cuda):
    x = torch.randn(4, 39904, generator=torch.Generator().manual_seed(9)).to(cuda)
    for fft, hop, win in RESOLUTIONS:
        mag = framed_dft_magnitude(x, fft, hop, win)
        g = torch.randn(mag.shape, generator=torch.Generator().manual_seed(fft)).to(cuda)
        assert torch.equal(framed_dft_backward(x, mag, g, fft, hop, win),
                           framed_dft_backward(x, mag, g, fft, hop, win))


def test_framed_dft_rejects_what_the_kernels_do_not_take(cuda):
    x = torch.randn(2, 3000, device=cuda)
    with pytest.raises(ValueError, match="power-of-two fft"):
        framed_dft_magnitude(x, 1000, 50, 240)
    with pytest.raises(TypeError, match="float32"):
        framed_dft_magnitude(x.double(), 512, 50, 240)
    mag = framed_dft_magnitude(x, 512, 50, 240)
    with pytest.raises(ValueError, match="power-of-two fft"):
        framed_dft_backward(x, mag, mag, 1000, 50, 240)
    with pytest.raises(TypeError, match="float32"):
        framed_dft_backward(x.double(), mag, mag, 512, 50, 240)


def test_framed_dft_autograd_runs_k3_and_k4(cuda):
    x = torch.randn(2, 4000, generator=torch.Generator().manual_seed(8)).to(cuda).requires_grad_(True)
    before = (framed_dft_magnitude.launches, framed_dft_backward.launches)
    framed_dft_magnitude(x, 512, 50, 240).sum().backward()
    assert (framed_dft_magnitude.launches, framed_dft_backward.launches) == (before[0] + 1, before[1] + 1)
    ref = plain_framed_dft_backward(x.detach(), torch.ones(2, 81, 257, device=cuda), 512, 50, 240)
    assert _rel_err(x.grad, ref) <= 2e-4
