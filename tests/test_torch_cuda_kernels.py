"""PyTorch port on the GPU: the CUDA kernels against their plain versions.

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
generator overrides itself.
"""

import math

import pytest
import torch

from vibravox_tpu_torch.device import strict_float32
from vibravox_tpu_torch.models.eben_generator import EBENGenerator
from vibravox_tpu_torch.ops.fused_residual import plain_residual_stack, residual_stack

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
    with pytest.raises(NotImplementedError, match="K2"):
        residual_stack(x.clone().requires_grad_(True), ks)
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
