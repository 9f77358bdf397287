"""The MelGAN discriminator's grouped stride-4 convolutions (no JAX, no card).

``ops/strided_group_conv.py``: the plain twin (the polyphase form) against
``F.conv1d`` and its autograd in float64; the autograd Function's backward
honouring ``needs_input_grad`` (its launchers replaced by CPU stand-ins);
the dispatch rule ``ops/conv.py::conv1d`` applies; the whole EBEN
discriminator on the CPU unchanged with the twin in the MelGAN's four
layers.  The kernel itself is held to cuDNN and float64 by the ``gpu``
tests of ``tests/test_torch_cuda_kernels.py`` and by ``chip_smoke.py``.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from tests.torch_support import one_thread  # noqa: F401  (autouse, module scope)
from vibravox_tpu_torch.ops import strided_group_conv as sg

GEOMETRIES = [(16, 64), (64, 256), (256, 1024), (1024, 1024)]  # MelGAN conv_1 ... conv_4


def _inputs(b, c_in, c_out, t, seed=0, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c_in, t, generator=gen, dtype=dtype)
    w = torch.randn(c_out, c_in // 4, 41, generator=gen, dtype=dtype) / math.sqrt(41 * c_in / 4)
    bias = torch.randn(c_out, generator=gen, dtype=dtype)
    return x, w, bias


@pytest.mark.parametrize("c_in,c_out", GEOMETRIES)
@pytest.mark.parametrize("t", [37, 50, 96])  # T % 4 != 0, T not a multiple of 16, and whole tiles of 16
def test_plain_twin_equals_conv1d_and_its_gradients(c_in, c_out, t):
    b = 2 if c_in < 1024 else 1
    x, w, bias = _inputs(b, c_in, c_out, t, seed=c_in + t)
    leaves = [v.clone().requires_grad_(True) for v in (x, w, bias)]
    ref = [v.clone().requires_grad_(True) for v in (x, w, bias)]
    y = sg.plain_strided_group_conv(*leaves)
    y_ref = F.conv1d(*ref, stride=4, padding=20, groups=4)
    assert y.shape == y_ref.shape == (b, c_out, -(-t // 4))
    assert torch.allclose(y, y_ref, atol=1e-12, rtol=0)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(t), dtype=torch.float64)
    grads = torch.autograd.grad(y, leaves, g)
    grads_ref = torch.autograd.grad(y_ref, ref, g)
    for a, r in zip(grads, grads_ref):
        assert torch.allclose(a, r, atol=1e-10 * r.abs().max().item(), rtol=0)


def _cpu_launchers(monkeypatch):
    """The Function's launchers replaced by CPU stand-ins that count calls."""
    calls = {"fprop": 0, "dgrad": 0, "wgrad": 0}

    def fprop(x, weight, bias):
        calls["fprop"] += 1
        return F.conv1d(x, weight, bias, stride=4, padding=20, groups=4)

    def dgrad(dy, weight, x_shape):
        calls["dgrad"] += 1
        return torch.nn.grad.conv1d_input(x_shape, weight, dy, stride=4, padding=20, groups=4)

    def wgrad(x, dy, weight_shape):
        calls["wgrad"] += 1
        return torch.nn.grad.conv1d_weight(x, weight_shape, dy, stride=4, padding=20, groups=4)

    monkeypatch.setattr(sg, "_fprop", fprop)
    monkeypatch.setattr(sg, "_dgrad", dgrad)
    monkeypatch.setattr(sg, "_wgrad", wgrad)
    return calls


@pytest.mark.parametrize("x_grad,w_grad", [(True, False), (False, True), (True, True)])
def test_backward_computes_only_the_gradients_asked_for(x_grad, w_grad, monkeypatch):
    """A frozen weight (the discriminator in the generator's phase) runs no
    wgrad, an input that needs no gradient no dgrad; the launches count the
    entry points that ran."""
    calls = _cpu_launchers(monkeypatch)
    x, w, bias = _inputs(2, 16, 64, 50)
    x.requires_grad_(x_grad)
    w.requires_grad_(w_grad)
    bias.requires_grad_(w_grad)
    before = sg.strided_group_conv.launches
    y = sg._StridedGroupConv.apply(x, w, bias)
    y.square().sum().backward()
    assert calls == {"fprop": 1, "dgrad": int(x_grad), "wgrad": int(w_grad)}
    assert sg.strided_group_conv.launches == before + 1 + int(x_grad) + int(w_grad)
    assert (x.grad is not None) == x_grad and (w.grad is not None) == w_grad
    assert (bias.grad is not None) == w_grad
    xr, wr, br = (v.detach().clone().requires_grad_(r) for v, r in ((x, x_grad), (w, w_grad), (bias, w_grad)))
    F.conv1d(xr, wr, br, stride=4, padding=20, groups=4).square().sum().backward()
    for got, want in ((x.grad, xr.grad), (w.grad, wr.grad), (bias.grad, br.grad)):
        if want is not None:
            assert torch.allclose(got, want, atol=1e-12 * want.abs().max().item(), rtol=0)


def _conv_args(module):
    return (module.weight.shape, module.stride[0], module.pad, module.dilation[0], module.groups)


def test_dispatch_sends_exactly_the_four_melgan_geometries_in_bf16_on_cuda():
    from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
    from vibravox_tpu_torch.models.layers import WNConv1d

    disc = DiscriminatorEBENMultiScales(q=4, min_channels=24, device="cpu")
    routed = []
    for name, m in disc.named_modules():
        if isinstance(m, WNConv1d):
            shape, stride, pad, dilation, groups = _conv_args(m)
            c_in = shape[1] * groups
            if sg.takes("cuda", torch.bfloat16, c_in, shape, stride, pad, dilation, groups):
                routed.append(name)
            for device, dtype in (("cuda", torch.float32), ("cpu", torch.bfloat16), ("cpu", torch.float32)):
                assert not sg.takes(device, dtype, c_in, shape, stride, pad, dilation, groups)
    assert routed == [f"melgan_discriminator.discriminator.{i}.0" for i in (1, 2, 3, 4)]
    ok = ("cuda", torch.bfloat16, 256, (1024, 64, 41), 4, (20, 20), 1, 4)
    assert sg.takes(*ok)
    for i, bad in ((3, (1024, 64, 39)), (4, 2), (5, (19, 21)), (6, 2)):  # k, stride, padding, dilation
        args = list(ok)
        args[i] = bad
        assert not sg.takes(*args), (i, bad)
    assert not sg.takes("cuda", torch.bfloat16, 256, (1024, 128, 41), 4, (20, 20), 1, 2)  # groups != 4
    assert not sg.takes("cuda", torch.bfloat16, 32, (64, 8, 41), 4, (20, 20), 1, 4)  # C_in / 4 = 8
    assert not sg.takes("cuda", torch.bfloat16, 256, (1000, 64, 41), 4, (20, 20), 1, 4)  # C_out / 4 = 250
    assert not sg.takes("cuda", torch.int8, 256, (1024, 64, 41), 4, (20, 20), 1, 4)


def test_int8_route_and_cpu_path_do_not_reach_the_kernel(monkeypatch):
    """The int8 discriminator's convs go through ops/quant.py, and a CPU
    conv1d stays on F.conv1d: neither calls the wrapper."""
    from vibravox_tpu_torch.models.layers import WNConv1d

    hits = []
    monkeypatch.setattr(sg, "strided_group_conv", lambda *a, **k: hits.append(1))
    x = torch.randn(1, 64, 200)
    for int8 in (False, True):
        conv = WNConv1d(64, 256, 41, stride=4, padding=20, groups=4, int8=int8)
        assert conv(x).shape == (1, 256, 50)
    assert hits == []


def test_eben_discriminator_on_cpu_is_unchanged_with_the_twin(monkeypatch):
    """The whole EBEN discriminator on the CPU in float64: embeddings and the
    input gradient, with the MelGAN's four convs through the twin (the rule
    widened to CPU float64), equal F.conv1d's."""
    from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales

    torch.manual_seed(0)
    disc = DiscriminatorEBENMultiScales(q=4, min_channels=24, device="cpu").double()
    gen = torch.Generator().manual_seed(3)
    bands = torch.randn(2, 4, 700, generator=gen, dtype=torch.float64) * 0.3
    audio = torch.randn(2, 1, 2798, generator=gen, dtype=torch.float64) * 0.3

    def run():
        a = audio.clone().requires_grad_(True)
        out = disc.embed(bands, a)
        sum(e.square().mean() for s in out for e in s[1:]).backward()
        return [e.detach() for s in out for e in s], a.grad

    ref, ref_grad = run()
    takes, used = sg.takes, []

    def widened(device_type, dtype, *args):
        hit = takes("cuda", torch.bfloat16, *args) and dtype == torch.float64
        used.append(hit)
        return hit

    monkeypatch.setattr(sg, "takes", widened)
    out, grad = run()
    assert sum(used) == 4  # conv_1 ... conv_4
    for a, b in zip(out, ref):
        assert torch.allclose(a, b, atol=1e-11 * (1 + b.abs().max().item()), rtol=0)
    assert torch.allclose(grad, ref_grad, atol=1e-11 * ref_grad.abs().max().item(), rtol=0)


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 41, 44])
def test_plain_twin_at_inputs_shorter_than_the_kernel(t):
    """Inputs of one sample up to about one kernel: the zero padding covers
    every output but the windows' centres, and T_out = ceil(T / 4)."""
    x, w, bias = _inputs(2, 16, 64, t, seed=100 + t)
    leaves = [v.clone().requires_grad_(True) for v in (x, w, bias)]
    ref = [v.clone().requires_grad_(True) for v in (x, w, bias)]
    y = sg.plain_strided_group_conv(*leaves)
    y_ref = F.conv1d(*ref, stride=4, padding=20, groups=4)
    assert y.shape == y_ref.shape == (2, 64, -(-t // 4))
    assert torch.allclose(y, y_ref, atol=1e-12, rtol=0)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(t), dtype=torch.float64)
    for a, r in zip(torch.autograd.grad(y, leaves, g), torch.autograd.grad(y_ref, ref, g)):
        assert torch.allclose(a, r, atol=1e-10 * r.abs().max().item(), rtol=0)
