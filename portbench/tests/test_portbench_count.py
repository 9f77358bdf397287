"""The FLOP and byte counters: the residual stack's count from the
reference, grouped convolutions' backward, and every roofline bound at or
under the work a plain implementation does at the same shapes."""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F

from portbench.count import bounds, flops
from portbench.reference import eben as ref
from portbench.reference.common import Precision


@pytest.mark.parametrize("b,c,t", [(2, 32, 1000), (3, 64, 517), (1, 128, 250)])
def test_residual_stack_counts_24_c2_t_b(b, c, t):
    params = flops.meta_params({**ref._wn("s.0.dilated_conv", c, c, 3), **ref._wn("s.0.pointwise_conv", c, c, 1),
                                **ref._wn("s.1.dilated_conv", c, c, 3), **ref._wn("s.1.pointwise_conv", c, c, 1),
                                **ref._wn("s.2.dilated_conv", c, c, 3), **ref._wn("s.2.pointwise_conv", c, c, 1)})
    x = torch.empty(b, c, t, device="meta")
    with torch.no_grad():
        count = flops.counted(lambda: ref.residual_stack(params, "s", x, Precision()))
    assert count == 24 * c * c * t * b == bounds.stack_work(b, c, t, torch.float32)[0]


@pytest.mark.parametrize("groups", [1, 4, 16])
def test_a_convolution_backward_counts_its_forward_per_gradient(groups):
    x = torch.empty(2, 64, 300, device="meta", requires_grad=True)
    w = torch.empty(128, 64 // groups, 7, device="meta", requires_grad=True)
    forward = flops.counted(lambda: F.conv1d(x, w, groups=groups))
    both = flops.counted(lambda: torch.autograd.grad(F.conv1d(x, w, groups=groups).sum(), [x, w]))
    weight_only = flops.counted(lambda: torch.autograd.grad(F.conv1d(x.detach(), w, groups=groups).sum(), [w]))
    assert forward == 2 * 2 * 128 * (64 // groups) * 7 * 294
    assert both == 3 * forward and weight_only == 2 * forward


@pytest.mark.parametrize("b,c,t", [(32, 32, 9984), (32, 64, 4992), (8, 128, 496)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stack_bounds_are_no_more_than_the_plain_work(b, c, t, dtype):
    """K1's and K2's operations are the plain stack's forward and the
    autograd of it (forward again, dx, dW); their bytes, those of x, y and
    the weights, are no more than a plain stack's six convolutions move."""
    params = {n: torch.empty(s, device="meta", dtype=dtype, requires_grad=True) for n, s in {
        **ref._wn("s.0.dilated_conv", c, c, 3), **ref._wn("s.0.pointwise_conv", c, c, 1),
        **ref._wn("s.1.dilated_conv", c, c, 3), **ref._wn("s.1.pointwise_conv", c, c, 1),
        **ref._wn("s.2.dilated_conv", c, c, 3), **ref._wn("s.2.pointwise_conv", c, c, 1)}.items()}
    x = torch.empty(b, c, t, device="meta", dtype=dtype, requires_grad=True)
    plain_fwd = flops.counted(lambda: ref.residual_stack(params, "s", x.detach(), Precision()))
    plain_all = flops.counted(lambda: torch.autograd.grad(
        ref.residual_stack(params, "s", x, Precision()).sum(), [x] + list(params.values())))
    fwd_ops, fwd_bytes = bounds.stack_work(b, c, t, dtype)
    bwd_ops, bwd_bytes = bounds.stack_backward_work(b, c, t, dtype)
    assert fwd_ops <= plain_fwd and bwd_ops <= plain_all
    size = torch.empty((), dtype=dtype).element_size()
    assert fwd_bytes <= 12 * b * c * t * size + 12 * c * c * size  # six convs read and write B C T each
    assert bwd_bytes <= 4 * fwd_bytes + 12 * c * c * 4


@pytest.mark.parametrize("fft,hop,win", [(512, 50, 240), (1024, 120, 600), (2048, 240, 1200)])
def test_dft_bounds_are_no_more_than_a_plain_dft(fft, hop, win):
    """K3 and K4 count an FFT's 2.5 N log2 N a frame (K4 twice); a plain
    framed DFT, as a product with the (fft/2 + 1)-bin cosine and sine
    matrix, does 4 N (N/2 + 1) a frame."""
    b, t = 32, 39904
    frames = 1 + t // hop
    plain = 4 * fft * (fft // 2 + 1) * b * frames
    k3_ops, k3_bytes = bounds.dft_work(b, t, fft, hop, backward=False)
    k4_ops, k4_bytes = bounds.dft_work(b, t, fft, hop, backward=True)
    assert k3_ops <= plain and k4_ops <= 2 * plain
    assert k3_ops == 2.5 * fft * math.log2(fft) * b * frames
    assert k3_bytes == 4 * (b * t + b * frames * (fft // 2 + 1)) and k4_bytes == 2 * k3_bytes


def test_bounds_take_the_published_peaks():
    assert bounds.PEAK_FLOPS[torch.bfloat16] == 989e12 and bounds.PEAK_FLOPS[torch.float32] == 495e12
    assert bounds.HBM_BYTES_PER_S == 3.35e12
    assert bounds.bound_s(989e12, 0.0, torch.bfloat16) == 1.0
    assert bounds.bound_s(0.0, 3.35e12, torch.float32) == 1.0


def test_step_counts_cover_forward_and_backward():
    """The EBEN step counts at least its generator's forward and backward
    (twice the forward) and the discriminators' work; wav2vec2's step, its
    frozen encoder once and the rest three times."""
    cfg = {"generator": {"m": 4, "n": 32, "p": 2}, "discriminator": {"q": 4, "min_channels": 24},
           "stft_loss": {"fft_sizes": [512], "hop_sizes": [50], "win_lengths": [240]},
           "optimizer": {"lr": 3e-4, "betas": [0.5, 0.9]}}
    gen_fwd, stacks = flops.eben_forward(4, 32, 2, 2, 3808, torch.float32)
    assert [s[1] for s in stacks] == [32, 64, 128, 128, 64, 32]
    step = flops.eben_step(cfg, 2, 3808, torch.float32)
    assert step > 3 * gen_fwd
    w2v2 = dict(vocab_size=38, pad_token_id=35, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=64, conv_dim=[32] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
                conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2,
                layer_norm_eps=1e-5, hidden_dropout=0.1, activation_dropout=0.1, feat_proj_dropout=0.1,
                final_dropout=0.0, layerdrop=0.05, mask_time_prob=0.05, mask_time_length=10,
                mask_time_min_masks=2, mask_feature_prob=0.1024, mask_feature_length=64, mask_feature_min_masks=0)
    assert flops.w2v2_step(w2v2, 2, 16000, 16) > 0
