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
same rounding emulated on the CPU in float64 (``tests/test_torch_residual_mma.py``)
differs from the float32 plain backward by 2.2e-2 (dx) and 7.8e-2 (dW) of
scale at C = 32, B = 2, T = 700.
K3 (the framed-DFT magnitude) 1e-5 of the largest magnitude: one float32
FFT against another (cuFFT); K4 (its backward) 2e-4 of the largest gradient.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from vibravox_tpu_torch.device import strict_float32
from vibravox_tpu_torch.models.eben_generator import EBENGenerator
from vibravox_tpu_torch.ops.fused_residual import (
    plain_residual_stack,
    plain_residual_stack_backward,
    residual_stack,
    residual_stack_backward,
    residual_stack_backward_recompute,
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
    "b,c,t",
    [(2, 32, 700), (2, 32, 1025), (2, 64, 512), (3, 128, 184), (2, 32, 40), (1, 128, 10),
     # one sample either side of a whole number of the bf16 kernel's tiles
     # (232 at C = 32 and 64, 104 at C = 128), and a training shape
     (2, 32, 463), (2, 32, 465), (2, 64, 231), (2, 64, 233), (2, 128, 207), (2, 128, 209),
     (32, 128, 1248),
     # the batch-1 eval shapes (the float32 kernel's second, smaller tile)
     # and the whole 5.7 s utterance's, and ragged tails of the float32
     # tiles: one sample over whole tiles of the first (232 / 104 / 96 at C
     # = 32 / 64 / 128, B large enough to take it) and of the second (72 /
     # 40 / 16)
     (1, 32, 9984), (1, 64, 4992), (1, 128, 1248), (1, 32, 22848), (1, 128, 2856),
     (66, 32, 465), (66, 64, 209), (66, 128, 97), (1, 32, 145), (1, 64, 81), (1, 128, 33)],
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
@pytest.mark.parametrize(
    "b,c,t",
    [(2, 32, 700), (2, 64, 1001), (3, 128, 184), (2, 32, 40), (1, 128, 10), (1, 128, 1248),
     # one sample either side of two of the bf16 backward's tiles (224 at
     # C = 32, 128 at C = 64, 64 at C = 128)
     (2, 32, 447), (2, 32, 449), (2, 64, 255), (2, 64, 257), (2, 128, 127), (2, 128, 129),
     # one sample either side of two of the earlier float32 backward's tiles
     # (224 / 96 / 46; C = 32's above), and the batch-1 eval shapes
     (2, 64, 191), (2, 64, 193), (2, 128, 91), (2, 128, 93), (1, 32, 9984), (1, 64, 4992),
     # chip_smoke.py's K2_EXTRA shapes not above; one sample either side of
     # two of the float32 backward's tiles (192 / 88 / 88) and of two of its
     # forward recompute's (256 / 128 / 64; C = 64's above)
     (3, 64, 1001), (2, 128, 40), (2, 32, 383), (2, 32, 385), (2, 64, 175), (2, 64, 177),
     (2, 128, 175), (2, 128, 177), (2, 32, 511), (2, 32, 513), (2, 128, 127), (2, 128, 129)],
)
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


@pytest.mark.parametrize("b,c,t", [(32, 32, 9984), (32, 64, 4992), (32, 128, 1248), (1, 128, 1249)])
def test_residual_stack_backward_f32_is_bit_equal_twice(b, c, t, cuda):
    """K2 in float32 at the training shapes and a ragged batch-1 row: dx
    and dW bit-equal over two calls (no atomics; the partials sum in block
    order)."""
    x, ks = _stack_inputs(b, c, t, torch.float32, cuda, seed=c)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(c)).to(cuda) * 0.1
    dx1, dws1 = residual_stack_backward(x, ks, g)
    dx2, dws2 = residual_stack_backward(x, ks, g)
    assert torch.equal(dx1, dx2)
    for p1, p2 in zip(dws1, dws2):
        for a, b2 in zip(p1, p2):
            assert torch.equal(a, b2)


def test_residual_stack_backward_recompute_is_a_timing_aid(cuda):
    """K2 float32's recompute alone runs K2's launches, counts none and
    leaves the wrapper's results as they were; it refuses bf16."""
    x, ks = _stack_inputs(2, 64, 1001, torch.float32, cuda)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(8)).to(cuda)
    dx, dws = residual_stack_backward(x, ks, g)
    before = residual_stack_backward.launches
    residual_stack_backward_recompute(x, ks, g)
    torch.cuda.synchronize()
    assert residual_stack_backward.launches == before
    assert torch.equal(residual_stack_backward(x, ks, g)[0], dx)
    with pytest.raises(ValueError):
        residual_stack_backward_recompute(x.bfloat16(), tuple((a.bfloat16(), b.bfloat16()) for a, b in ks), g)


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
# T, B = 1, T just above fft / 2, hops below 32 and the smallest and largest
# fft, then T <= fft / 2, where the reflect pad reflects more than once
SHORT_DFT_CASES = [(2048, 240, 1200, 2, 900), (1024, 120, 600, 2, 300)]
DFT_CASES = [(fft, hop, win, b, t) for fft, hop, win in RESOLUTIONS for b, t in [(2, 6000), (3, 39904)]] + [
    (512, 50, 240, 2, 4001), (1024, 120, 600, 1, 7777), (2048, 240, 1200, 2, 1025),
    (512, 16, 240, 2, 3000), (256, 1, 200, 1, 700), (64, 7, 64, 3, 33), (4096, 1000, 3000, 1, 9001),
] + SHORT_DFT_CASES


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


@pytest.mark.parametrize("fft,hop,win,b,t", SHORT_DFT_CASES)
def test_framed_dft_backward_is_deterministic_on_short_signals(fft, hop, win, b, t, cuda):
    x = torch.randn(b, t, generator=torch.Generator().manual_seed(t)).to(cuda)
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


# the log-mel front end of the speaker embedders: fft 512, hop 160, win 400,
# at bench's b32 regime (3 s) and at a ragged batch-1 trial (2-6 s)
MEL_DFT_CASES = [(32, 48000), (1, 37123)]


@pytest.mark.parametrize("b,t", MEL_DFT_CASES)
def test_framed_dft_magnitude_matches_plain_at_the_log_mel_shapes(b, t, cuda):
    x = torch.randn(b, t, generator=torch.Generator().manual_seed(t)).to(cuda)
    before = framed_dft_magnitude.launches
    mag = framed_dft_magnitude(x, 512, 160, 400)
    ref = plain_framed_dft_magnitude(x, 512, 160, 400)
    torch.cuda.synchronize()
    assert framed_dft_magnitude.launches == before + 1
    assert mag.shape == ref.shape == (b, 1 + t // 160, 257)
    assert _rel_err(mag, ref) <= 1e-5


def test_speaker_embedders_on_card_match_cpu_and_run_k3(cuda):
    """The tiny ECAPA2 and a narrow ECAPA-TDNN: one K3 launch a forward;
    log-mel features within 1e-3 (log units) of the CPU's on bins whose
    power is at least 1e-6 of their frame's largest, float32 embeddings
    within 1e-4 of scale, the bf16 trunk within 0.08 of scale of float32."""
    from vibravox_tpu_torch.models.ecapa2 import ecapa2_from_config
    from vibravox_tpu_torch.models.ecapa_tdnn import ECAPATDNN
    from vibravox_tpu_torch.ops.mel import log_mel_spectrogram

    x = torch.randn(2, 20000, generator=torch.Generator().manual_seed(11))
    feats_cpu = log_mel_spectrogram(x)
    before = framed_dft_magnitude.launches
    feats = log_mel_spectrogram(x.to(cuda)).cpu()
    assert framed_dft_magnitude.launches == before + 1
    power = feats_cpu.exp()
    loud = power >= 1e-6 * power.amax(dim=-1, keepdim=True)
    assert (feats - feats_cpu).abs()[loud].max() <= 1e-3
    torch.manual_seed(0)
    for make in (lambda d: ecapa2_from_config("tiny", device=d), lambda d: ECAPATDNN(channels=32, scale=4, device=d)):
        cpu_model = make("cpu")
        card_model = make(cuda)
        card_model.load_state_dict(cpu_model.state_dict())
        with torch.no_grad():
            ref = cpu_model(x)
            before = framed_dft_magnitude.launches
            out = card_model(x.to(cuda)).cpu()
        assert framed_dft_magnitude.launches == before + 1
        assert _rel_err(out, ref) <= 1e-4
    bf16 = ecapa2_from_config("tiny", device=cuda, compute_dtype="bfloat16")
    f32 = ecapa2_from_config("tiny", device=cuda)
    bf16.load_state_dict(f32.state_dict())
    with torch.no_grad():
        assert _rel_err(bf16(x.to(cuda)), f32(x.to(cuda))) <= 0.08


def test_mimi_codec_and_train_step_on_card_match_cpu(cuda):
    """The tiny Mimi codec in float32: latents within 1e-4 of scale of the
    CPU's, RVQ codes equal, the round trip within 1e-3 of scale; one
    regressive-Mimi train step (SGD, so an update is proportional to its
    gradient): the loss within 1e-4 relative, the encoder side within 1e-2
    of its update, the rest unchanged; no hand-written kernel launched."""
    from vibravox_tpu_torch.core.optim import sgd
    from vibravox_tpu_torch.models.mimi.mimi import ENCODER_SIDE, Mimi
    from vibravox_tpu_torch.tasks.regressive_mimi import RegressiveMimiTask

    gen = torch.Generator().manual_seed(12)
    x = torch.randn(2, 8 * 16 + 5, 1, generator=gen) * 0.3
    batch = {"audio_body_conducted": x * 0.5, "audio_airborne": x}
    counts = (residual_stack.launches, residual_stack_backward.launches, framed_dft_magnitude.launches,
              framed_dft_backward.launches)
    models = {d: Mimi(preset="tiny", seed=1, device=d) for d in ("cpu", cuda)}
    with torch.no_grad():
        latent = models["cpu"].encode_to_latent(x[:, :128])
        card = models[cuda].encode_to_latent(x[:, :128].to(cuda)).cpu()
        assert _rel_err(card, latent) <= 1e-4
        assert torch.equal(models[cuda].encode(x[:, :128].to(cuda)).cpu(), models["cpu"].encode(x[:, :128]))
        assert _rel_err(models[cuda].decode_latent(latent.to(cuda)).cpu(), models["cpu"].decode_latent(latent)) <= 1e-3
    before = {k: v.clone() for k, v in models["cpu"].state_dict().items()}
    tasks = {d: RegressiveMimiTask(mimi=m, optimizer=sgd(1e-3), device=d) for d, m in models.items()}
    logs = {d: t.train_step(t.init_state(0), batch)[1] for d, t in tasks.items()}
    loss_cpu, loss_card = float(logs["cpu"]["train/l1_latent_loss"]), float(logs[cuda]["train/l1_latent_loss"])
    assert abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu)
    after_cpu = models["cpu"].state_dict()
    after_card = {k: v.cpu() for k, v in models[cuda].state_dict().items()}
    for k, b in before.items():
        if k.split(".")[0] in ENCODER_SIDE:
            assert (after_card[k] - after_cpu[k]).norm() <= 1e-2 * (after_cpu[k] - b).norm() + 1e-9, k
        else:
            assert torch.equal(after_card[k], b) and torch.equal(after_cpu[k], b), k
    assert counts == (residual_stack.launches, residual_stack_backward.launches, framed_dft_magnitude.launches,
                      framed_dft_backward.launches)


# the int8 discriminator convolutions (ops/quant.py): torch._int_mm, no hand-written kernel

INT8_CASES = [  # (C_in, C_out, k, stride, pad, dilation, groups, B, T): MelGAN and EBEN stages, K and N padded
    (256, 1024, 41, 4, (20, 20), 1, 4, 4, 625),
    (1024, 1024, 5, 1, (2, 2), 1, 1, 4, 40),
    (24, 48, 7, 2, (3, 3), 3, 4, 4, 2500),
    (8, 8, 5, 1, (2, 2), 1, 1, 1, 3),
]


@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_conv_on_card_equals_its_int32_twin(case, cuda):
    from vibravox_tpu_torch.ops import quant

    cin, cout, k, stride, pad, d, g, b, t = case
    gen = torch.Generator().manual_seed(0)
    qx = torch.randint(-127, 128, (b, cin, t), generator=gen, dtype=torch.int8)
    qw = torch.randint(-127, 128, (cout, cin // g, k), generator=gen, dtype=torch.int8)
    before = quant.int8_conv1d.launches
    got = quant.int8_conv1d(qx.to(cuda), qw.to(cuda), stride, pad, d, g)
    torch.cuda.synchronize()
    assert quant.int8_conv1d.launches == before + 1 and got.dtype == torch.int32
    assert torch.equal(got.cpu(), quant.plain_int8_conv1d(qx, qw, stride, pad, d, g))


def test_int8_mm_raises_on_a_shape_int_mm_refuses(cuda):
    """No fallback: an unpadded K (12, not a multiple of 8) is refused on
    the card, where the conv route pads it first."""
    from vibravox_tpu_torch.ops import quant

    a = torch.ones(32, 12, dtype=torch.int8, device=cuda)
    w = torch.ones(8, 12, dtype=torch.int8, device=cuda)
    with pytest.raises(RuntimeError):
        quant.int8_mm(a, w)
    # the same K = 4 x 3 = 12 through the conv, which pads it to 16
    x = torch.ones(2, 4, 30, dtype=torch.int8, device=cuda)
    w3 = torch.ones(8, 4, 3, dtype=torch.int8, device=cuda)
    assert torch.equal(quant.int8_conv1d(x, w3, 1, (1, 1)).cpu(),
                       quant.plain_int8_conv1d(x.cpu(), w3.cpu(), 1, (1, 1)))


def test_int8_discriminator_train_step_on_card(cuda, monkeypatch):
    """The EBEN discriminator under VIBRAVOX_INT8_DISC=1 on the card: its
    forward within 15% of scale of the float path, finite gradients."""
    from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
    from vibravox_tpu_torch.ops import quant

    monkeypatch.delenv("VIBRAVOX_INT8_DISC", raising=False)
    plain = DiscriminatorEBENMultiScales(q=4, min_channels=24, device=cuda)
    monkeypatch.setenv("VIBRAVOX_INT8_DISC", "1")
    disc = DiscriminatorEBENMultiScales(q=4, min_channels=24, device=cuda)
    disc.load_state_dict(plain.state_dict())
    gen = torch.Generator().manual_seed(1)
    bands = (torch.randn(2, 4, 2500, generator=gen) * 0.3).to(cuda).requires_grad_(True)
    audio = (torch.randn(2, 1, 10000, generator=gen) * 0.3).to(cuda)
    before = quant.int8_conv1d.launches
    out = disc.embed(bands, audio)
    assert quant.int8_conv1d.launches == before + 3 * 6 + 5
    with torch.no_grad():
        ref = plain.embed(bands, audio)
    for a, b in zip(sum(out, []), sum(ref, [])):
        assert (a - b).abs().max().item() <= 0.15 * b.abs().max().item() + 1e-6
    sum(e[-1].sum() for e in out).backward()
    assert torch.isfinite(bands.grad).all() and all(torch.isfinite(p.grad).all() for p in disc.parameters())


# The MelGAN discriminator's grouped stride-4 convolutions (ops/strided_group_conv.py):
# conv_1 ... conv_4 at the train step's shapes (batch 32 in the generator's
# phase, 64 in the discriminator's).  Bars, as a share of the reference's
# largest magnitude, from readings on an H100 80GB (700 W): y and
# dx come back in bf16, whose rounding alone is up to 2^-8 = 3.9e-3 of a
# value; they read 2.8e-3-3.5e-3 against an IEEE float32 convolution of the
# same bf16 values and 1.7e-3-3.4e-3 against float64 on two batch rows, so
# 4.5e-3.  dW is summed in float32 and not rounded: 3.3e-6-1.3e-5 against
# float32, at most 5.6e-7 against float64, so 1e-4.  cuDNN's bf16 call reads
# 4.9e-3-5.7e-3 (y, rounded twice), the same as the kernel for dx, and
# 2.1e-3-5.9e-3 (dW in bf16): the kernel is held within 8e-3 of it.
SG_LAYERS = [(16, 64, 39904), (64, 256, 9976), (256, 1024, 2494), (1024, 1024, 624)]
SG_BAR = {"fprop": 4.5e-3, "dgrad": 4.5e-3, "wgrad": 1e-4}


def _sg_inputs(b, c_in, c_out, t, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(b, c_in, t, device=device, generator=gen) * 0.5).bfloat16()
    w = torch.randn(c_out, c_in // 4, 41, device=device, generator=gen) / math.sqrt(41 * c_in / 4)
    bias = torch.randn(c_out, device=device, generator=gen) * 0.1
    dy = (torch.randn(b, c_out, -(-t // 4), device=device, generator=gen) * 0.1).bfloat16()
    return x, w, bias, dy


def _conv_backward(dy, x, w, mask):
    return torch.ops.aten.convolution_backward(dy, x, w, None, [4], [20], [1], False, [0], 4, mask)


def _sg_passes(x, w, bias, dy):
    """(y, dx, dW) of the plain convolution in x's dtype (cuDNN)."""
    y = F.conv1d(x, w.to(x.dtype), bias.to(x.dtype), 4, 20, 1, 4)
    dx = _conv_backward(dy, x, w.to(x.dtype), [True, False, False])[0]
    dw = _conv_backward(dy, x, w.to(x.dtype), [False, True, False])[1]
    return {"fprop": y, "dgrad": dx, "wgrad": dw}


@pytest.mark.parametrize("b", [32, 64])
@pytest.mark.parametrize("c_in,c_out,t", SG_LAYERS)
def test_strided_group_conv_matches_cudnn_and_float64(c_in, c_out, t, b, cuda):
    from vibravox_tpu_torch.ops import strided_group_conv as sg

    x, w, bias, dy = _sg_inputs(b, c_in, c_out, t, cuda, seed=c_in + b)
    wb = w.bfloat16().float()  # the weight the kernel multiplies with
    with torch.no_grad():
        got = {"fprop": sg._fprop(x, w, bias), "dgrad": sg._dgrad(dy, w, x.shape),
               "wgrad": sg._wgrad(x, dy, w.shape)}
        lib = _sg_passes(x, w, bias, dy)
        with strict_float32():
            ref = _sg_passes(x.float(), wb, bias, dy.float())
        rows = slice(0, 2)
        ref64 = _sg_passes(x[rows].double(), wb.double(), bias.double(), dy[rows].double())
        got64 = {"fprop": got["fprop"][rows], "dgrad": got["dgrad"][rows],
                 "wgrad": sg._wgrad(x[rows].contiguous(), dy[rows].contiguous(), w.shape)}
    torch.cuda.synchronize()
    assert got["fprop"].dtype == got["dgrad"].dtype == torch.bfloat16 and got["wgrad"].dtype == torch.float32
    for p in ("fprop", "dgrad", "wgrad"):
        assert got[p].shape == ref[p].shape
        scale = ref[p].abs().max().item()
        assert (got[p].float() - ref[p]).abs().max().item() <= SG_BAR[p] * scale, p
        assert (got[p].float() - lib[p].float()).abs().max().item() <= 8e-3 * scale, p
        scale64 = ref64[p].abs().max().item()
        assert (got64[p].double() - ref64[p]).abs().max().item() <= SG_BAR[p] * scale64, p


@pytest.mark.parametrize("c_in,c_out,t", [(16, 64, 12345), (64, 256, 3001), (256, 1024, 777), (1024, 1024, 155),
                                          (1024, 1024, 78), (16, 64, 5)])
def test_strided_group_conv_matches_float32_at_ragged_lengths(c_in, c_out, t, cuda):
    """Odd T (element-wise copies, odd output rows), T % 4 != 0, partial
    tiles, and the lengths MelganMultiScalesDiscriminator's lower scales give."""
    from vibravox_tpu_torch.ops import strided_group_conv as sg

    x, w, bias, dy = _sg_inputs(3, c_in, c_out, t, cuda, seed=t)
    with torch.no_grad():
        got = {"fprop": sg._fprop(x, w, bias), "dgrad": sg._dgrad(dy, w, x.shape),
               "wgrad": sg._wgrad(x, dy, w.shape)}
        with strict_float32():
            ref = _sg_passes(x.float(), w.bfloat16().float(), bias, dy.float())
    for p in ("fprop", "dgrad", "wgrad"):
        assert got[p].shape == ref[p].shape
        scale = ref[p].abs().max().item()
        assert (got[p].float() - ref[p]).abs().max().item() <= SG_BAR[p] * scale, p


@pytest.mark.parametrize("c_in,c_out,t", SG_LAYERS)
def test_strided_group_conv_backward_is_bit_equal_twice(c_in, c_out, t, cuda):
    from vibravox_tpu_torch.ops import strided_group_conv as sg

    x, w, _, dy = _sg_inputs(64, c_in, c_out, t, cuda, seed=3)
    with torch.no_grad():
        assert torch.equal(sg._dgrad(dy, w, x.shape), sg._dgrad(dy, w, x.shape))
        assert torch.equal(sg._wgrad(x, dy, w.shape), sg._wgrad(x, dy, w.shape))


def test_strided_group_conv_rejects_what_the_kernel_does_not_take(cuda):
    from vibravox_tpu_torch.ops import strided_group_conv as sg

    x, w, bias, _ = _sg_inputs(2, 64, 256, 1000, cuda)
    with torch.no_grad():
        assert sg.strided_group_conv(x, w, bias).shape == (2, 256, 250)
        with pytest.raises(TypeError, match="bfloat16 CUDA input"):
            sg.strided_group_conv(x.float(), w, bias)
        with pytest.raises(ValueError, match="contiguous"):
            sg.strided_group_conv(x[:, :, ::2], w, bias)
        with pytest.raises(ValueError, match="does not take"):
            sg.strided_group_conv(x[:, :32].contiguous(), w[:, :8].contiguous(), bias)  # C_in / 4 = 8
        with pytest.raises(ValueError, match="does not take"):
            sg.strided_group_conv(x, w[:, :, :39].contiguous(), bias)  # kernel 39
        with pytest.raises(TypeError, match="floating point"):
            sg.strided_group_conv(x, w.to(torch.int32), bias)
        with pytest.raises(TypeError, match="bias"):
            sg.strided_group_conv(x, w, bias[:128])
        with pytest.raises(TypeError, match="weight must be float32 on"):
            sg.strided_group_conv(x, w.cpu(), bias)


def test_strided_group_conv_dispatch_rule_matches_the_library(cuda):
    """The widths ``takes`` sends to the kernel (``_COG_MULTIPLE``) are the
    ones the library's plans take (``vx_sgconv_wgrad_splits`` is -1 for a
    shape it refuses), at every width a group up to 256 in and 512 out."""
    from vibravox_tpu_torch.ops import strided_group_conv as sg

    lib = sg._library()
    for cig in range(1, 257):
        for cog in range(1, 513):
            ours = sg.takes("cuda", torch.bfloat16, 4 * cig, (4 * cog, cig, 41), 4, (20, 20), 1, 4)
            assert ours == (lib.vx_sgconv_wgrad_splits(1, cig, cog, 64) >= 1), (cig, cog)


def test_eben_train_step_runs_the_melgan_convs_on_the_kernel(cuda):
    """One eben.yaml step at batch 32 x 2.5 s in bf16: 32 entry-point calls
    (12 fprop: conv_1 ... conv_4 on enhanced, reference, then both at batch
    64; 16 dgrad: the two balancing gradients, the generator's backward and
    the discriminator's; 4 wgrad: the discriminator's backward only), K1-K4
    6 each as before, and finite losses."""
    from vibravox_tpu_torch.core.optim import adam
    from vibravox_tpu_torch.losses.gan import FeatureMatchingLoss, HingeLoss
    from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
    from vibravox_tpu_torch.ops import strided_group_conv as sg
    from vibravox_tpu_torch.ops.stft import MultiResolutionSTFTLoss
    from vibravox_tpu_torch.tasks.eben import EBENTask

    torch.manual_seed(0)
    res = [(512, 50, 240), (1024, 120, 600), (2048, 240, 1200)]
    task = EBENTask(
        sample_rate=16000, generator=EBENGenerator(m=4, n=32, p=2, device="cpu"),
        discriminator=DiscriminatorEBENMultiScales(q=4, min_channels=24, device="cpu"),
        generator_optimizer=adam(3e-4, betas=(0.5, 0.9)), discriminator_optimizer=adam(3e-4, betas=(0.5, 0.9)),
        reconstructive_loss_freq_fn=MultiResolutionSTFTLoss(
            [r[0] for r in res], [r[1] for r in res], [r[2] for r in res], sample_rate=16000,
            perceptual_weighting=True, device=cuda),
        feature_matching_loss_fn=FeatureMatchingLoss(), adversarial_loss_fn=HingeLoss(),
        dynamic_loss_balancing="ema", beta_ema=0.9, update_discriminator_ratio=1.0,
        compute_dtype="bfloat16", device=cuda)
    state = task.init_state(seed=0)
    gen = torch.Generator().manual_seed(5)
    batch = {k: (torch.randn(32, 40000, 1, generator=gen) * 0.1).to(cuda)
             for k in ("audio_body_conducted", "audio_airborne")}
    counters = (sg.strided_group_conv, residual_stack, residual_stack_backward, framed_dft_magnitude,
                framed_dft_backward)
    before = [c.launches for c in counters]
    state, logs = task.train_step(state, batch)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [32, 6, 6, 6, 6]
    assert all(math.isfinite(float(v)) for v in logs.values())


# C2, WavLM's gated relative-position attention (ops/gated_attention.py) in
# IEEE float32 against its float64 plain twin: each output within 5e-5 of
# its largest magnitude (float32 sums over up to B T terms; the library
# route, SDPA on the materialised bias, reads the same order of error)
GA_TOL = 5e-5
GA_NAMES = ("out", "dq", "dk", "dv", "dgate", "ddiag")


def _ga_inputs(b, h, t, device, seed=0):
    """At the WavLM cell's scale: heads N(0, 1) as views of (B, T, H, 64)
    projections, the gate in (1, 3), D N(0, 1) as ``rel_attn_embed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(b, t, h, 64, device=device, generator=gen).transpose(1, 2) for _ in range(3))
    gate = 1.0 + 2.0 * torch.rand(b, h, t, device=device, generator=gen)
    diag = torch.randn(h, 2 * t - 1, device=device, generator=gen)
    dout = torch.randn(b, h, t, 64, device=device, generator=gen)
    return q, k, v, gate, diag, dout


def _ga_grads(fn, q, k, v, gate, diag, dout):
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v, gate, diag)]
    out = fn(*leaves)
    return [out.detach(), *torch.autograd.grad(out, leaves, dout)]


@pytest.mark.parametrize("t", [1, 63, 64, 65, 130, 999])
def test_gated_attention_matches_the_float64_twin(t, cuda):
    from vibravox_tpu_torch.ops import gated_attention as ga

    inputs = _ga_inputs(2, 3, t, cuda, seed=t)
    before = ga.gated_attention.launches
    got = _ga_grads(ga.gated_attention, *inputs)
    assert ga.gated_attention.launches - before == 2
    want = _ga_grads(ga.plain_gated_attention, *(x.double() for x in inputs))
    for name, g, w in zip(GA_NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        scale = max(w.abs().max().item(), 1.0)
        assert (g.double() - w).abs().max().item() <= GA_TOL * scale, name


def test_gated_attention_is_bit_equal_twice(cuda):
    from vibravox_tpu_torch.ops import gated_attention as ga

    inputs = _ga_inputs(2, 3, 999, cuda, seed=7)
    first, second = _ga_grads(ga.gated_attention, *inputs), _ga_grads(ga.gated_attention, *inputs)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_gated_attention_rejects_what_the_kernel_does_not_take(cuda):
    from vibravox_tpu_torch.ops import gated_attention as ga

    q, k, v, gate, diag, _ = _ga_inputs(1, 2, 100, cuda)
    with torch.no_grad():
        assert ga.gated_attention(q, k, v, gate, diag).shape == (1, 2, 100, 64)
        with pytest.raises(TypeError, match="float32 CUDA input"):
            ga.gated_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), gate, diag)
        with pytest.raises(ValueError, match="takes"):
            ga.gated_attention(q[..., :32], k[..., :32], v[..., :32], gate, diag)
        with pytest.raises(ValueError, match="diag must be"):
            ga.gated_attention(q, k, v, gate, diag[:, :100])
        with pytest.raises(TypeError, match="gate must be float32"):
            ga.gated_attention(q, k, v, gate.double(), diag)


def _wavlm_on(device, **kw):
    from vibravox_tpu_torch.models.wavlm import wavlm_for_ctc_from_config

    return wavlm_for_ctc_from_config(preset="tiny", seed=3, device=device, hidden_size=128, num_attention_heads=2,
                                     hidden_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0,
                                     mask_time_prob=0.0, layerdrop=0.0, **kw)


@pytest.mark.parametrize("fault", ["gate_off", "relpos_off"])
def test_wavlm_faults_reach_the_kernel(fault, cuda, monkeypatch):
    """A fault planted through ``portbench/wavlm_faults.planted`` (every gate
    1, or P 0) runs on the kernel (heads of 64, float32 on CUDA) and moves
    its logits as it moves the library route's."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench import wavlm_faults
    from vibravox_tpu_torch.models import wavlm
    from vibravox_tpu_torch.ops import gated_attention as ga

    model = _wavlm_on(cuda)
    audio = torch.randn(2, 16000, generator=torch.Generator().manual_seed(1)).to(cuda)
    counts = wavlm.wavlm_attention
    with torch.no_grad(), strict_float32():
        sound = model(audio)
        before = counts.fused_calls, counts.bias_elements
        with wavlm_faults.planted(fault):
            faulty = model(audio)
            assert (counts.fused_calls - before[0], counts.bias_elements - before[1]) == (3, 0)
            monkeypatch.setattr(ga, "takes", lambda *a: False)
            library = model(audio)
    scale = library.abs().max().item()
    assert (faulty - library).abs().max().item() <= 1e-4 * scale
    assert (faulty - sound).abs().max().item() > 1e-2 * scale


def test_wavlm_large_step_runs_the_kernel(cuda):
    """One forward and backward of the large preset (b2, 4 s): 24 kernel
    calls a direction, no gated bias made, finite gradients that reach the
    gate's weights and ``rel_attn_embed``."""
    from vibravox_tpu_torch.models import wavlm
    from vibravox_tpu_torch.ops import gated_attention as ga

    model = wavlm.wavlm_for_ctc_from_config(preset="large", seed=0, device=cuda)
    audio = torch.randn(2, 64000, generator=torch.Generator().manual_seed(2)).to(cuda)
    counts = wavlm.wavlm_attention
    before = counts.calls, counts.fused_calls, counts.bias_elements, ga.gated_attention.launches
    with strict_float32():
        logits = model(audio, train=True, generator=torch.Generator(cuda).manual_seed(0),
                       freeze_feature_encoder=True)
        logits.square().mean().backward()
    torch.cuda.synchronize()
    assert (counts.calls - before[0], counts.fused_calls - before[1], counts.bias_elements - before[2],
            ga.gated_attention.launches - before[3]) == (24, 24, 0, 48)
    attn0 = model.wavlm.encoder.layers[0].attention
    for p in (attn0.rel_attn_embed.weight, attn0.gru_rel_pos_linear.weight, attn0.gru_rel_pos_const):
        assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0
