"""The plain references against the port's CPU paths at tiny sizes, on the
same seeded weights: each piece, then whole checked train steps."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import SEED, cell_named, tiny
from portbench import traffic, weights
from portbench.reference import eben as ref
from portbench.reference import wav2vec2 as w2v2
from portbench.reference.common import Adam, Precision


def _generator(seed: int = 3):
    from vibravox_tpu_torch.models.eben_generator import EBENGenerator

    gen = torch.Generator().manual_seed(seed)
    params = weights.seeded_params(ref.generator_shapes(4, 2), gen, "cpu", 0.577)
    model = EBENGenerator(4, 32, 2, device="cpu")
    weights.load_into(model, params)
    return model, params


def test_pqmf_bank_and_a_weighting_match_the_port():
    from vibravox_tpu_torch.models.eben_generator import EBENGenerator
    from vibravox_tpu_torch.ops.stft import a_weighting_fir

    model = EBENGenerator(4, 32, 2, device="cpu")
    mine = ref.Generator.make(4, 32, 2, "cpu")
    torch.testing.assert_close(mine.analysis, model.pqmf.analysis_weights, rtol=0, atol=1e-6)
    torch.testing.assert_close(mine.synthesis, model.pqmf.synthesis_weights, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ref.a_weighting_taps(16000), a_weighting_fir(16000))


def test_generator_forward_matches_the_port():
    model, params = _generator()
    x = torch.randn(2, 1, model.valid_length(6000), generator=torch.Generator().manual_seed(1)) * 0.3
    with torch.no_grad():
        want, bands_want = model(x.transpose(1, 2))
        got, bands = ref.generator_forward(params, ref.Generator.make(4, 32, 2, "cpu"), x, Precision())
    torch.testing.assert_close(got.transpose(1, 2), want, rtol=0, atol=1e-5 * want.abs().max().item())
    torch.testing.assert_close(bands.transpose(1, 2), bands_want, rtol=0, atol=1e-5)


def test_discriminators_and_gan_losses_match_the_port():
    from vibravox_tpu_torch.losses.gan import feature_matching_loss, hinge_loss
    from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales

    gen = torch.Generator().manual_seed(5)
    params = weights.seeded_params(ref.discriminator_shapes(4, 8), gen, "cpu", 0.577)
    model = DiscriminatorEBENMultiScales(4, 8, device="cpu")
    weights.load_into(model, params)
    bands = torch.randn(2, 4, 1600, generator=gen)
    audio = torch.randn(2, 1, 6400, generator=gen)
    other = torch.randn(2, 1, 6400, generator=gen)
    with torch.no_grad():
        want = model.embed(bands, audio)
        got = ref.discriminators(params, bands, audio, 4, Precision())
        want_b = model.embed(bands * 0.5, other)
        got_b = ref.discriminators(params, bands * 0.5, other, 4, Precision())
    for a, b in zip(want, got):
        for u, v in zip(a, b):
            torch.testing.assert_close(v, u, rtol=1e-5, atol=1e-5 * u.abs().max().item())
    assert abs(float(ref.hinge(got, 1.0)) - float(hinge_loss(want, 1.0))) < 1e-6
    assert abs(float(ref.feature_matching(got, got_b)) - float(feature_matching_loss(want, want_b))) < 1e-6


def test_stft_loss_matches_the_port():
    from vibravox_tpu_torch.ops.stft import MultiResolutionSTFTLoss

    gen = torch.Generator().manual_seed(2)
    x, y = torch.randn(2, 4800, generator=gen) * 0.1, torch.randn(2, 4800, generator=gen) * 0.1
    port = MultiResolutionSTFTLoss([512, 1024], [50, 120], [240, 600], sample_rate=16000,
                                   perceptual_weighting=True, device="cpu")
    mine = ref.stft_loss(x, y, ((512, 50, 240), (1024, 120, 600)), torch.from_numpy(ref.a_weighting_taps(16000)))
    assert abs(float(mine) - float(port(x[..., None], y[..., None]))) < 1e-5 * float(mine)


def test_ctc_recursion_matches_torch():
    gen = torch.Generator().manual_seed(4)
    logits = torch.randn(3, 40, 7, generator=gen)
    labels = torch.tensor([[1, 2, 2, 3, -100], [4, -100, -100, -100, -100], [5, 5, 5, 1, 2]])
    lengths = (labels != -100).sum(-1)
    log_probs = torch.log_softmax(logits, -1)
    want = F.ctc_loss(log_probs.transpose(0, 1), labels.clamp(min=0), torch.full((3,), 40), lengths,
                      blank=6, reduction="none")
    got = w2v2.ctc_nll(log_probs, labels, lengths, blank=6)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_adam_matches_torch():
    gen = torch.Generator().manual_seed(6)
    p0, g1, g2 = (torch.randn(50, generator=gen) for _ in range(3))
    torch_p = p0.clone().requires_grad_(True)
    opt = torch.optim.Adam([torch_p], lr=3e-4, betas=(0.5, 0.9))
    mine = {"p": p0.clone()}
    adam = Adam(3e-4, (0.5, 0.9))
    for g in (g1, g2):
        torch_p.grad = g.clone()
        opt.step()
        adam.update(mine, {"p": g.clone()})
    torch.testing.assert_close(mine["p"], torch_p.detach(), rtol=0, atol=1e-7)


@pytest.mark.parametrize("name", ["eben_train_b32", "w2v2_stp_train_b8"])
def test_checked_train_steps_match_the_port(name):
    cell = tiny(cell_named(name))
    plan = traffic.train_plan(cell.mix, SEED, cell.config["sample_rate"])
    session = cell.adapter.TrainSession(cell.config, plan, SEED, "cpu")
    session.start()
    session.free()
    got = session.check()
    assert got["first_loss_gap"] < 1e-5, got
    assert got["grad_norm_gap"] < 1e-3, got
    assert got["change_norm_gap"] < 1e-3, got
