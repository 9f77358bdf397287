"""Plain reference of EBEN's GAN train step and of its generator.

EBEN (Hauret et al., ICASSP 2023), as the Vibravox recipe trains it
(``configs/lightning_module/eben.yaml``): the generator (PQMF analysis of
the first p of m bands, a 1-D conv U-Net whose blocks hold three dilated
residual units, tanh over the bands, PQMF synthesis), the discriminators
(three grouped band discriminators at dilations 1, 2, 3 over the last q
bands and a MelGAN discriminator on the audio), the A-weighted
multi-resolution STFT loss, feature matching and hinge losses, the EMA
loss balancing on the last conv's gradient, and one Adam step for each
network, the discriminator's on the same forward's detached outputs.

Everything is written out in plain PyTorch over a dict of parameters that
carries the reference checkpoint's names, so the benchmark hands the same
seeded weights to the program and to this reference.  The PQMF bank and
the A-weighting filter are designed here again (numpy and scipy), from
their published definitions.  No fused kernel: each residual unit is two
convolutions, and each STFT magnitude is ``torch.stft``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import (Adam, Params, Precision, conv1d, leaf_norms, same_padding,
                                        wn_conv_weight, weight_norm)

GEN_SLOPE = 0.01
DISC_SLOPE = 0.2
DILATIONS = (1, 3, 9)
ENCODER = ((64, 2), (128, 4), (256, 8))  # (out channels, stride)
DECODER = ((256, 128, 8), (128, 64, 4), (64, 32, 2))  # (in, out, stride)


# --------------------------------------------------------------------------- #
# PQMF and A-weighting, designed from their definitions
# --------------------------------------------------------------------------- #


def _prototype(kernel_size: int, beta: float, cutoff: float) -> np.ndarray:
    """Kaiser-windowed sinc low-pass of ``kernel_size`` taps."""
    n = np.arange(kernel_size) - (kernel_size - 1) / 2
    return cutoff * np.sinc(cutoff * n) * np.kaiser(kernel_size, beta)


def _cutoff_objective(cutoff: float, m: int, k: int, beta: float) -> float:
    """Largest |autocorrelation| of the prototype at the nonzero multiples
    of 2m (Lin & Vaidyanathan 1998), with a penalty outside the admissible
    cutoffs."""
    proto = _prototype(k, beta, cutoff)
    auto = np.correlate(np.pad(proto, k // 2), proto, mode="valid")
    auto[k // 2] = 0.0
    value = float(np.max(np.abs(auto[:: 2 * m])))
    if abs(cutoff - 1 / (2 * m)) > 1 / (4 * m):
        value += 1 / (4 * m)
    return value


@functools.lru_cache(maxsize=None)
def pqmf_bank(m: int, k: int, beta: float = 9.0) -> Tuple[np.ndarray, np.ndarray]:
    """(analysis, synthesis), each (m, k): the cosine-modulated bank with
    phases +-pi/4 (Nguyen 1994); analysis rows time-reversed for a
    cross-correlation, synthesis scaled by 2m."""
    from scipy.optimize import minimize_scalar

    centre, half = 1 / (2 * m), 1 / (4 * m)
    cutoff = minimize_scalar(_cutoff_objective, bounds=(centre - half + 1e-9, centre + half - 1e-9),
                             args=(m, k, beta), method="bounded", options={"xatol": 1e-12}).x
    proto = _prototype(k, beta, float(cutoff))
    n = np.arange(k) - (k - 1) / 2
    analysis, synthesis = np.zeros((m, k)), np.zeros((m, k))
    for i in range(m):
        phase = (2 * i + 1) * np.pi / (2 * m) * n
        analysis[i] = 2 * (proto * np.cos(phase + (-1) ** i * np.pi / 4))[::-1]
        synthesis[i] = 2 * m * proto * np.cos(phase - (-1) ** i * np.pi / 4)
    return analysis.astype(np.float32), synthesis.astype(np.float32)


@functools.lru_cache(maxsize=None)
def a_weighting_taps(sample_rate: int, ntaps: int = 101) -> np.ndarray:
    """IEC 61672 A-weighting (+2 dB at 1 kHz normalised away), bilinear
    transform, then a least-squares linear-phase FIR on a 512-point grid
    (auraloss's "aw" prefilter)."""
    from scipy import signal

    f1, f2, f3, f4 = 20.598997, 107.65265, 737.86223, 12194.217
    num = [(2 * np.pi * f4) ** 2 * 10 ** (1.9997 / 20), 0, 0, 0, 0]
    den = np.polymul([1, 4 * np.pi * f4, (2 * np.pi * f4) ** 2], [1, 4 * np.pi * f1, (2 * np.pi * f1) ** 2])
    den = np.polymul(np.polymul(den, [1, 2 * np.pi * f3]), [1, 2 * np.pi * f2])
    b, a = signal.bilinear(num, den, fs=sample_rate)
    w, h = signal.freqz(b, a, worN=512, fs=sample_rate)
    return signal.firls(ntaps, w, np.abs(h), fs=sample_rate).astype(np.float32)


@dataclasses.dataclass
class Generator:
    """The generator's geometry and its bank on one device."""

    m: int
    n: int
    p: int
    analysis: torch.Tensor  # (m, 1, n)
    synthesis: torch.Tensor  # (m, 1, n)

    @classmethod
    def make(cls, m: int, n: int, p: int, device) -> "Generator":
        a, s = pqmf_bank(m, n)
        return cls(m, n, p, torch.from_numpy(a[:, None, :].copy()).to(device),
                   torch.from_numpy(s[:, None, :].copy()).to(device))

    @property
    def multiple(self) -> int:
        return 2 * 4 * 8 * self.m

    def valid_length(self, length: int) -> int:
        return length - (length + self.n) % self.multiple

    def analyse(self, audio: torch.Tensor, bands: int, prec: Precision) -> torch.Tensor:
        """(B, 1, T) -> (B, bands, (T + n - 2) // m + 1)."""
        x = prec.operand(audio)
        return F.conv1d(x, prec.operand(self.analysis[:bands]).to(x.dtype), stride=self.m, padding=self.n - 1)

    def synthesise(self, bands: torch.Tensor, prec: Precision) -> torch.Tensor:
        x = prec.operand(bands)
        return F.conv_transpose1d(x, prec.operand(self.synthesis).to(x.dtype), stride=self.m,
                                  padding=self.n - 1, output_padding=self.m - 2)


def residual_stack(params: Params, prefix: str, x: torch.Tensor, prec: Precision,
                   shapes: List[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Three residual units x + leaky(pointwise(dilated_k3(x))), reflect
    "same" padding; ``shapes`` collects each stack's (B, C, T)."""
    if shapes is not None:
        shapes.append(tuple(x.shape))
    for u, d in enumerate(DILATIONS):
        wd = wn_conv_weight(params, f"{prefix}.{u}.dilated_conv")
        wp = wn_conv_weight(params, f"{prefix}.{u}.pointwise_conv")
        h = conv1d(x, wd, prec, padding=same_padding(3, d), dilation=d, reflect=True)
        h = conv1d(h, wp, prec)
        x = x + F.leaky_relu(h, GEN_SLOPE)
    return x


def generator_forward(params: Params, gen: Generator, audio: torch.Tensor, prec: Precision,
                      shapes: List[Tuple[int, int, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """audio (B, 1, T) of a valid length -> (enhanced (B, 1, T), all m bands
    (B, m, T')), in the audio's dtype."""
    first = gen.analyse(audio, gen.p, prec)
    x = conv1d(first, params["first_conv.weight"], prec, padding=same_padding(3), reflect=True)
    skips = []
    for i, (_, stride) in enumerate(ENCODER):
        x = residual_stack(params, f"encoder_blocks.{i}.residuals", F.leaky_relu(x, GEN_SLOPE), prec, shapes)
        x = conv1d(x, wn_conv_weight(params, f"encoder_blocks.{i}.conv"), prec, stride=stride,
                   padding=(stride - 1, stride - 1), reflect=True)
        skips.append(x)
    h = F.leaky_relu(x, GEN_SLOPE)
    h = F.leaky_relu(conv1d(h, wn_conv_weight(params, "latent_conv.1"), prec, padding=same_padding(7),
                            reflect=True), GEN_SLOPE)
    h = F.leaky_relu(conv1d(h, wn_conv_weight(params, "latent_conv.3"), prec, padding=same_padding(7),
                            reflect=True), GEN_SLOPE)
    for i, ((_, _, stride), skip) in enumerate(zip(DECODER, reversed(skips))):
        # a transposed conv's weight is (in, out, k), its gain per input channel
        w = weight_norm(params, f"decoder_blocks.{i}.conv_trans", (1, 2))
        y = prec.operand(h + skip)
        h = F.leaky_relu(F.conv_transpose1d(y, prec.operand(w).to(y.dtype), None, stride, stride // 2),
                         GEN_SLOPE)
        h = residual_stack(params, f"decoder_blocks.{i}.residuals", h, prec, shapes)
    x = conv1d(h, params["last_conv.weight"], prec, padding=same_padding(3), reflect=True)
    fill = first.new_zeros(first.shape[0], gen.m - gen.p, first.shape[2])
    bands = torch.tanh(x + torch.cat([first, fill], dim=1))
    return gen.synthesise(bands, prec), bands


# --------------------------------------------------------------------------- #
# Discriminators
# --------------------------------------------------------------------------- #


def band_discriminator(params: Params, prefix: str, bands: torch.Tensor, dilation: int, q: int,
                       prec: Precision) -> List[torch.Tensor]:
    """Grouped conv stack over q bands: reflect pad 1, a k3 stage, five k7
    stride-2 stages, a k5 stage (all grouped by q, leaky 0.2), and an
    ungrouped k3 certainty conv.  -> [input, 7 hidden, certainties]."""
    d = dilation
    out = [bands]
    x = F.pad(bands, (1, 1), mode="reflect")
    layers = [("0.1", 1, 1, q), ("1.0", 2, 3, q), ("2.0", 2, 3, q), ("3.0", 2, 3, q), ("4.0", 2, 3, q),
              ("5.0", 2, 3, q), ("6.0", 1, 2, q), ("7", 1, 1, 1)]
    for i, (name, stride, pad, groups) in enumerate(layers):
        key = f"{prefix}.discriminator.{name}"
        last = i == len(layers) - 1
        x = conv1d(x, wn_conv_weight(params, key), prec, bias=params[f"{key}.bias"], stride=stride,
                   padding=(pad, pad), dilation=1 if last else d, groups=groups)
        if not last:
            x = F.leaky_relu(x, DISC_SLOPE)
        out.append(x)
    return out


def melgan_discriminator(params: Params, prefix: str, audio: torch.Tensor, prec: Precision) -> List[torch.Tensor]:
    """MelGAN: reflect pad 7, k15, four k41 stride-4 stages grouped by 4, a
    k5 stage (leaky 0.2), a k3 certainty conv.  -> [input, 6 hidden, certainties]."""
    out = [audio]
    x = F.pad(audio, (7, 7), mode="reflect")
    layers = [("0.1", 1, 0, 1), ("1.0", 4, 20, 4), ("2.0", 4, 20, 4), ("3.0", 4, 20, 4), ("4.0", 4, 20, 4),
              ("5.0", 1, 2, 1), ("6", 1, 1, 1)]
    for i, (name, stride, pad, groups) in enumerate(layers):
        key = f"{prefix}.discriminator.{name}"
        x = conv1d(x, wn_conv_weight(params, key), prec, bias=params[f"{key}.bias"], stride=stride,
                   padding=(pad, pad), groups=groups)
        if i < len(layers) - 1:
            x = F.leaky_relu(x, DISC_SLOPE)
        out.append(x)
    return out


def discriminators(params: Params, bands: torch.Tensor, audio: torch.Tensor, q: int,
                   prec: Precision) -> List[List[torch.Tensor]]:
    """Three band discriminators (dilations 1, 2, 3) over the last q bands,
    then the MelGAN on the audio."""
    last = bands[:, -q:, :]
    out = [band_discriminator(params, f"pqmf_discriminators.{j}", last, d, q, prec)
           for j, d in enumerate((1, 2, 3))]
    out.append(melgan_discriminator(params, "melgan_discriminator", audio, prec))
    return out


# --------------------------------------------------------------------------- #
# Losses
# --------------------------------------------------------------------------- #


def stft_magnitude(x: torch.Tensor, fft: int, hop: int, win: int, eps: float = 1e-8) -> torch.Tensor:
    """|STFT| of (B, T) float32: centred frames (reflect pad fft/2), periodic
    Hann window of ``win`` zero-padded to ``fft``, sqrt(max(power, eps)).
    -> (B, frames, fft/2 + 1)."""
    window = torch.hann_window(win, periodic=True, dtype=x.dtype, device=x.device)
    spec = torch.stft(x, fft, hop_length=hop, win_length=win, window=window, center=True,
                      pad_mode="reflect", normalized=False, onesided=True, return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2
    return torch.sqrt(torch.clamp(power, min=eps)).transpose(1, 2)


def stft_loss(x: torch.Tensor, y: torch.Tensor, resolutions: Sequence[Tuple[int, int, int]],
              taps: torch.Tensor) -> torch.Tensor:
    """auraloss's MultiResolutionSTFTLoss with A-weighting: both signals
    through the FIR ('same', zero padding), then per resolution the spectral
    convergence plus the mean |log |X| - log |Y||, averaged.  Computed in
    float64 and returned in float32: the log term's gradient is ill
    conditioned at the bins clamped near silence, where one float32 rounding
    of the window moves it by a part in a few hundred."""
    k = taps.shape[0]
    w = taps.double().flip(0).view(1, 1, k)

    def weigh(a):
        return F.conv1d(F.pad(a.double()[:, None, :], (k // 2, (k - 1) // 2)), w)[:, 0, :]

    x, y = weigh(x), weigh(y)
    total = 0.0
    for fft, hop, win in resolutions:
        xm, ym = stft_magnitude(x, fft, hop, win), stft_magnitude(y, fft, hop, win)
        sc = torch.linalg.vector_norm(ym - xm) / torch.linalg.vector_norm(ym)
        total = total + sc + torch.mean(torch.abs(torch.log(xm) - torch.log(ym)))
    return (total / len(resolutions)).float()


def hinge(embeddings: List[List[torch.Tensor]], target: float) -> torch.Tensor:
    """Mean over scales of mean(relu(1 - target * certainty))."""
    return sum(torch.mean(F.relu(1.0 - target * s[-1].float())) for s in embeddings) / len(embeddings)


def feature_matching(enhanced: List[List[torch.Tensor]], reference: List[List[torch.Tensor]]) -> torch.Tensor:
    """Sum over scales and hidden layers of mean|a - b| / mean|a|, divided
    by (scales x hidden layers of the last scale), as the recipe's loss does."""
    total = 0.0
    for sa, sb in zip(enhanced, reference):
        for a, b in zip(sa[1:-1], sb[1:-1]):
            a, b = a.float(), b.float()
            total = total + torch.mean(torch.abs(a - b)) / torch.mean(torch.abs(a))
    return total / (len(enhanced) * len(enhanced[-1][1:-1]))


# --------------------------------------------------------------------------- #
# The train step
# --------------------------------------------------------------------------- #

GEN_LOSSES = ("reconstructive_loss_freq", "feature_matching_loss", "adv_loss_gen")


@dataclasses.dataclass
class EBENReference:
    """The train step of eben.yaml over plain parameters.  ``gen_params``
    and ``disc_params`` are leaf tensors named as the reference checkpoint
    (the PQMF bank is not among them: it is designed here)."""

    gen: Generator
    gen_params: Params
    disc_params: Params
    q: int
    resolutions: Tuple[Tuple[int, int, int], ...]
    taps: torch.Tensor
    prec: Precision
    lr: float
    betas: Tuple[float, float]
    beta_ema: float = 0.9
    step: int = 0

    def __post_init__(self):
        self.gen_opt = Adam(self.lr, self.betas)
        self.disc_opt = Adam(self.lr, self.betas)
        self.norms_ema = None

    def _cast(self, a: torch.Tensor) -> torch.Tensor:
        return a if self.prec.compute is None else a.to(self.prec.compute)

    def gradients(self, corrupted: torch.Tensor, reference: torch.Tensor):
        """The step's losses and both networks' gradients on (B, T) float32
        batches of a valid length, computed as the algorithm needs them and
        no more: one generator forward, one discriminator forward over each
        half, each loss's gradient at the generator's bands, the balancing
        norms through the last conv alone, one generator backward of the
        weighted cotangents, one discriminator backward.  Updates the EMA.
        Returns (generator losses, real, fake, generator grads, discriminator grads)."""
        gp, dp = self.gen_params, self.disc_params
        for p in list(gp.values()) + list(dp.values()):
            p.requires_grad_(True)
        corrupted, reference = self._cast(corrupted[:, None, :]), self._cast(reference[:, None, :])
        bands_ref = self.gen.analyse(reference, self.gen.m, self.prec)
        enhanced, bands = generator_forward(gp, self.gen, corrupted, self.prec)
        ref_emb = discriminators(dp, bands_ref, reference, self.q, self.prec)
        enh_emb = discriminators(dp, bands, enhanced, self.q, self.prec)
        losses = [stft_loss(enhanced[:, 0], reference[:, 0], self.resolutions, self.taps),
                  feature_matching(enh_emb, ref_emb), hinge(enh_emb, 1.0)]
        # every loss reaches the generator through its bands (the audio is
        # their synthesis): each loss's cotangent there, the discriminator frozen
        cots = [torch.autograd.grad(v, bands, retain_graph=True)[0] for v in losses]
        last = gp["last_conv.weight"]
        norms = torch.stack([torch.linalg.vector_norm(
            torch.autograd.grad(bands, last, grad_outputs=c, retain_graph=True)[0].float()) for c in cots])
        if self.step > 0:
            norms = self.beta_ema * self.norms_ema + (1 - self.beta_ema) * norms
        lambdas = torch.clamp(1.0 / (norms + 1e-4), 0.0, 1e4).detach()
        self.norms_ema = norms.detach()
        cot = sum(lam.to(bands.dtype) * c for lam, c in zip(lambdas, cots))
        names = list(gp)
        gen_grads = dict(zip(names, torch.autograd.grad(bands, [gp[n] for n in names], grad_outputs=cot,
                                                        retain_graph=True)))
        # the discriminator's hinge on the same forward: its parameters only
        real, fake = hinge(ref_emb, 1.0), hinge(enh_emb, -1.0)
        names_d = list(dp)
        disc_grads = dict(zip(names_d, torch.autograd.grad(real + fake, [dp[n] for n in names_d])))
        return losses, real, fake, gen_grads, disc_grads

    def train_step(self, corrupted: torch.Tensor, reference: torch.Tensor) -> Dict[str, float]:
        """One step: the gradients, then both Adam updates.  Returns the
        losses; keeps the first step's gradient norms in ``first_grads``."""
        losses, real, fake, gen_grads, disc_grads = self.gradients(corrupted, reference)
        self.gen_opt.update(self.gen_params, gen_grads)
        self.disc_opt.update(self.disc_params, disc_grads)
        if self.step == 0:
            self.first_grads = {**leaf_norms({f"generator.{k}": v for k, v in gen_grads.items()}),
                                **leaf_norms({f"discriminator.{k}": v for k, v in disc_grads.items()})}
        self.step += 1
        out = dict(zip(GEN_LOSSES, (float(v.detach()) for v in losses)))
        out.update(real_loss=float(real.detach()), fake_loss=float(fake.detach()))
        return out


# --------------------------------------------------------------------------- #
# Parameter shapes, by the reference checkpoint's names
# --------------------------------------------------------------------------- #


def _wn(prefix: str, out: int, cin: int, k: int, bias: bool = False) -> Dict[str, Tuple[int, ...]]:
    shapes = {f"{prefix}.parametrizations.weight.original0": (out, 1, 1),
              f"{prefix}.parametrizations.weight.original1": (out, cin, k)}
    if bias:
        shapes[f"{prefix}.bias"] = (out,)
    return shapes


def generator_shapes(m: int, p: int) -> Dict[str, Tuple[int, ...]]:
    s: Dict[str, Tuple[int, ...]] = {"first_conv.weight": (32, p, 3)}
    for i, (out, stride) in enumerate(ENCODER):
        c = out // 2
        for u in range(3):
            s.update(_wn(f"encoder_blocks.{i}.residuals.{u}.dilated_conv", c, c, 3))
            s.update(_wn(f"encoder_blocks.{i}.residuals.{u}.pointwise_conv", c, c, 1))
        s.update(_wn(f"encoder_blocks.{i}.conv", out, c, 2 * stride))
    s.update(_wn("latent_conv.1", 64, 256, 7))
    s.update(_wn("latent_conv.3", 256, 64, 7))
    for i, (cin, out, stride) in enumerate(DECODER):
        s.update(_wn(f"decoder_blocks.{i}.conv_trans", cin, out, 2 * stride))  # (in, out, k)
        for u in range(3):
            s.update(_wn(f"decoder_blocks.{i}.residuals.{u}.dilated_conv", out, out, 3))
            s.update(_wn(f"decoder_blocks.{i}.residuals.{u}.pointwise_conv", out, out, 1))
    s["last_conv.weight"] = (m, 32, 3)
    return s


def discriminator_shapes(q: int, min_channels: int) -> Dict[str, Tuple[int, ...]]:
    c = min_channels
    widths = [c, 2 * c, 4 * c, 8 * c, 16 * c, 32 * c, 32 * c]
    s: Dict[str, Tuple[int, ...]] = {}
    for j in range(3):
        pre = f"pqmf_discriminators.{j}.discriminator"
        s.update(_wn(f"{pre}.0.1", c, 1, 3, True))
        for i in range(1, 6):
            s.update(_wn(f"{pre}.{i}.0", widths[i], widths[i - 1] // q, 7, True))
        s.update(_wn(f"{pre}.6.0", widths[6], widths[5] // q, 5, True))
        s.update(_wn(f"{pre}.7", 1, widths[6], 3, True))
    pre = "melgan_discriminator.discriminator"
    s.update(_wn(f"{pre}.0.1", 16, 1, 15, True))
    for i, (cin, out) in enumerate(((16, 64), (64, 256), (256, 1024), (1024, 1024)), start=1):
        s.update(_wn(f"{pre}.{i}.0", out, cin // 4, 41, True))
    s.update(_wn(f"{pre}.5.0", 1024, 1024, 5, True))
    s.update(_wn(f"{pre}.6", 1, 1024, 3, True))
    return s
