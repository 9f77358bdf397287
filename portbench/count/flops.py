"""Model FLOPs from the plain references, counted on the meta device.

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions,
matrix products and their backward (2 FLOP a multiply-add) that a plain
reference runs at the cell's shapes; on the meta device no data is made,
so a full-size count takes a moment.  A convolution's backward is counted
as its forward once for each gradient it makes.  The references compute what the
algorithm needs and nothing twice (EBEN's balancing gradients are each
loss's cotangent at the generator's outputs taken through the last conv,
then one backward; the frozen encoder has no backward), so these are model
FLOPs, whatever the program recomputes.  FFTs are invisible to the counter
and are added by ``bounds.fft_flops``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from portbench.count.bounds import bound_s, fft_flops, stack_backward_work, stack_work
from portbench.reference import eben, wav2vec2
from portbench.reference.common import Precision

META = torch.device("meta")


def _conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                   _output_padding, _groups, output_mask, out_shape=None, **kwargs) -> int:
    """A convolution's backward: its forward's FLOP for the input's
    gradient and again for the weight's, each where asked for.  (torch's own
    formula counts the weight's gradient of a grouped conv as if ungrouped.)"""
    forward = conv_flop_count(list(x_shape), list(w_shape), list(grad_out_shape), transposed)
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def counted(fn) -> float:
    with FlopCounterMode(display=False, custom_mapping={torch.ops.aten.convolution_backward: _conv_backward}) as mode:
        fn()
    return float(mode.get_total_flops())


def meta_params(shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, torch.Tensor]:
    return {n: torch.empty(s, device=META, requires_grad=True) for n, s in shapes.items()}


def eben_forward(m: int, n: int, p: int, batch: int, samples: int, dtype: torch.dtype
                 ) -> Tuple[float, List[Tuple[int, int, int]]]:
    """(FLOP of one generator forward, each residual stack's (B, C, T))."""
    gen = eben.Generator.make(m, n, p, META)
    params = meta_params(eben.generator_shapes(m, p))
    shapes: List[Tuple[int, int, int]] = []
    audio = torch.empty(batch, 1, samples, device=META, dtype=dtype)
    prec = Precision(compute=None if dtype == torch.float32 else dtype)
    with torch.no_grad():
        flops = counted(lambda: eben.generator_forward(params, gen, audio, prec, shapes))
    return flops, shapes


def eben_step(cfg: Dict, batch: int, samples: int, dtype: torch.dtype) -> float:
    """Model FLOP of one train step of ``cfg`` at (batch, samples)."""
    g, d, loss = cfg["generator"], cfg["discriminator"], cfg["stft_loss"]
    resolutions = tuple(zip(loss["fft_sizes"], loss["hop_sizes"], loss["win_lengths"]))
    ref = eben.EBENReference(
        gen=eben.Generator.make(g["m"], g["n"], g["p"], META),
        gen_params=meta_params(eben.generator_shapes(g["m"], g["p"])),
        disc_params=meta_params(eben.discriminator_shapes(d["q"], d["min_channels"])),
        q=d["q"], resolutions=resolutions, taps=torch.empty(101, device=META),
        prec=Precision(compute=None if dtype == torch.float32 else dtype),
        lr=cfg["optimizer"]["lr"], betas=tuple(cfg["optimizer"]["betas"]))
    x = torch.empty(batch, samples, device=META)
    flops = counted(lambda: ref.gradients(x, x))
    # the STFT loss: both signals' spectra forward, the enhanced one's inverse
    for fft, hop, _ in resolutions:
        flops += 3 * fft_flops(batch, samples, fft, hop)
    return flops


def w2v2_step(cfg: Dict, batch: int, samples: int, label_width: int) -> float:
    """Model FLOP of one fine-tuning step at (batch, samples): the frozen
    encoder forward, the rest forward and backward."""
    c = wav2vec2.W2V2Config.of(cfg)
    ref = wav2vec2.W2V2Reference(c, meta_params(wav2vec2.param_shapes(c)), Precision(), 3e-4, (0.5, 0.9), 0)
    audio = torch.empty(batch, samples, device=META)
    labels = torch.zeros(batch, label_width, dtype=torch.long, device=META)
    return counted(lambda: ref.gradients(audio, labels, None))


def k_bounds_s(stacks: Sequence[Tuple[int, int, int]], dtype: torch.dtype, backward: bool) -> float:
    """Seconds at the roofline of K1 (or K2 with ``backward``) over ``stacks``."""
    work = stack_backward_work if backward else stack_work
    return sum(bound_s(*work(b, c, t, dtype), dtype) for b, c, t in stacks)
