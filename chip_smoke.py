#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check every kernel on its path.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
The kernels build from ``vibravox_tpu_torch/ops/csrc`` at first use.  Phases
(one JSON line each; any failure raises and exits non-zero):

1. device: the card's name and power limit as nvidia-smi reports them;
2. build: every kernel source (K1; K2; K3 and K4; C1), one nvcc each, all
   started together, with the nvcc time, the ptxas resource report and the
   HMMA (tensor-core), LDSM (ldmatrix) and FFMA instruction counts of each
   kernel; K1's kernel must have HMMA and LDSM in both types; K2's bf16
   unit kernels must have HMMA and LDSM, its float32 product kernels
   (unit_backward_tf32) HMMA, its float32 recompute kernels
   (unit_forward_fma) FFMA and no HMMA, and the float32 FMA kernels they
   replaced (unit_forward_kernel, unit_backward_kernel) may not be left;
   C1's fprop, dgrad and wgrad kernels must have HMMA and LDSM; C2's
   forward and backward kernels must have FFMA and no HMMA (IEEE float32);
3. k1_parity: the fused residual stack (K1) against its plain PyTorch version
   at the serving shapes in float32 (atol 2e-5 of scale, TF32 off for the
   plain convolutions) and bfloat16 (2e-2 of scale), plus ragged T = 1001 and
   the short T = 40, with kernel and plain times by CUDA events and K1's
   launch configuration (tile, grid, waves, blocks per SM, registers);
4. generator_parity: the full-width EBEN generator on the card against the
   same weights on the CPU, float32, atol 1e-4, at PyTorch's default TF32
   settings: the generator itself keeps its convolutions in IEEE float32;
5. serve: the serving path.  ``EnhanceServer`` with the full-width
   generator, a 1 s bucket and max_batch 8 answers 64 requests, in float32
   and in bfloat16; the K1 launch count is reset just before the requests
   and must equal 6 per batched forward; one served request must equal the
   direct forward of the same padded batch;
6. profile: the wall time of a batched float32 forward without any tracing,
   its device time by kernel kind from a CUDA-only torch.profiler trace, and
   the device's idle share from the two;
7. k2_parity: the residual stack's backward (K2) against autograd of the
   plain stack at the training shapes (B = 32) and T = 1001, 40, float32
   and bfloat16, dW bit-equal over two runs; K1 against its plain version
   at the same shapes; K1 and K2 times, K2's device time by pass from a
   CUDA-only trace of one call (in float32 each unit_backward pass also
   split into its recompute, timed alone, and its products), and K1's and
   K2's launch configurations (tile, grid, blocks per SM, registers, spill
   bytes);
8. k3_k4_parity: the framed-DFT magnitude (K3) and its backward (K4)
   against ``torch.stft`` and its autograd at B = 32, T = 39904, the three
   loss resolutions, and at a ragged T, B = 1, T just above fft / 2, hops
   below 32, and T <= fft / 2 (T = 900 at fft 2048, T = 300 at fft 1024),
   where the reflect pad reflects more than once; K4 bit-equal over two
   runs; kernel, plain, library and bound times of whole wrapper calls, in
   turns;
9. sgconv_parity: C1, the MelGAN discriminator's grouped stride-4
   convolutions (kernel 41, padding 20, 4 groups) on their hand-written
   kernel, conv_1 ... conv_4 at the train step's shapes, batch 32 and 64:
   fprop, dgrad and wgrad through ``strided_group_conv``'s autograd
   Function against an IEEE float32 convolution of the same bf16 values and
   a float64 one on two batch rows (y and dx within 4.5e-3 of scale, dW
   1e-4), dgrad and wgrad bit-equal twice; ms a call of cuDNN's bf16 call
   (first), the kernel and the plain twin, each beside its bound; then the
   sums a train step (``sgconv_step``);
9b. gated_attention_parity: C2, WavLM's gated relative-position attention
   on its hand-written IEEE float32 kernels, at the WavLM cell's shape (B 8,
   H 16, T 999, heads of 64): the forward and dq, dk, dv, the gate's and
   P's diagonals' gradients against the float64 plain twin (5e-5 of
   scale), beside the library route's errors (SDPA on the materialised
   bias), bit-equal twice; ms a call of the kernel, the library route and
   the twin, forward and backward, beside the FMA and TF32 bounds, and the
   sums a train step (24 layers);
9c. wavlm_step: one ``Wav2Vec2STPTask.train_step`` of WavLM-Large (the
   ``large`` preset, IEEE float32, Adam) at the WavLM cell's shape, B 8 x
   320000 samples (999 frames), from the same weights on each route: the
   kernel's (C2 48 launches and no other kernel, 24 attention calls all
   fused, no gated bias made) and the library's (``takes`` answering no:
   SDPA on 24 materialised biases); the loss within the cell's
   ``first_loss_gap`` of the library route's and each gradient's norm
   within its ``grad_norm_gap`` by the median leaf, with the memory peak
   of each; C2's launches in the ``kernels`` line come from it;
10. pad_short: the ``pad`` collate on 32 utterances under 1024 samples
   (T = 1024, 992 after the generator's cut) through the full task's
   generator and its STFT loss, forward and backward, on the card against
   the CPU: K1, K2, K3, K4 launched, the 2048-point resolution at
   T <= fft / 2 (the discriminator needs about 3000 samples, so the whole
   train step does not take such a batch);
11. train_parity: one seeded float32 train step at small sizes on the card
    (K1-K4) against the same step on the CPU (the plain versions);
12. train: the training path.  ``Trainer.fit`` of the full ``eben.yaml``
    task at batch 32 on 2.5 s synthetic crops, bfloat16; the counts are
    reset after a warm-up fit and must equal 6 launches per step for each
    of K1-K4 and 32 C1 calls per step over the timed fit;
13. train_profile: the untraced train-step wall, its device time by kernel
    kind from a CUDA-only trace, and the idle share;
14. eval_parity: the full task's float32 eval step on the first batch of
    the CLI's test loader (batch 1, a centred 2.5 s crop) and, as an extra
    shape, on one whole 5.7 s synthetic test utterance, on the card
    against the CPU (logs 1e-4 relative, enhanced audio 1e-4 of scale), K1
    and K3 six launches each; then K1 in float32 and K3 against their
    plain versions at the shapes the CLI batch's forward ran, and K1 at the
    whole utterance's (T no multiple of K1's tile), with times and K1's
    launch configuration (``eval_k1`` and ``eval_k3`` lines);
15. augment: on the host, at one torch thread as in a loader worker, the
    augmentation's worst case for one batch of 32 x 40000 samples and its
    airborne pair: every transform fires, at the slowest pitch step and
    speed factor (each step and factor timed once first), and the peak host
    memory of designing every resampler bank of ``light`` / ``aggressive``
    at 16 kHz with the bytes each keeps; then the resampler's dense and
    banded forms side by side (``resample_forms``): on the host at the
    speed factors, STOI's 16 -> 10 kHz and pitch step -3, on the card at
    48 -> 16 kHz, agreeing within 1e-6 of scale;
16. loader: the published train loaders (``bwe`` with ``light``,
    ``noisybwe`` with ``aggressive``, four workers) as the CLI composes
    them, over 32 batches of the synthetic source: the batches a second
    in steady state against the train phase's step, and 16 batches split
    into the source's items and the collate with its augmentation;
17. npz: the synthetic source written to a temporary directory of npz
    utterances; the data module over it (``light`` augmentation, two
    workers) gives the synthetic source's train, validation and test
    batches byte for byte;
18. melgan_multiscales: ``MelganMultiScalesDiscriminator(16000, scales=3)``
    at full width on b4 x 2.5 s, float32 under ``strict_float32``, card
    against CPU: every scale's resampled input and embeddings within 1e-4
    of scale, the audio gradient through the resamplers within 1e-3 of its
    norm;
19. int8_disc: the opt-in int8 discriminator (``VIBRAVOX_INT8_DISC=1``).
    One eben.yaml bf16 b32 train step with the flag against one without,
    in turns (finite losses and gradient norms, step ms); then at every
    int8 conv shape that step ran at batch 32 (the published EBEN
    discriminator's 18 and its MelGAN's 5) the ``torch._int_mm`` route
    equal in int32 to the exact integer convolution (float64 on the card)
    and to the CPU's int32 twin on its first rows, and its times beside
    cuDNN's bf16 conv (``int8_conv`` lines), with the card's name and
    power limit;
20. cli: this slice's main path.  ``vibravox_tpu_torch.run.main`` with
    ``lightning_datamodule=bwe lightning_module=eben callbacks=bwe_checkpoint``
    and the published default ``logging: tensorboard``, whose event file is
    read back (``core/logging.py::read_events``, every checksum checked): its
    scalars equal the trainer's step by step, train and validation among
    them, and its audio records are 16 kHz WAVs; the synthetic source (64 utterances) with the published
    ``light`` augmentation, two epochs, four validation and four test
    batches, in a temporary run_dir: the K1-K4 and C1 launches of fit and of
    test("last") are asserted (test: K1 and K3 only), with the fit's wall,
    each step's data wait against its time, the test's seconds per batch
    (the eval step on the card, the host metrics, STOI) and the test
    metrics; ``last``, ``index.json`` and the top-2 checkpoints must exist;
    a second run with ``max_epochs=3`` must resume at epoch 2, its Adam
    step counts on the CPU, its train steps timed against the first run's;
21. cli_noisybwe: ``run.main`` with ``lightning_datamodule=noisybwe
    lightning_module=eben callbacks=bwe_checkpoint logging=csv`` on the
    synthetic source (64 utterances) with its published ``aggressive``
    augmentation, fit two epochs then test("last"), four batches of each
    of the ``synthetic`` and ``real`` loaders: K1-K4 and C1 launches asserted, the
    real loader's batches reference-free (no airborne key, no losses, no
    metrics), each step's data wait against its time;
22. stp_parity: the STP slice (wav2vec2-CTC, no hand-written kernel on its
    path) in float32 under ``strict_float32``: the full-width base model
    (seed 0) in eval on 2 x 48000 samples, card against CPU (1e-4 of
    scale); one train step at hidden 256 / 4 layers with the random parts
    off (loss 1e-4 relative, parameters within 1e-2 of the update); the
    CTC loss at the recipe's shapes (value 1e-5 relative, each row's
    gradient within 1e-5 + 1e-6 x its loss);
23. stp_train / stp_profile: ``Trainer.fit`` of the published STP task
    (the base model through the from_pretrained config, reading a local
    checkpoint written from seed 0) on the synthetic ``STPDataModule`` at
    batch 8, bf16-mixed, 28 synchronised steps: step times, audio-s/s,
    padded lengths, data waits, peak memory, model FLOPs and their share of
    the bf16 peak; then a CUDA-only trace of 5 steps by kernel kind, the
    idle share, and the positional conv alone; no K1-K4 launch;
24. cli_stp: ``run.main`` with ``lightning_datamodule=stp
    lightning_module=wav2vec2_for_stp callbacks=stp_checkpoint
    logging=csv`` on the synthetic source, two epochs of two steps, then
    test("last"), then a resumed third epoch: finite ``test/ctc_loss`` and
    ``test/char_error_rate``, the fit's wall, the test seconds per batch
    split into the eval step and the host decode + CER;
25. scripts: ``push_dis_to_hub`` on phase ``cli``'s checkpoint and
    ``upload_phonemizer_to_hub`` on phase ``cli_stp``'s, each export loaded
    back on the card bit-equal; ``test_all_phonemizers`` on the phonemizer
    export (six sensors, two synthetic utterances each, on the card);
    ``sweep --dry-run`` over the three published tables;
26. spkv_parity: the SPKV slice in float32 (IEEE): the full-width ECAPA2
    and ECAPA-TDNN at its default width (seed 0, BatchNorms randomised) on
    2 x 48000 samples of synthetic speech, card against CPU (log-mel
    features within 1e-3 on the bins whose power is at least 1e-6 of their
    frame's largest, embeddings within 1e-4 of scale, one K3 launch a
    forward); ECAPA2's bf16 trunk within 0.08 of scale of its float32; K3
    against its plain version at fft 512 / hop 160 / win 400 at (32, 48000)
    and at a ragged batch-1 trial, with kernel, plain, library and bound
    times of whole wrapper calls, in turns;
27. spkv_embed: bench.py's spkv regime, the full-width ECAPA2 on batches of
    32 x 3 s, 3 warm-up and 20 synchronised batches, bf16 trunk and
    float32: ms a batch, audio-s/s, peak memory, model FLOPs and their
    share of the peak, K3 once a batch and K1, K2, K4 never; a CUDA-only
    trace of 5 batches by kernel kind and the idle share;
28. cli_spkv: ``run.main`` with ``lightning_datamodule=spkv
    lightning_module=ecapa2 logging=csv`` on the synthetic source (120
    trials at batch 1, one loader worker) with the full-width embedder
    from a seed-0 state dict (``checkpoint_path``), then again with
    ``same_gender`` over the pairs of the port's ``gen_pairs_for_spkv``:
    finite EER, threshold, minDCF and distance statistics, K3 twice a trial
    and K1, K2, K4 never, the test's seconds per trial split into the two
    embedder forwards and the host's scoring;
29. mimi_parity: the regressive-Mimi slice (no hand-written kernel on its
    path) in float32 (IEEE): the published ``MimiConfig()`` at full width
    (seed 0) on b2 x 2 s of synthetic speech, card against CPU: latents
    within 1e-4 of scale, the codes' agreement by stage with every flip a
    near tie (the two codes' float64 distances to the CPU's residual within
    1e-4 relative), the decode of the CPU's codes and ``decode_latent`` on
    the rows whose codes all agree within 1e-3 of scale; the bf16 codec
    within 0.1 of scale of its float32;
30. mimi_train: bench.py's mimi regime, ``RegressiveMimiTask`` on the
    full-width bf16 codec, batches of 32 x 2 s, 3 warm-up and 20
    synchronised steps: step ms (median, p10-p90), audio-s/s, peak memory,
    FLOPs over the bf16 peak, the loss falling on the fixed batch, the
    decoder side, quantizer and frozen copy bit-equal after the steps, no
    K1-K4 launch; a CUDA-only trace of 5 steps by kernel kind and the idle
    share;
31. codec: bench.py's codec regime, ``encode_to_latent`` + ``decode_latent``
    of 32 x 2 s in bf16, with the same figures;
32. cli_mimi: ``run.main`` with ``lightning_datamodule=bwe
    lightning_module=regressive_mimi sample_rate=24000
    lightning_datamodule.batch_size=16 logging=csv callbacks=bwe_checkpoint``
    on 32 synthetic utterances with the ``light`` augmentation: fit two
    epochs, test("last") (finite STOI and SI-SDR), a resumed third epoch;
    the fit's wall and the test's seconds per batch split into the eval
    step and the host SE metrics;
33. squim_parity: the SQUIM networks (no hand-written kernel on their
    path) at full width, ``squim_objective_base()`` and
    ``squim_subjective_base()`` (seed 0, norms, PReLU slopes and alpha
    randomised), written as torchaudio-schema state dicts and loaded on the
    card by ``load_squim_predictors``, on 4 x 2.5 s of speech at 16 kHz:
    card against CPU in IEEE float32 (scores and MOS within 1e-4 of
    scale), and the objective's deviation with cuDNN's RNNs left in TF32,
    reported;
34. squim_eval: ``SEMetrics`` with SQUIM at the CLI's test batch (batch 1,
    2.5 s), 3 warm-up and 20 synchronised calls split into the objective,
    the subjective and the rest; the objective alone at 32 x 2.5 s; FLOPs
    from the shapes, device time by kind, idle share and kernels a call;
35. hub_enhance: the full-width EBEN generator saved by
    ``save_eben_generator`` and loaded on the card by
    ``eben_generator_from_pretrained`` (forward bit-equal), then
    ``scripts/eben_enhanced_vibravox.py`` on 8 synthetic test utterances
    on the card (each npz within 1e-5 of scale of the direct forward, K1
    six launches an utterance, seconds an utterance);
36. cli_squim: the CLI's test of phases ``cli`` and ``cli_noisybwe``
    again, on their ``last`` checkpoints, with ``VIBRAVOX_SQUIM_DIR``
    holding the full-width SQUIM weights: ``torchsquim_stoi`` in [0, 1]
    and ``noresqa_mos`` finite (on the noisy CLI's reference-free batches
    too), the K1-K4 launches equal to those phases' tests, the test
    seconds a batch split into SQUIM and the rest;
37. dp_parity: this slice's main path, the parallel layer.  Two processes
    share the card over gloo (NCCL refuses two ranks on one device) and
    run the full-width eben.yaml step through ``DataParallel`` on 16 rows
    each of a global batch of 32 x 2.5 s: in float32 with SGD it equals
    the one-process b32 step at train_parity's bars; then bf16 Adam steps
    at two ranks (step ms p10-p90, the gradient all-reduce's ms and bytes
    a step, K1-K4 6 / 6 / 6 / 6 and C1 32 a step on each rank, counted in the
    ranks); then ``DataParallel`` at world size 1 over NCCL against the
    plain step in one process, the wrapper's own ms;
38. fsdp_tp: two gloo ranks on the card (gloo's CUDA collectives carry
    FSDP2's and DTensor's, checked on the H100): the full-width
    wav2vec2-base STP step (b8 x 3 s, bf16) through plain DP and with
    FSDP2, and the full-width Mimi step (b32 x 2 s, bf16) on a model axis
    of two, each against the one-process step at mimi_parity's bf16 bars
    (loss 1e-2, update 5e-2 of scale), each rank's peak memory and
    parameter bytes beside plain DP's;
39. cli_dp: ``python -m torch.distributed.run --standalone
    --nproc_per_node 1 -m vibravox_tpu_torch.run`` with the EBEN CLI and
    ``logging=csv`` (it reads the CSV's test metrics) over NCCL and the
    default ``trainer.mesh``: fit, test("last"), a resumed epoch and its
    test;
40. weights_day: the port's weights-day runbook
    (``scripts/weights_day.py --stage all --offline-dry-run``) on the card
    in a temporary cache: full-width donors in the published formats
    (EBEN's hub layout, an HF wav2vec2-base directory, ECAPA2 as a
    TorchScript archive, SQUIM's torchaudio-key state dicts, an HF Mimi
    directory), read back and run by ``convert`` (K1 six launches, K3 one),
    then ``spkv_ecapa2_eval`` executed at full width on the staged archive
    (K3 twice a trial) and the other four parity configs composed and
    instantiated: each stage's wall and launches, the manifest's keys, the
    executed EER and minDCF, and the checkpoint variables put back;
41. the ``kernels`` line (all five kernels: K1-K4 and C1), then the
    result line.

A rank of phases 37-38 is ``python3 chip_smoke.py --worker <kind>`` with
the torchrun variables set (``run_workers``); a rank that fails or runs
past its timeout stops every rank and fails the phase.

Phases 3, 7, 9 and 33 change PyTorch's precision settings, and only around the
comparison; the other phases run the port as a user calls it.  Each trace
is taken again, up to four times, until it records every launch of the
hand-written kernels that its run made (``cuda_trace``).
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import tracemalloc
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from vibravox_tpu_torch.core.loop import Trainer
from vibravox_tpu_torch.core.optim import adam, sgd
from vibravox_tpu_torch.data.bwe import BWEDataModule
from vibravox_tpu_torch.data.collate import BWECollate
from vibravox_tpu_torch.data.features import Wav2Vec2FeatureExtractor
from vibravox_tpu_torch.data.phonemes import load_phoneme_tokenizer
from vibravox_tpu_torch.data.sources import SyntheticVibravoxSource
from vibravox_tpu_torch.data.stp import STPCollate, SyntheticSTPSource
from vibravox_tpu_torch.device import strict_float32
from vibravox_tpu_torch.losses.gan import FeatureMatchingLoss, HingeLoss
from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
from vibravox_tpu_torch.models.eben_generator import EBENGenerator
from vibravox_tpu_torch.models.mimi.mimi import ENCODER_SIDE, Mimi
from vibravox_tpu_torch.models.ecapa2 import ECAPA2, ecapa2_from_config
from vibravox_tpu_torch.models.ecapa_tdnn import ECAPATDNN
from vibravox_tpu_torch.models.wav2vec2 import save_pretrained, wav2vec2_for_ctc_from_config
from vibravox_tpu_torch.models.wavlm import wavlm_attention, wavlm_for_ctc_from_config
from vibravox_tpu_torch.ops import _build
from vibravox_tpu_torch.ops import augment
from vibravox_tpu_torch.ops import gated_attention as gattn
from vibravox_tpu_torch.ops.fused_residual import (
    plain_residual_stack,
    plain_residual_stack_backward,
    residual_stack,
    residual_stack_backward,
    residual_stack_backward_config,
    residual_stack_backward_recompute,
    residual_stack_config,
)
from vibravox_tpu_torch.ops.pallas_stft import (
    framed_dft_backward,
    framed_dft_magnitude,
    hann_window,
    plain_framed_dft_backward,
    plain_framed_dft_magnitude,
)
from vibravox_tpu_torch.ops import resample
from vibravox_tpu_torch.ops import strided_group_conv as sgconv
from vibravox_tpu_torch.ops.ctc import ctc_loss
from vibravox_tpu_torch.ops.gated_attention import gated_attention
from vibravox_tpu_torch.ops.resample import KaiserResampler, bank_nbytes, design_band, design_kernel
from vibravox_tpu_torch.ops.stft import MultiResolutionSTFTLoss
from vibravox_tpu_torch.ops.strided_group_conv import strided_group_conv
from vibravox_tpu_torch.serving import EnhanceServer
from vibravox_tpu_torch.tasks.ecapa2_spkv import SPKVTask
from vibravox_tpu_torch.tasks.eben import EBENTask
from vibravox_tpu_torch.tasks.regressive_mimi import RegressiveMimiTask
from vibravox_tpu_torch.tasks.wav2vec2_stp import Wav2Vec2STPTask

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TF32_PEAK_FLOPS = 495e12
# K1 and K2 run their float32 products in 3xTF32, three TF32 products each:
# their float32 bound is the work at 495 / 3 TFLOP/s (the 67 TFLOP/s FMA
# figure stands beside it as fma_ops_ms)
STACK_PEAK_FLOPS = {torch.float32: TF32_PEAK_FLOPS / 3, torch.bfloat16: PEAK_FLOPS[torch.bfloat16]}
HBM_BYTES_PER_S = 3.35e12

BATCH = 8  # serving max_batch
# (stacks, C, T) of the 1 s serving bucket: T = 15840 samples -> 3968 PQMF frames
SERVING_SHAPES = (("enc_0,dec_2", 32, 3968), ("enc_1,dec_1", 64, 1984), ("enc_2,dec_0", 128, 496))
EXTRA_SHAPES = ((3, 64, 1001), (2, 32, 40), (2, 128, 40))  # (B, C, T)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# K1's CUDA kernels: the tensor-core kernel (f32 and bf16) and its weight relayout
K1_KERNELS = ("residual_stack_mma_kernel", "relayout_weights_kernel")
# K2's: the unit forward and backward kernels of both types (f32
# unit_forward_fma_kernel and unit_backward_tf32_kernel, bf16
# unit_*_mma_kernel), the dW reduction and each type's weight layout
K2_KERNELS = ("unit_forward", "unit_backward", "reduce_partials_kernel", "layout_unit_weights")
N_REQUESTS = 64


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def stack_inputs(b: int, c: int, t: int, dtype: torch.dtype, seed: int):
    gen = torch.Generator().manual_seed(seed)
    scale = 0.5 / math.sqrt(3 * c)  # keeps the residual chain O(1)
    x = (torch.randn(b, c, t, generator=gen) * 0.5).to("cuda", dtype)
    ks = tuple(
        ((torch.randn(c, c, 3, generator=gen) * scale).to("cuda", dtype),
         (torch.randn(c, c, 1, generator=gen) * scale).to("cuda", dtype))
        for _ in range(3)
    )
    return x, ks


def cuda_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


TRACE_ATTEMPTS = 4


def cuda_trace(run, whole, what: str):
    """A CUDA-only torch.profiler trace of ``run()`` and its CUDA events.  A
    trace can miss kernels launched at its start, so it is taken again, up
    to TRACE_ATTEMPTS times, until ``whole(events)`` holds: the caller
    compares the kernels it knows the run launches with those recorded.
    Each retry is reported; raises if no attempt is whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if whole(events):
            return prof, events
        emit({"phase": "trace_retry", "trace": what, "attempt": attempt, "cuda_kernels": len(events)})
    raise AssertionError(f"no trace of {what} recorded all its kernels in {TRACE_ATTEMPTS} attempts")


def kernel_kind(name: str) -> str:
    """The kind of a CUDA kernel, from its name, for the profiles' sums."""
    low = name.lower()
    if any(k in name for k in K1_KERNELS):
        return "K1 fused_residual"
    if any(s in name for s in K2_KERNELS):
        return "K2 fused_residual_bwd"
    if "framed_dft_magnitude_kernel" in name:
        return "K3 framed_dft_magnitude"
    if "framed_dft_backward" in name:  # both passes
        return "K4 framed_dft_backward"
    if "strided_group_conv" in name:  # each entry point's two kernels
        return "C1 strided_group_conv"
    if "ctc" in low:
        return "CTC"
    if "rnn" in low or "lstm" in low:
        return "LSTM (cuDNN RNN)"
    if any(s in low for s in ("flash", "fmha", "attention", "efficient")):
        return "attention"
    if "multi_tensor_apply" in low or "adam" in low:
        return "Adam"
    if any(s in low for s in ("nchwtonhwc", "nhwctonchw", "transpose")):
        return "NCHW<->NHWC transposes"
    if any(s in low for s in ("dgrad", "wgrad")) or ("conv" in low and "bwd" in low):
        return "conv backward"
    if any(s in low for s in ("conv", "fprop", "implicit", "cudnn")):
        return "conv forward"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "cublas", "xmma", "sm90_")):
        return "GEMMs"
    if "batch_norm" in low or "batchnorm" in low or "bn_fw" in low:
        return "BatchNorm"
    if "reflection" in low:
        return "reflection pad"
    if "elu" in low:
        return "activations (ELU, GELU, ReLU)"
    if "reduce" in low or "norm" in low:
        return "norms and reductions"
    return "other elementwise (casts, pads, adds, copies)"


LEAD_LAUNCHES = 64


def device_profile(run_one, calls: int, what: str, whole=None) -> dict:
    """Where a call of ``run_one`` spends its time (the caller warms it up
    first): the untraced wall of ``calls`` calls run back to back, then the
    device time of as many more by ``kernel_kind`` from a CUDA-only trace,
    and the device's idle share, all per call.  The idle share is that of
    the busy time, the union of the kernels' intervals: kernels on
    concurrent streams (cuDNN runs an LSTM's two directions so) overlap,
    and their summed time can exceed the wall.  A trace can lose its first
    launches, so the traced calls are led by LEAD_LAUNCHES launches of a
    kind no path runs, left out of the sums, and the trace is taken again
    until one of those is recorded and ``whole(events)``, if given, holds."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        run_one()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / calls
    lead = torch.zeros(1, dtype=torch.int32, device="cuda")

    def traced():
        for _ in range(LEAD_LAUNCHES):
            lead.bitwise_xor_(1)
        for _ in range(calls):
            run_one()

    def recorded(events):
        return any("xor" in e.name.lower() for e in events) and (whole is None or whole(events))

    prof, events = cuda_trace(traced, recorded, what)
    busy, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events if "xor" not in e.name.lower()):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    groups, top, launches = {}, [], 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or "xor" in e.key.lower():
            continue
        launches += e.count
        us = e.self_device_time_total / calls
        groups[kernel_kind(e.key)] = groups.get(kernel_kind(e.key), 0.0) + us
        top.append((us, e.count / calls, e.key[:160]))
    device_us = sum(groups.values())
    if not device_us:
        raise AssertionError(f"the CUDA-only trace of {what} recorded no device time")
    top.sort(reverse=True)
    return {"calls": calls, "wall_us_untraced": wall_us, "device_us": device_us,
            "device_busy_us": busy / calls, "device_idle_share": 1.0 - busy / calls / wall_us,
            "device_kernels": launches / calls,
            "by_kind_us": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"us": us, "per_call": n, "name": nm} for us, n, nm in top[:15]]}


def timed_calls(run_one, n: int) -> list:
    """ms of each of ``n`` calls of ``run_one``, each synchronised."""
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        run_one()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms


def spread(ms: list, warmup: int, audio_s: float, flops: float, dtype=torch.bfloat16) -> dict:
    """The first call, then the median, p10 and p90 of the calls after
    ``warmup``; audio-s/s and the FLOPs' share of ``dtype``'s peak at the
    median."""
    later = ms[warmup:]
    med = float(np.median(later))
    return {"first_ms": ms[0], "ms_median": med, "ms_p10": float(np.percentile(later, 10)),
            "ms_p90": float(np.percentile(later, 90)), "ms": ms, "audio_sec_per_sec_median": audio_s / (med / 1e3),
            "flops": flops, "peak_flops_of_type": PEAK_FLOPS[dtype],
            "flops_share_of_peak_median": flops / (med / 1e3) / PEAK_FLOPS[dtype]}


def stack_bound_ms(b: int, c: int, t: int, dtype: torch.dtype):
    """(operations ms, bytes ms) of one stack: 24 C^2 T B FLOP at the type's
    tensor-core rate (STACK_PEAK_FLOPS); x read and y written once plus the
    six weight tensors read once."""
    flops = 24 * c * c * t * b
    nbytes = (2 * b * c * t + 12 * c * c) * torch.empty((), dtype=dtype).element_size()
    return flops / STACK_PEAK_FLOPS[dtype] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def fma_ms(flops: float) -> float:
    """ms of ``flops`` at the card's 67 TFLOP/s of float32 FMAs (the rate the
    float32 stacks ran at before 3xTF32)."""
    return flops / PEAK_FLOPS[torch.float32] * 1e3


def bound(ops_ms: float, bytes_ms: float):
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def sass_counts(lib_path: str) -> dict:
    """Tensor-core (HMMA), ldmatrix (LDSM) and float32 FMA (FFMA)
    instructions per kernel in a built library's SASS, from ``cuobjdump
    -sass``; keys are the mangled kernel names."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"HMMA": 0, "LDSM": 0, "FFMA": 0}
        elif name is not None:
            for op in ("HMMA", "LDSM", "FFMA"):
                if op in line:
                    counts[name][op] += 1
    return counts


def check_tensor_cores(source: str, counts: dict, mma_kernel: str, fma_kernel: str, ops) -> None:
    """Raises unless the kernels whose names hold ``mma_kernel`` come in
    both types (a kernel is bf16 if its mangled name has the type, f32
    otherwise) and each has every one of ``ops`` in its SASS, and no
    kernel's name holds ``fma_kernel`` (the FMA kernels the tensor-core ones
    replaced)."""
    mma = {k: v for k, v in counts.items() if mma_kernel in k}
    if not any("__nv_bfloat16" in k for k in mma) or all("__nv_bfloat16" in k for k in mma):
        raise AssertionError(f"{source}: its bf16 or f32 {mma_kernel} is not in its SASS: {sorted(counts)}")
    for k, v in mma.items():
        if not all(v[op] for op in ops):
            raise AssertionError(f"{source}: a tensor-core kernel lacks {ops}: {k} {v}")
    fma = [k for k in counts if fma_kernel in k]
    if fma:
        raise AssertionError(f"{source}: an FMA kernel is still built: {fma}")


def check_k2_kernels(source: str, counts: dict) -> dict:
    """Raises unless K2's bf16 unit kernels (``unit_forward_mma_kernel``,
    ``unit_backward_mma_kernel``) have HMMA and LDSM in their SASS, its
    float32 product kernels (``unit_backward_tf32_kernel``: dWp, dh1, dWd
    and dx in 3xTF32, with the recompute of h1 and h2 on FFMAs) have HMMA,
    and its float32 recompute kernels (``unit_forward_fma_kernel``, and
    the timing aid ``unit_backward_tf32_kernel<C, D, false>``) have FFMA
    and no HMMA; and unless none of the float32 FMA kernels they
    replaced (``unit_forward_kernel``, ``unit_backward_kernel``) is left.  Returns
    the float32 kernels' counts."""
    bf16 = {k: v for k, v in counts.items() if "_mma_kernel" in k and "unit_" in k}
    # unit_backward_tf32_kernel<C, D, kProducts>: kProducts = false (Lb0E)
    # is the recompute alone, a timing aid
    products = {k: v for k, v in counts.items() if "unit_backward_tf32_kernel" in k and "Lb1E" in k}
    recompute = {k: v for k, v in counts.items()
                 if "unit_forward_fma_kernel" in k or ("unit_backward_tf32_kernel" in k and "Lb0E" in k)}
    old = [k for k in counts if "unit_forward_kernel" in k or "unit_backward_kernel" in k]
    if len(bf16) < 2 or not products or not recompute:
        raise AssertionError(f"{source}: a bf16 or float32 unit kernel is not in its SASS: {sorted(counts)}")
    for k, v in bf16.items():
        if not (v["HMMA"] and v["LDSM"]):
            raise AssertionError(f"{source}: a bf16 kernel lacks HMMA or LDSM: {k} {v}")
    for k, v in products.items():
        if not v["HMMA"]:
            raise AssertionError(f"{source}: a float32 product kernel has no HMMA: {k} {v}")
    for k, v in recompute.items():
        if v["HMMA"] or not v["FFMA"]:
            raise AssertionError(f"{source}: a float32 recompute kernel is not on FFMAs: {k} {v}")
    if old:
        raise AssertionError(f"{source}: a replaced float32 FMA kernel is still built: {old}")
    return {**products, **recompute}


def check_c1_kernels(source: str, counts: dict) -> None:
    """Raises unless C1's fprop, dgrad and wgrad GEMM kernels (not the
    weight layouts nor wgrad's sum) are built, each plan's with HMMA and
    LDSM in its SASS."""
    for p in SG_PASSES:
        gemms = {k: v for k, v in counts.items() if f"strided_group_conv_{p}_kernel" in k}
        if not gemms:
            raise AssertionError(f"{source}: no {p} kernel in its SASS: {sorted(counts)}")
        for k, v in gemms.items():
            if not (v["HMMA"] and v["LDSM"]):
                raise AssertionError(f"{source}: a {p} kernel lacks HMMA or LDSM: {k} {v}")


def check_c2_kernels(source: str, counts: dict) -> None:
    """Raises unless C2's forward and backward kernels are built, each with
    FFMA and no HMMA in its SASS: IEEE float32 on the FMAs, no TF32."""
    for name in ("gated_attention_forward_kernel", "gated_attention_backward_kernel"):
        found = {k: v for k, v in counts.items() if name in k}
        if not found:
            raise AssertionError(f"{source}: no {name} in its SASS: {sorted(counts)}")
        for k, v in found.items():
            if v["HMMA"] or not v["FFMA"]:
                raise AssertionError(f"{source}: {k} is not on FFMAs alone: {v}")


def phase_build() -> None:
    """Every kernel source, one nvcc each, all started together; the HMMA,
    LDSM and FFMA counts of each kernel.  K1's kernel must run on the
    tensor cores from ldmatrix fragments in both types (float32 in
    3xTF32), and its FMA kernel may not be left; K2's kernels as
    check_k2_kernels holds them, their float32 counts on a line of their
    own; C1's as check_c1_kernels holds them, C2's as check_c2_kernels."""
    t0 = time.perf_counter()
    infos = _build.build_all(_build.SOURCES)
    wall = time.perf_counter() - t0
    for name, info in infos.items():
        counts = sass_counts(info["path"])
        emit({"phase": "build", "source": name, "wall_seconds_all_sources": wall,
              "nvcc_seconds": info["seconds"], "sass_per_kernel": counts,
              "ptxas": [ln.strip() for ln in info["ptxas"].splitlines()
                        if any(w in ln for w in ("Compiling entry", "Used", "spill"))]})
        if name == "fused_residual":
            check_tensor_cores(name, counts, "residual_stack_mma_kernel", "residual_stack_kernel",
                               ("HMMA", "LDSM"))
        elif name == "fused_residual_bwd":
            emit({"phase": "build", "source": name, "float32_kernels": check_k2_kernels(name, counts)})
        elif name == "strided_group_conv":
            check_c1_kernels(name, counts)
        elif name == "gated_attention":
            check_c2_kernels(name, counts)


def k1_config(b: int, c: int, t: int, dtype: torch.dtype) -> dict:
    """K1's launch configuration for a shape, and its waves on this card."""
    cfg = residual_stack_config(b, c, t, dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cfg["waves"] = cfg["grid_x"] * cfg["grid_y"] / (cfg["blocks_per_sm"] * sms)
    return cfg


def phase_k1_parity() -> list:
    """Kernel against plain at every shape; times at the serving shapes.  The
    plain version's float32 convolutions run in IEEE float32, not TF32."""
    rows = []
    shapes = [(BATCH, c, t, name) for name, c, t in SERVING_SHAPES]
    shapes += [(b, c, t, "extra") for b, c, t in EXTRA_SHAPES]
    with torch.inference_mode(), strict_float32():
        for i, (b, c, t, name) in enumerate(shapes):
            for dtype in (torch.float32, torch.bfloat16):
                x, ks = stack_inputs(b, c, t, dtype, seed=i)
                out = residual_stack(x, ks)
                ref = plain_residual_stack(x, ks)
                torch.cuda.synchronize()
                scale = ref.float().abs().max().item()
                err = (out.float() - ref.float()).abs().max().item()
                row = {"stacks": name, "B": b, "C": c, "T": t, "dtype": str(dtype)[6:],
                       "max_abs_err": err, "scale": scale, "tol": TOL[dtype] * scale,
                       "config": k1_config(b, c, t, dtype)}
                if not (math.isfinite(err) and err <= TOL[dtype] * scale):
                    raise AssertionError(f"K1 disagrees with its plain version: {row}")
                if name != "extra":
                    # in turns, kernel then plain, twice; the median of each
                    k_ms, p_ms = [], []
                    for _ in range(2):
                        k_ms.append(cuda_ms(lambda: residual_stack(x, ks)))
                        p_ms.append(cuda_ms(lambda: plain_residual_stack(x, ks)))
                    ops_ms, bytes_ms = stack_bound_ms(b, c, t, dtype)
                    bound_ms, bound_by = bound(ops_ms, bytes_ms)
                    row.update(kernel_ms=float(np.median(k_ms)), plain_ms=float(np.median(p_ms)),
                               ops_ms=ops_ms, bytes_ms=bytes_ms, bound_ms=bound_ms,
                               bound_by=bound_by, fma_ops_ms=fma_ms(24 * c * c * t * b))
                rows.append(row)
                emit({"phase": "k1_parity", **row})
    return rows


def phase_generator_parity() -> None:
    torch.manual_seed(0)
    cpu = EBENGenerator(device="cpu")
    gpu = EBENGenerator(device="cuda")
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    t = cpu.valid_length(16000)
    x = torch.randn(2, t, 1, generator=torch.Generator().manual_seed(1)) * 0.1
    with torch.inference_mode():
        ref_enh, ref_dec = cpu(x)
        enh, dec = gpu(x.cuda())
    torch.cuda.synchronize()
    err_enh = (enh.cpu() - ref_enh).abs().max().item()
    err_dec = (dec.cpu() - ref_dec).abs().max().item()
    emit({"phase": "generator_parity", "T": t, "B": 2,
          "caller_cudnn_conv_fp32_precision": torch.backends.cudnn.conv.fp32_precision,
          "max_abs_err_enhanced": err_enh,
          "max_abs_err_decomposed": err_dec, "tol": 1e-4})
    if not (enh.shape == ref_enh.shape and dec.shape == ref_dec.shape):
        raise AssertionError("generator output shapes differ between the card and the CPU")
    if not (err_enh <= 1e-4 and err_dec <= 1e-4):
        raise AssertionError("the generator on the card disagrees with the CPU")


def phase_serve(compute_dtype) -> int:
    """The main path; returns the K1 launches counted over its requests."""
    torch.manual_seed(0)
    model = EBENGenerator(m=4, n=32, p=2)
    server = EnhanceServer(model, max_batch=BATCH, max_delay_ms=2.0, bucket_seconds=(1.0,),
                           compute_dtype=compute_dtype)
    server.warmup()
    bucket = server.buckets[0]
    rng = np.random.default_rng(0)
    requests = [rng.standard_normal(bucket).astype(np.float32) * 0.1 for _ in range(N_REQUESTS)]

    residual_stack.launches = 0
    t0 = time.perf_counter()
    futs = [server.submit(a) for a in requests]
    outs = [f.result(timeout=300) for f in futs]
    wall = time.perf_counter() - t0
    launches = residual_stack.launches
    stats = server.stats()

    # one served request against the direct forward of the same padded batch
    batch = torch.zeros(BATCH, bucket, 1)
    batch[0, :, 0] = torch.from_numpy(requests[0])
    with torch.inference_mode():
        xb = batch.cuda()
        if compute_dtype is not None:
            xb = xb.to(getattr(torch, compute_dtype))
        direct = model(xb)[0][0, :, 0].float().cpu().numpy()
    served_err = float(np.abs(outs[0] - direct).max())
    server.close()

    tol = 1e-5 if compute_dtype is None else 8e-3 * float(np.abs(direct).max())
    emit({"phase": "serve", "compute_dtype": compute_dtype or "float32", "bucket_samples": bucket,
          "max_batch": BATCH, "requests": N_REQUESTS, "served": stats["served"],
          "dispatches": stats["dispatches"], "k1_launches": launches,
          "latency_p50_ms": stats["latency_p50_ms"], "latency_p95_ms": stats["latency_p95_ms"],
          "audio_sec_per_sec": stats["audio_seconds"] / wall, "wall_s": wall,
          "wall_ms_per_dispatch": wall * 1e3 / stats["dispatches"],
          "served_vs_direct_max_abs_err": served_err, "served_vs_direct_tol": tol})
    if stats["served"] != N_REQUESTS or not all(o.shape == (bucket,) for o in outs):
        raise AssertionError("the server did not answer every request at full length")
    if not all(np.isfinite(o).all() for o in outs):
        raise AssertionError("non-finite enhanced audio")
    if not (launches > 0 and launches == 6 * stats["dispatches"]):
        raise AssertionError(f"K1 launches {launches} != 6 x {stats['dispatches']} dispatches")
    if served_err > tol:
        raise AssertionError("a served request differs from the direct forward")
    return launches


def phase_profile() -> None:
    """Where a batched float32 forward's time goes at the serving bucket
    (``device_profile`` of 20 forwards)."""
    torch.manual_seed(0)
    model = EBENGenerator(m=4, n=32, p=2)
    x = torch.randn(BATCH, model.valid_length(16000), 1, device="cuda") * 0.1
    n_fwd = 20
    with torch.inference_mode():
        for _ in range(3):
            model(x)
        # K1 is two launches a call (the weight relayout, the stack), six
        # calls a forward
        prof = device_profile(lambda: model(x), n_fwd, "the serving forwards", lambda events: sum(
            any(k in e.name for k in K1_KERNELS) for e in events) == 12 * n_fwd)
    emit({"phase": "profile", "B": BATCH, "T": int(x.shape[1]), "dtype": "float32", "per": "forward", **prof})


# ---------------------------------------------------------------------------
# the training slice: K2, K3, K4 and the EBEN GAN train step
# ---------------------------------------------------------------------------

TRAIN_B = 32
TRAIN_T = 39904  # valid_length(40000): 2.5 s crops at 16 kHz
# (stacks, C, T) of the train step: 39904 samples -> 9984 PQMF frames
TRAIN_SHAPES = (("enc_0,dec_2", 32, 9984), ("enc_1,dec_1", 64, 4992), ("enc_2,dec_0", 128, 1248))
K2_EXTRA = ((3, 64, 1001), (2, 32, 40), (2, 128, 40))  # (B, C, T)
# (dx, dW) of scale; bf16 against the float32 plain version on the same
# bf16 values: K2 rounds x1, x2, h1, dh2, dh1 to bf16 (the TPU kernel's
# bf16 semantics), which alone moves dW by 7.8e-2 of scale (emulated on the
# CPU at C = 32, B = 2, T = 700)
K2_TOL = {torch.float32: (1e-4, 2e-4), torch.bfloat16: (5e-2, 1e-1)}
BF16_DW_MIN_ROWS = 1000
RESOLUTIONS = ((512, 50, 240), (1024, 120, 600), (2048, 240, 1200))  # multi_stft.yaml
K3_TOL, K4_TOL = 1e-5, 2e-4
TRAIN_WARMUP, TRAIN_STEPS, PROFILE_STEPS = 3, 10, 5


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def k2_mixed_ms(b: int, c: int, t: int) -> float:
    """The float32 design's own bound (ms): its recompute, 40 C^2 T B FLOP
    (x1 and x2, and each unit's h1 and h2 again in its backward), on FMAs
    at 67 TFLOP/s, plus its gradient products, 48 C^2 T B FLOP, at 3xTF32's
    165 TFLOP/s."""
    work = c * c * t * b
    return (40 * work / PEAK_FLOPS[torch.float32] + 48 * work / STACK_PEAK_FLOPS[torch.float32]) * 1e3


def k2_bound_ms(b: int, c: int, t: int, dtype: torch.dtype):
    """(operations ms, bytes ms) of one stack backward: 72 C^2 T B FLOP (the
    recompute of the forward 24, dx 24, dW 24) at the type's tensor-core
    rate (STACK_PEAK_FLOPS); x and g read, dx written, the weights read and
    the float32 dW written once."""
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = 3 * b * c * t * elt + 12 * c * c * (elt + 4)
    return 72 * c * c * t * b / STACK_PEAK_FLOPS[dtype] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


# K2's CUDA launches in the order of one call: the weight layout first;
# the recompute of x1 and x2, then each unit's backward and its dW
# reduction, units at d = 9, 3, 1
K2_UNIT_PASSES = (("unit_forward d=1", "unit_forward"), ("unit_forward d=3", "unit_forward"),
                  ("unit_backward d=9", "unit_backward"), ("reduce_partials d=9", "reduce_partials_kernel"),
                  ("unit_backward d=3", "unit_backward"), ("reduce_partials d=3", "reduce_partials_kernel"),
                  ("unit_backward d=1", "unit_backward"), ("reduce_partials d=1", "reduce_partials_kernel"))


def k2_passes(dtype: torch.dtype) -> tuple:
    """(label, kernel name part) of each of K2's launches in one call."""
    kernel = "layout_unit_weights_kernel" if dtype == torch.bfloat16 else "layout_unit_weights_f32_kernel"
    return (("layout_unit_weights", kernel),) + K2_UNIT_PASSES


def k2_passes_us(x, ks, g) -> dict:
    """K2's device time by pass (µs), from a CUDA-only torch.profiler trace
    of one call after a warm-up call; the kernels in launch order.  In
    float32 each unit_backward pass is also split into its recompute (h1,
    h2 and dh2 on FMAs: the same pass from a trace of
    residual_stack_backward_recompute, which stops each tile there) and
    its products (dWp, dh1, dWd and dx on 3xTF32 tensor cores: the whole
    pass less its recompute)."""

    def traced(fn, want, what):
        fn()
        torch.cuda.synchronize()

        def passes(events):
            return sorted((e for e in events if any(k in e.name for k in K2_KERNELS)),
                          key=lambda e: e.time_range.start)

        def whole(events):
            ev = passes(events)
            return len(ev) == len(want) and all(k in e.name for (_, k), e in zip(want, ev))

        _, events = cuda_trace(fn, whole, what)
        return {label: e.time_range.elapsed_us() for (label, _), e in zip(want, passes(events))}

    want = k2_passes(x.dtype)
    out = traced(lambda: residual_stack_backward(x, ks, g), want, "one K2 call")
    if x.dtype == torch.float32:
        alone = traced(lambda: residual_stack_backward_recompute(x, ks, g),
                       [p for p in want if "reduce" not in p[1]], "one K2 recompute call")
        for d in (9, 3, 1):
            label = f"unit_backward d={d}"
            out[f"{label} recompute"] = alone[label]
            out[f"{label} products"] = out[label] - alone[label]
    return out


def phase_k2_parity() -> list:
    """K2 against autograd of the plain stack at the training shapes (B = 32)
    and short and ragged T, float32 (the plain side's convolutions in IEEE
    float32) and bfloat16 (against the plain version in float32 on the same
    bf16 values); dW bit-equal across two runs; K1 against its plain version
    at the same shapes and tolerances as in phase_k1_parity; K1 and K2 times
    at the training shapes beside the plain versions', and K2's time by pass
    (k2_passes_us)."""
    rows = []
    shapes = [(TRAIN_B, c, t, name) for name, c, t in TRAIN_SHAPES]
    shapes += [(b, c, t, "extra") for b, c, t in K2_EXTRA]
    with strict_float32():
        for i, (b, c, t, name) in enumerate(shapes):
            for dtype in (torch.float32, torch.bfloat16):
                x, ks = stack_inputs(b, c, t, dtype, seed=100 + i)
                g = (torch.randn(x.shape, generator=torch.Generator().manual_seed(i)) * 0.1).to("cuda", dtype)
                dx, dws = residual_stack_backward(x, ks, g)
                dx2, dws2 = residual_stack_backward(x, ks, g)
                ref_dx, ref_dws = plain_residual_stack_backward(
                    x.float(), tuple((a.float(), w.float()) for a, w in ks), g.float())
                torch.cuda.synchronize()
                flat, flat2 = [w for p in dws for w in p], [w for p in dws2 for w in p]
                bit_equal = torch.equal(dx, dx2) and all(torch.equal(a, w) for a, w in zip(flat, flat2))
                err_dx = rel_err(dx, ref_dx)
                err_dw = max(rel_err(a, r) for a, r in zip(flat, [w for p in ref_dws for w in p]))
                tol_dx, tol_dw = K2_TOL[dtype]
                row = {"stacks": name, "B": b, "C": c, "T": t, "dtype": str(dtype)[6:],
                       "dx_err_over_scale": err_dx, "dx_tol": tol_dx, "dw_err_over_scale": err_dw,
                       "dw_tol": tol_dw, "bit_equal_two_runs": bit_equal}
                # K1 at the same shapes, held as phase_k1_parity holds it
                with torch.inference_mode():
                    y1 = residual_stack(x, ks)
                    ref1 = plain_residual_stack(x, ks)
                torch.cuda.synchronize()
                scale1 = ref1.float().abs().max().item()
                err1 = (y1.float() - ref1.float()).abs().max().item()
                row.update(k1_max_abs_err=err1, k1_scale=scale1, k1_tol=TOL[dtype] * scale1,
                           k1_config=k1_config(b, c, t, dtype),
                           k2_config=residual_stack_backward_config(b, c, t, dtype))
                if not (math.isfinite(err1) and err1 <= TOL[dtype] * scale1):
                    raise AssertionError(f"K1 disagrees with its plain version: {row}")
                # bf16 dW over fewer than BF16_DW_MIN_ROWS rows is reported,
                # not held: the bf16 rounding of x1, x2 and dh1 alone moves
                # such short, cancelling sums by up to 0.36 of scale (the
                # rounding emulated on the CPU: 0.36 at B 2, T 40)
                row["dw_held"] = dtype == torch.float32 or b * t >= BF16_DW_MIN_ROWS
                if not (math.isfinite(err_dx) and err_dx <= tol_dx
                        and (err_dw <= tol_dw or not row["dw_held"])):
                    raise AssertionError(f"K2 disagrees with its plain version: {row}")
                if not bit_equal:
                    raise AssertionError(f"K2 is not bit-equal across two runs: {row}")
                if name != "extra":
                    k2, p2, k1, p1 = [], [], [], []
                    for _ in range(2):  # in turns; the median of each
                        k2.append(cuda_ms(lambda: residual_stack_backward(x, ks, g), iters=10))
                        p2.append(cuda_ms(lambda: plain_residual_stack_backward(x, ks, g), iters=10))
                        with torch.inference_mode():
                            k1.append(cuda_ms(lambda: residual_stack(x, ks), iters=20))
                            p1.append(cuda_ms(lambda: plain_residual_stack(x, ks), iters=20))
                    ops_ms, bytes_ms = k2_bound_ms(b, c, t, dtype)
                    ops1, bytes1 = stack_bound_ms(b, c, t, dtype)
                    passes = k2_passes_us(x, ks, g)
                    row.update(kernel_ms=float(np.median(k2)), plain_ms=float(np.median(p2)),
                               ops_ms=ops_ms, bytes_ms=bytes_ms, fma_ops_ms=fma_ms(72 * c * c * t * b),
                               mixed_ops_ms=k2_mixed_ms(b, c, t) if dtype == torch.float32 else None,
                               k1_kernel_ms=float(np.median(k1)), k1_plain_ms=float(np.median(p1)),
                               k1_ops_ms=ops1, k1_bytes_ms=bytes1, k1_fma_ops_ms=fma_ms(24 * c * c * t * b),
                               k2_passes_us=passes,
                               k2_passes_sum_us=sum(v for k, v in passes.items()
                                                    if not k.endswith(("recompute", "products"))))
                rows.append(row)
                emit({"phase": "k2_parity", **row})
    return rows


def dft_bound_ms(b: int, t: int, fft: int, hop: int, win: int, backward: bool):
    """(operations ms, bytes ms) of K3 or K4, float32.  Operations: an FFT's
    2.5 fft log2(fft) FLOP per real frame for K3, twice that for K4 (the
    spectrum again and the inverse FFT).  Bytes, each once: x read and the
    magnitudes written for K3; x, g and mag read and dx written for K4."""
    frames, bins = 1 + t // hop, fft // 2 + 1
    flops = 2.5 * fft * math.log2(fft) * b * frames * (2 if backward else 1)
    nbytes = 4 * ((2 * b * t + 2 * b * frames * bins) if backward else (b * t + b * frames * bins))
    return flops / PEAK_FLOPS[torch.float32] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


# (B, T, fft, hop, win, silence) held against the plain versions besides the
# train step's shapes: a ragged T, B = 1, T just above fft / 2, hops below 32,
# near silence (x scaled by 1e-7) over `silence` samples from T / 3, longer
# than the window, so whole frames clamp at eps and K4's gom is 0 there, and
# T <= fft / 2, where the reflect pad reflects more than once
K3_K4_EXTRA = ((3, 4001, 512, 50, 240, 0), (1, 7777, 1024, 120, 600, 0), (2, 1025, 2048, 240, 1200, 0),
               (2, 3000, 512, 16, 240, 0), (1, 700, 256, 1, 200, 0), (2, 12000, 512, 50, 240, 2048),
               (2, 12000, 2048, 240, 1200, 4800), (2, 6000, 256, 16, 200, 1024),
               (2, 900, 2048, 240, 1200, 0), (2, 300, 1024, 120, 600, 0))


def check_k3_k4(x, g, fft, hop, win, row) -> torch.Tensor:
    """K3 and K4 against their plain versions on x, and K4 twice on the same
    inputs (bit-equal); raises on a disagreement.  Returns K3's magnitude."""
    mag = framed_dft_magnitude(x, fft, hop, win)
    ref = plain_framed_dft_magnitude(x, fft, hop, win)
    dx = framed_dft_backward(x, mag, g, fft, hop, win)
    dx2 = framed_dft_backward(x, mag, g, fft, hop, win)
    ref_dx = plain_framed_dft_backward(x, g, fft, hop, win)
    torch.cuda.synchronize()
    row.update(k3_err_over_scale=rel_err(mag, ref), k3_tol=K3_TOL, k4_err_over_scale=rel_err(dx, ref_dx),
               k4_tol=K4_TOL, k4_bit_equal_two_runs=torch.equal(dx, dx2),
               clamped_bins=int((ref <= math.sqrt(1e-8)).sum()))
    if not (mag.shape == ref.shape and math.isfinite(row["k3_err_over_scale"]) and row["k3_err_over_scale"] <= K3_TOL):
        raise AssertionError(f"K3 disagrees with its plain version: {row}")
    if not (dx.shape == x.shape and math.isfinite(row["k4_err_over_scale"]) and row["k4_err_over_scale"] <= K4_TOL):
        raise AssertionError(f"K4 disagrees with its plain version: {row}")
    if not row["k4_bit_equal_two_runs"]:
        raise AssertionError(f"K4 is not bit-equal across two runs: {row}")
    return mag


def phase_k3_k4_parity() -> list:
    """K3 and K4 against their plain versions (torch.stft and its autograd)
    at the train step's shapes, B = 32, T = 39904, each resolution, and at
    K3_K4_EXTRA; K4 bit-equal over two runs.  At the train step's shapes,
    whole-wrapper times of the kernel, plain and library calls
    (torch.stft(...).abs() and its backward), in turns."""
    rows = []
    gen = torch.Generator().manual_seed(7)
    for b, t, fft, hop, win, silence in K3_K4_EXTRA:
        x = torch.randn(b, t, generator=gen)
        x[:, t // 3 : t // 3 + silence] *= 1e-7
        g = torch.randn(b, 1 + t // hop, fft // 2 + 1, generator=gen).cuda()
        row = {"fft": fft, "hop": hop, "win": win, "B": b, "T": t, "silence": silence, "extra": True}
        check_k3_k4(x.cuda(), g, fft, hop, win, row)
        if silence and not row["clamped_bins"]:
            raise AssertionError(f"no frame clamped in a silent stretch: {row}")
        emit({"phase": "k3_k4_parity", **row})
    x = (torch.randn(TRAIN_B, TRAIN_T, generator=gen) * 0.1).cuda()
    for fft, hop, win in RESOLUTIONS:
        frames, bins = 1 + TRAIN_T // hop, fft // 2 + 1
        g = (torch.randn(TRAIN_B, frames, bins, generator=gen) * 1e-3).cuda()
        row = {"fft": fft, "hop": hop, "win": win, "B": TRAIN_B, "T": TRAIN_T, "frames": frames, "bins": bins}
        mag = check_k3_k4(x, g, fft, hop, win, row)
        window = hann_window(win, device="cuda")
        xl = x.clone().requires_grad_(True)
        lib = torch.stft(xl, fft, hop_length=hop, win_length=win, window=window, center=True,
                         pad_mode="reflect", return_complex=True).abs()
        glib = g.transpose(1, 2).contiguous()
        times = {k: [] for k in ("k3", "p3", "l3", "k4", "p4", "l4")}
        for _ in range(3):  # in turns; the median of each
            times["k3"].append(cuda_ms(lambda: framed_dft_magnitude(x, fft, hop, win), iters=20))
            times["p3"].append(cuda_ms(lambda: plain_framed_dft_magnitude(x, fft, hop, win), iters=10))
            times["l3"].append(cuda_ms(lambda: torch.stft(
                x, fft, hop_length=hop, win_length=win, window=window, center=True,
                pad_mode="reflect", return_complex=True).abs(), iters=20))
            times["k4"].append(cuda_ms(lambda: framed_dft_backward(x, mag, g, fft, hop, win), iters=20))
            times["p4"].append(cuda_ms(lambda: plain_framed_dft_backward(x, g, fft, hop, win), iters=10))
            times["l4"].append(cuda_ms(lambda: torch.autograd.grad(lib, xl, glib, retain_graph=True),
                                       iters=20))
        med = {k: float(np.median(v)) for k, v in times.items()}
        o3, b3 = dft_bound_ms(TRAIN_B, TRAIN_T, fft, hop, win, backward=False)
        o4, b4 = dft_bound_ms(TRAIN_B, TRAIN_T, fft, hop, win, backward=True)
        row.update(k3_ms=med["k3"], k3_plain_ms=med["p3"], k3_library_ms=med["l3"],
                   k3_ops_ms=o3, k3_bytes_ms=b3,
                   k4_ms=med["k4"], k4_plain_ms=med["p4"], k4_library_ms=med["l4"],
                   k4_ops_ms=o4, k4_bytes_ms=b4,
                   k3_beats_library=med["k3"] < med["l3"], k4_beats_library=med["k4"] < med["l4"],
                   times_ms=times)
        rows.append(row)
        emit({"phase": "k3_k4_parity", **row})
    return rows


# C1, the MelGAN discriminator's grouped stride-4 convolutions (kernel 41,
# padding 20, 4 groups): conv_1 ... conv_4 as (name, C_in, C_out, T_in) of
# the train step, T_in = ceil(TRAIN_T / 4^i)
SG_LAYERS = tuple((f"conv_{i + 1}", c_in, c_out, -(-TRAIN_T // 4 ** i))
                  for i, (c_in, c_out) in enumerate(((16, 64), (64, 256), (256, 1024), (1024, 1024))))
# the bars of the gpu tests, of the reference's largest magnitude: y and dx
# come back in bf16 (its rounding alone is up to 3.9e-3 of a value), dW is
# summed and returned in float32
SG_TOL = {"fprop": 4.5e-3, "dgrad": 4.5e-3, "wgrad": 1e-4}
SG_ROWS_F64 = 2
# calls of each pass a train step at each batch: the generator's phase runs
# the four layers at batch 32 on enhanced and reference (fprop twice) and
# their data gradients for the two balancing norms and its backward (three
# times); the discriminator's phase runs [reference | enhanced] at batch 64
# (fprop, dgrad, wgrad once each)
SG_CALLS_PER_STEP = {(TRAIN_B, "fprop"): 2, (TRAIN_B, "dgrad"): 3,
                     (2 * TRAIN_B, "fprop"): 1, (2 * TRAIN_B, "dgrad"): 1, (2 * TRAIN_B, "wgrad"): 1}
SG_PASSES = ("fprop", "dgrad", "wgrad")
C1_PER_STEP = 4 * sum(SG_CALLS_PER_STEP.values())  # entry-point calls a train step: 32


def sg_conv_backward(dy, x, w, mask):
    """aten's convolution backward of the MelGAN geometry (cuDNN on the card)."""
    return torch.ops.aten.convolution_backward(dy, x, w, None, [4], [20], [1], False, [0], 4, mask)


def sg_reference(x, w, bias, dy) -> dict:
    """(y, dx, dW) of the plain convolution in x's type."""
    return {"fprop": F.conv1d(x, w, bias, 4, 20, 1, 4),
            "dgrad": sg_conv_backward(dy, x, w, [True, False, False])[0],
            "wgrad": sg_conv_backward(dy, x, w, [False, True, False])[1]}


def sg_through_wrapper(x, w, bias, dy) -> dict:
    """(y, dx, dW) through ``strided_group_conv``'s autograd Function: one
    fprop, dgrad and wgrad launch."""
    xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    y = strided_group_conv(xr, wr, bias)
    dx, dw = torch.autograd.grad(y, (xr, wr), dy)
    return {"fprop": y.detach(), "dgrad": dx, "wgrad": dw}


def sg_row(name: str, c_in: int, c_out: int, t: int, b: int, smi: str) -> list:
    """One layer at one batch: each pass of C1 through the wrapper against
    an IEEE float32 convolution of the same bf16 values and, on
    SG_ROWS_F64 batch rows, a float64 one, at SG_TOL; cuDNN's bf16 call and
    the plain twin (``plain_strided_group_conv``, a stride-1 grouped conv
    on cuDNN) beside it; dgrad and wgrad bit-equal twice; then ms a call by
    CUDA events of cuDNN's bf16 call (first: the "before"), the kernel's
    entry point (its weight layout and wgrad's sum pass included) and the
    twin (its backward alone for dgrad and wgrad), and the bound: the larger
    of the operations at the bf16 peak and the bytes (x, y and the float32
    weight once each) at HBM_BYTES_PER_S.  One row a pass."""
    gen = torch.Generator(device="cuda").manual_seed(c_in * 1000 + b)
    x = (torch.randn(b, c_in, t, device="cuda", generator=gen) * 0.5).bfloat16()
    w = torch.randn(c_out, c_in // 4, 41, device="cuda", generator=gen) / math.sqrt(41 * c_in / 4)
    bias = torch.randn(c_out, device="cuda", generator=gen) * 0.1
    t_out = -(-t // 4)
    dy = (torch.randn(b, c_out, t_out, device="cuda", generator=gen) * 0.1).bfloat16()
    wb, bb = w.bfloat16(), bias.bfloat16()
    launches0 = strided_group_conv.launches
    got = sg_through_wrapper(x, w, bias, dy)
    rows = slice(0, SG_ROWS_F64)
    got64 = sg_through_wrapper(x[rows].contiguous(), w, bias, dy[rows].contiguous())
    launches = strided_group_conv.launches - launches0
    with torch.no_grad():
        again = {"dgrad": sgconv._dgrad(dy, w, x.shape), "wgrad": sgconv._wgrad(x, dy, w.shape)}
        lib = sg_reference(x, wb, bb, dy)
        twin = sgconv.plain_strided_group_conv(x, w, bias)
        with strict_float32():
            ref = sg_reference(x.float(), wb.float(), bias, dy.float())
        ref64 = sg_reference(x[rows].double(), wb.double(), bias.double(), dy[rows].double())

    flops = 2.0 * b * t_out * c_out * (c_in // 4) * 41
    nbytes = 2 * x.numel() + 2 * b * c_out * t_out + 4 * w.numel()
    ops_ms, bytes_ms = flops / PEAK_FLOPS[torch.bfloat16] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = bound(ops_ms, bytes_ms)
    xr, wr = x.detach().requires_grad_(True), wb.detach().requires_grad_(True)
    y_dgrad, y_wgrad = sgconv.plain_strided_group_conv(xr, wb), sgconv.plain_strided_group_conv(x, wr)
    calls = {"library": {"fprop": lambda: F.conv1d(x, wb, bb, 4, 20, 1, 4),
                         "dgrad": lambda: sg_conv_backward(dy, x, wb, [True, False, False]),
                         "wgrad": lambda: sg_conv_backward(dy, x, wb, [False, True, False])},
             "kernel": {"fprop": lambda: sgconv._fprop(x, w, bias),
                        "dgrad": lambda: sgconv._dgrad(dy, w, x.shape),
                        "wgrad": lambda: sgconv._wgrad(x, dy, w.shape)},
             "plain": {"fprop": lambda: sgconv.plain_strided_group_conv(x, w, bias),
                       "dgrad": lambda: torch.autograd.grad(y_dgrad, xr, dy, retain_graph=True),
                       "wgrad": lambda: torch.autograd.grad(y_wgrad, wr, dy, retain_graph=True)}}
    ms = {what: {p: cuda_ms(fns[p]) for p in SG_PASSES} for what, fns in calls.items()}
    del y_dgrad, y_wgrad
    out = []
    for p in SG_PASSES:
        err, err64 = rel_err(got[p], ref[p]), rel_err(got64[p], ref64[p])
        row = {"phase": "sgconv_parity", "card": smi, "layer": name, "B": b, "C_in": c_in, "C_out": c_out,
               "T_in": t, "T_out": t_out, "pass": p, "calls_per_step": SG_CALLS_PER_STEP.get((b, p), 0),
               "kernel_ms": ms["kernel"][p], "plain_ms": ms["plain"][p], "library_ms": ms["library"][p],
               "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "kernel_tflops": flops / ms["kernel"][p] / 1e9,
               "err_over_scale": err, "err_over_scale_f64": err64, "tol": SG_TOL[p],
               "library_err_over_scale": rel_err(lib[p], ref[p]),
               "bit_equal_twice": bool(torch.equal(got[p], again[p])) if p in again else None,
               "wrapper_launches": launches}
        if p == "fprop":
            row["plain_err_over_scale"] = rel_err(twin, ref[p])
        out.append(row)
        emit(row)
        if not (err <= SG_TOL[p] and err64 <= SG_TOL[p]) or got[p].shape != ref[p].shape:
            raise AssertionError(f"C1's {p} differs from the plain convolution: {row}")
        if row["bit_equal_twice"] is False:
            raise AssertionError(f"C1's {p} is not bit-equal across two runs: {row}")
    if launches != 6:
        raise AssertionError(f"{launches} C1 launches for two forward and backward calls, not 6")
    return out


def phase_sgconv_parity(smi: str) -> list:
    """C1 at the train step's shapes: ``sg_row`` for conv_1 ... conv_4 at
    batch 32 and 64, then one line of the per-step sums
    (SG_CALLS_PER_STEP)."""
    rows = [r for b in (TRAIN_B, 2 * TRAIN_B) for layer in SG_LAYERS for r in sg_row(*layer, b, smi)]
    emit({"phase": "sgconv_step", "card": smi, **sg_per_step(rows)})
    return rows


def sg_per_step(rows) -> dict:
    """C1's kernel, plain-twin, library and bound ms a train step, whole and
    by pass, each call weighted by SG_CALLS_PER_STEP."""
    keys = (("kernel_ms", "kernel_ms"), ("plain_ms", "plain_ms"), ("library_ms", "library_ms"))
    weighted = [r for r in rows if r["calls_per_step"]]
    out = {"per": "per train step: batch 32, 2.5 s, bfloat16", "calls": sum(r["calls_per_step"] for r in weighted)}
    out.update(summed([r for r in weighted for _ in range(r["calls_per_step"])], keys, "ops_ms", "bytes_ms"))
    out["by_pass"] = {p: summed([r for r in weighted if r["pass"] == p for _ in range(r["calls_per_step"])],
                                keys, "ops_ms", "bytes_ms") for p in SG_PASSES}
    return out


# C2, WavLM's gated relative-position attention, at the WavLM cell's shape:
# batch 8 of utterances padded to 320000 samples (999 frames), 16 heads of
# 64; 24 layers a train step, each one forward and one backward call
GA_SHAPE = (8, 16, 999)
GA_CALLS_PER_STEP = 24
GA_OUTPUTS = ("out", "dq", "dk", "dv", "dgate", "ddiag")
# each output's largest gap over the float64 twin's largest magnitude
GA_TOL = 5e-5


def ga_inputs(b: int, h: int, t: int, seed: int):
    """q, k, v as the model hands them over (views of (B, T, H, 64)
    projections), N(0, 1); the gate in (1, 3), as a (b c - 1) + 2 gives it
    at c = 1; D N(0, 1), as ``rel_attn_embed``; the output's gradient."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, t, h, 64, device="cuda", generator=gen).transpose(1, 2) for _ in range(3))
    gate = 1.0 + 2.0 * torch.rand(b, h, t, device="cuda", generator=gen)
    diag = torch.randn(h, 2 * t - 1, device="cuda", generator=gen)
    dout = torch.randn(b, t, h, 64, device="cuda", generator=gen).transpose(1, 2)
    return q, k, v, gate, diag, dout


def ga_through(fn, q, k, v, gate, diag, dout) -> dict:
    """fn's output and the five gradients by autograd."""
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v, gate, diag)]
    out = fn(*leaves)
    return dict(zip(GA_OUTPUTS, [out.detach(), *torch.autograd.grad(out, leaves, dout)]))


def ga_library(q, k, v, gate, diag):
    """The library route WavLM takes off the kernel: the (B, H, T, T) gated
    bias made from P and handed to SDPA as its float mask."""
    t = q.shape[-2]
    pos = torch.arange(t, device=q.device)
    table = diag[:, pos[None, :] - pos[:, None] + t - 1]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=gate[..., None] * table)


def phase_gated_attention_parity(smi: str) -> dict:
    """C2 at the WavLM cell's shape (GA_SHAPE): the forward and the five
    gradients through ``gated_attention``'s autograd Function against the
    float64 plain twin (each within GA_TOL of its largest magnitude), beside
    the library route's errors (SDPA on the materialised bias, float32);
    every output bit-equal over two runs; then ms a call by CUDA events of
    the kernel's forward and backward entry points, the library route's
    (the bias made, SDPA, and its gradients to q, k, v, the gate and P) and
    the plain twin's in float32, beside the bounds: 2 products of 2 B H T^2
    64 FLOP forward and 5 backward at the 67 TFLOP/s of float32 FMAs (the
    kernel's own), and at TF32's 495 (``portbench/count/attention.py``'s);
    the sums a train step (GA_CALLS_PER_STEP layers)."""
    b, h, t = GA_SHAPE
    q, k, v, gate, diag, dout = ga_inputs(b, h, t, seed=2026)
    launches0 = gated_attention.launches
    got = ga_through(gated_attention, q, k, v, gate, diag, dout)
    again = ga_through(gated_attention, q, k, v, gate, diag, dout)
    launches = gated_attention.launches - launches0
    with strict_float32():
        lib = ga_through(ga_library, q, k, v, gate, diag, dout)
    ref = ga_through(gattn.plain_gated_attention, *(x.double() for x in (q, k, v, gate, diag, dout)))
    torch.cuda.synchronize()
    errs = {n: rel_err(got[n], ref[n]) for n in GA_OUTPUTS}
    lib_errs = {n: rel_err(lib[n], ref[n]) for n in GA_OUTPUTS}
    bit_equal = {n: bool(torch.equal(got[n], again[n])) for n in GA_OUTPUTS}
    del ref, lib, again

    with torch.no_grad():
        out, lse = gattn._forward(q, k, v, gate, diag)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v, gate[..., None], diag)]
    pos = torch.arange(t, device="cuda")
    table = leaves[4][:, pos[None, :] - pos[:, None] + t - 1].detach().requires_grad_(True)

    def lib_forward():
        return F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3] * table)

    def twin_forward():
        return gattn.plain_gated_attention(leaves[0], leaves[1], leaves[2], leaves[3][..., 0], leaves[4])

    with strict_float32():
        y_lib, y_twin = lib_forward(), twin_forward()
        ms = {"kernel_forward": cuda_ms(lambda: gattn._forward(q, k, v, gate, diag), 20),
              "kernel_backward": cuda_ms(lambda: gattn._backward(q, k, v, gate, diag, out, dout, lse), 10),
              "library_forward": cuda_ms(lib_forward, 10),
              "library_backward": cuda_ms(lambda: torch.autograd.grad(
                  y_lib, leaves[:4] + [table], dout, retain_graph=True), 5),
              "plain_forward": cuda_ms(twin_forward, 5),
              "plain_backward": cuda_ms(lambda: torch.autograd.grad(y_twin, leaves, dout, retain_graph=True), 3)}
    del y_lib, y_twin
    product = 2.0 * b * h * t * t * 64
    rows, elem = b * h * t * 64, 4
    work = {"forward": (2 * product, elem * (4 * rows + 2 * b * h * t + h * (2 * t - 1))),
            "backward": (5 * product, elem * (8 * rows + 3 * b * h * t + 2 * h * (2 * t - 1)))}
    row = {"phase": "gated_attention_parity", "card": smi, "B": b, "H": h, "T": t, "head_dim": 64,
           "err_over_scale": errs, "library_err_over_scale": lib_errs, "tol": GA_TOL,
           "bit_equal_twice": bit_equal, "wrapper_launches": launches, "ms": ms}
    for p, (flops, nbytes) in work.items():
        row[p] = {"kernel_ms": ms[f"kernel_{p}"], "library_ms": ms[f"library_{p}"], "plain_ms": ms[f"plain_{p}"],
                  "fma_ops_ms": flops / PEAK_FLOPS[torch.float32] * 1e3, "tf32_ops_ms": flops / TF32_PEAK_FLOPS * 1e3,
                  "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                  "kernel_tflops": flops / ms[f"kernel_{p}"] / 1e9, "library_tflops": flops / ms[f"library_{p}"] / 1e9}
    row["per_train_step"] = {
        "calls": 2 * GA_CALLS_PER_STEP,
        **{k: GA_CALLS_PER_STEP * (row["forward"][k] + row["backward"][k])
           for k in ("kernel_ms", "library_ms", "plain_ms", "fma_ops_ms", "tf32_ops_ms", "bytes_ms")}}
    emit(row)
    if not all(e <= GA_TOL for e in errs.values()):
        raise AssertionError(f"C2 differs from the float64 twin: {errs}")
    if not all(bit_equal.values()):
        raise AssertionError(f"C2 is not bit-equal across two runs: {bit_equal}")
    if launches != 4:
        raise AssertionError(f"{launches} C2 launches for two forward and backward calls, not 4")
    return row


# The WavLM cell's batch: 8 utterances of 12-20 s padded to 320000
# samples, ~10 phoneme ids a second padded to 256; its first step held to
# the library route by the cell's own limits
# (portbench/limits/wavlm_large_stp_train_b8_long.json)
WAVLM_SAMPLES, WAVLM_LABELS = 320000, 256
WAVLM_LOSS_GAP, WAVLM_GRAD_NORM_GAP = 1.5e-6, 3e-3


def wavlm_batch(device) -> dict:
    gen = torch.Generator().manual_seed(2026)
    seconds = torch.arange(13, 21)  # one utterance of 13-20 s each, the last at the padded length
    audio = 0.1 * torch.randn(GA_SHAPE[0], WAVLM_SAMPLES, generator=gen)
    audio *= torch.arange(WAVLM_SAMPLES)[None, :] < 16000 * seconds[:, None]
    ids = torch.randint(0, 33, (GA_SHAPE[0], WAVLM_LABELS), generator=gen)
    ids = ids.masked_fill(torch.arange(WAVLM_LABELS)[None, :] >= 10 * seconds[:, None], -100)
    return {"audio": audio.to(device), "phonemes_ids": ids.to(device)}


def wavlm_route_step(task, batch, init: dict, seed: int) -> dict:
    """One ``train_step`` from ``init`` and a fresh optimizer at step 0:
    its loss, each trained leaf's gradient, and the launch counts and
    WavLM's attention counters over that step alone."""
    model = task.wav2vec2_for_ctc
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n])
    state = task.init_state(seed)
    before = wavlm_attention.calls, wavlm_attention.fused_calls, wavlm_attention.bias_elements
    reset_counts()
    _, logs = task.train_step(state, batch)
    launches = read_counts()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
    return {"loss": float(logs["train/ctc_loss"]), "grads": grads, "launches": launches,
            "attention_calls": wavlm_attention.calls - before[0],
            "fused_calls": wavlm_attention.fused_calls - before[1],
            "bias_elements": wavlm_attention.bias_elements - before[2]}


def grad_gaps(got: dict, want: dict) -> dict:
    """The gap of each leaf's gradient norm, |got| against |want| as the
    cell's ``grad_norm_gap`` takes it (the median leaf), the worst leaf's,
    and the whole gradient's difference over its norm."""
    if set(got) != set(want):
        raise AssertionError(f"the routes train other leaves: {sorted(set(got) ^ set(want))}")
    gaps = {n: abs(float(got[n].norm()) - float(w.norm())) / max(float(w.norm()), 1e-30) for n, w in want.items()}
    diff = math.sqrt(sum(float((got[n] - w).square().sum()) for n, w in want.items()))
    whole = math.sqrt(sum(float(w.square().sum()) for w in want.values()))
    worst = max(gaps, key=gaps.get)
    return {"grad_norm_gap": float(np.median(list(gaps.values()))), "worst_leaf": worst,
            "worst_grad_norm_gap": gaps[worst], "grad_diff_over_norm": diff / whole}


def phase_wavlm_step(smi: str) -> dict:
    """WavLM-Large's train step at the cell's shape on the kernel's route
    and on the library's, from the same weights and step generator (see
    9c. in the module's docstring)."""
    b, h, t = GA_SHAPE
    model = wavlm_for_ctc_from_config(preset="large", seed=0, device="cuda")
    task = Wav2Vec2STPTask(wav2vec2_for_ctc=model, optimizer=adam(3e-4, betas=(0.5, 0.9)), sample_rate=16000,
                           freeze_feature_encoder=True, device="cuda")
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = wavlm_batch("cuda")
    routes = {}
    for route in ("kernel", "library"):
        torch.cuda.reset_peak_memory_stats()
        with contextlib.nullcontext() if route == "kernel" else mock.patch.object(gattn, "takes", lambda *a: False):
            routes[route] = wavlm_route_step(task, batch, init, seed=0)
        torch.cuda.synchronize()
        routes[route]["memory_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    kernel, library = routes["kernel"], routes["library"]
    gaps = grad_gaps(kernel.pop("grads"), library.pop("grads"))
    loss_gap = abs(kernel["loss"] - library["loss"]) / abs(library["loss"])
    row = {"phase": "wavlm_step", "card": smi, "B": b, "samples": WAVLM_SAMPLES, "frames": t, "heads": h,
           "kernel": kernel, "library": library, "loss_gap": loss_gap, **gaps,
           "limits": {"loss_gap": WAVLM_LOSS_GAP, "grad_norm_gap": WAVLM_GRAD_NORM_GAP}}
    emit(row)
    layers = GA_CALLS_PER_STEP
    want = {"kernel": ({"K1": 0, "K2": 0, "K3": 0, "K4": 0, "C1": 0, "C2": 2 * layers}, layers, layers, 0),
            "library": ({"K1": 0, "K2": 0, "K3": 0, "K4": 0, "C1": 0, "C2": 0}, layers, 0, layers * b * h * t * t)}
    for route, r in routes.items():
        got = (r["launches"], r["attention_calls"], r["fused_calls"], r["bias_elements"])
        if got != want[route]:
            raise AssertionError(f"WavLM's {route} route counted {got}, not {want[route]}")
    if not (math.isfinite(kernel["loss"]) and loss_gap <= WAVLM_LOSS_GAP
            and gaps["grad_norm_gap"] <= WAVLM_GRAD_NORM_GAP):
        raise AssertionError(f"WavLM's kernel route differs from the library route: loss {kernel['loss']} "
                             f"against {library['loss']}, {gaps}")
    del task, model, init, batch
    torch.cuda.empty_cache()
    return row


def make_task(device, *, small: bool, optimizer, compute_dtype=None, ratio: float = 1.0):
    """The eben.yaml task.  ``small``: the CPU tests' sizes (discriminator
    q = 4 / min_channels = 8, one STFT resolution 512/50/240); otherwise the
    full configuration (q = 4 / min_channels = 24, the three multi_stft.yaml
    resolutions).  Modules are made on the CPU from torch's default
    generator and moved, so one seed gives one set of weights anywhere."""
    res = RESOLUTIONS[:1] if small else RESOLUTIONS
    return EBENTask(
        sample_rate=16000,
        generator=EBENGenerator(m=4, n=32, p=2, device="cpu"),
        discriminator=DiscriminatorEBENMultiScales(q=4, min_channels=8 if small else 24, device="cpu"),
        generator_optimizer=optimizer,
        discriminator_optimizer=optimizer,
        reconstructive_loss_freq_fn=MultiResolutionSTFTLoss(
            [r[0] for r in res], [r[1] for r in res], [r[2] for r in res], sample_rate=16000,
            perceptual_weighting=True, device=device),
        feature_matching_loss_fn=FeatureMatchingLoss(),
        adversarial_loss_fn=HingeLoss(),
        dynamic_loss_balancing="ema",
        beta_ema=0.9,
        update_discriminator_ratio=ratio,
        compute_dtype=compute_dtype,
        device=device,
    )


def reset_counts() -> None:
    residual_stack.launches = residual_stack_backward.launches = 0
    framed_dft_magnitude.launches = framed_dft_backward.launches = 0
    strided_group_conv.launches = gated_attention.launches = 0


def read_counts() -> dict:
    """The wrappers' launch counters: K1-K4, C1's entry-point calls (fprop,
    dgrad and wgrad each count one) and C2's (WavLM's gated attention: its
    forward and its backward each count one)."""
    return {"K1": residual_stack.launches, "K2": residual_stack_backward.launches,
            "K3": framed_dft_magnitude.launches, "K4": framed_dft_backward.launches,
            "C1": strided_group_conv.launches, "C2": gated_attention.launches}


def phase_train_parity() -> None:
    """One seeded float32 step at the CPU tests' sizes on the card (K1-K4)
    against the same step on the CPU (the plain versions).  SGD (lr 1e-2),
    so a parameter's update is proportional to its gradient: the two sides'
    parameters differ by at most 1e-2 of the step's update (Frobenius,
    per tensor); the losses agree to 1e-4 relative."""
    torch.manual_seed(0)
    cpu = make_task("cpu", small=True, optimizer=sgd(1e-2))
    gpu = make_task("cuda", small=True, optimizer=sgd(1e-2))
    gpu.generator.load_state_dict(cpu.generator.state_dict(), strict=True)
    gpu.discriminator.load_state_dict(cpu.discriminator.state_dict(), strict=True)
    before = {k: v.detach().clone() for k, v in cpu.generator.state_dict().items()}
    before.update({f"disc.{k}": v.detach().clone() for k, v in cpu.discriminator.state_dict().items()})
    t = cpu.generator.valid_length(4096)
    ref = torch.from_numpy(np.random.default_rng(7).standard_normal((2, t, 1)).astype(np.float32) * 0.1)
    batch = {"audio_body_conducted": ref * 0.5, "audio_airborne": ref}
    s_cpu, s_gpu = cpu.init_state(0), gpu.init_state(0)
    _, logs_cpu = cpu.train_step(s_cpu, batch)
    reset_counts()
    _, logs_gpu = gpu.train_step(s_gpu, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    counts = read_counts()
    loss_err = max(abs(float(logs_gpu[k]) - float(v)) / max(abs(float(v)), 1e-12) for k, v in logs_cpu.items())
    after_cpu = dict(cpu.generator.state_dict())
    after_cpu.update({f"disc.{k}": v for k, v in cpu.discriminator.state_dict().items()})
    after_gpu = dict(gpu.generator.state_dict())
    after_gpu.update({f"disc.{k}": v for k, v in gpu.discriminator.state_dict().items()})
    worst, bad = 0.0, []
    for k, b0 in before.items():
        if "pqmf." in k:
            continue
        diff = (after_gpu[k].cpu() - after_cpu[k]).norm().item()
        step = (after_cpu[k] - b0).norm().item()
        if diff > 1e-2 * step + 1e-7:  # a tensor with no update must stay put
            bad.append(k)
        if step > 0:
            worst = max(worst, diff / step)
    emit({"phase": "train_parity", "B": 2, "T": t, "losses_max_rel_err": loss_err, "losses_tol": 1e-4,
          "params_max_diff_over_update": worst, "params_tol": 1e-2, "params_out_of_tol": bad,
          "launches": counts,
          "logs_gpu": {k: float(v) for k, v in logs_gpu.items()}})
    if not loss_err <= 1e-4:
        raise AssertionError("the train step's losses on the card differ from the CPU's")
    if bad:
        raise AssertionError("the train step's parameters on the card differ from the CPU's")
    if counts != {"K1": 6, "K2": 6, "K3": 2, "K4": 2, "C1": 0, "C2": 0}:  # float32: the MelGAN convs on cuDNN
        raise AssertionError(f"unexpected kernel launches in one small train step: {counts}")


def phase_train() -> dict:
    """The main path: Trainer.fit with the full eben.yaml task at batch 32
    on 2.5 s synthetic crops, bfloat16 compute.  A warm-up fit of
    TRAIN_WARMUP steps, then the counts are reset and a second fit of
    TRAIN_STEPS steps is timed and counted."""
    torch.manual_seed(0)
    task = make_task("cuda", small=False, optimizer=adam(3e-4, betas=(0.5, 0.9)),
                     compute_dtype="bfloat16")
    dm = BWEDataModule(sample_rate=16000, dataset_name_principal="synthetic",
                       collate_strategy="constant_length-2500-ms", batch_size=TRAIN_B,
                       num_workers=6, synthetic_size=TRAIN_B * (TRAIN_STEPS + 1), seed=42)
    trainer = Trainer(max_epochs=1, log_every_n_steps=1, limit_train_batches=TRAIN_WARMUP,
                      limit_val_batches=0, sync_every_step=True)
    trainer.fit(task, dm)
    warm_logs = len(trainer.logged)
    gen0 = [p.detach().clone() for p in task.generator.parameters()]
    disc0 = [p.detach().clone() for p in task.discriminator.parameters()]
    trainer.max_epochs, trainer.limit_train_batches = 2, TRAIN_STEPS
    trainer.step_seconds.clear()
    trainer.data_wait_seconds.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trainer.fit(task, dm)
    counts = read_counts()
    steps = [lg for _, lg in trainer.logged[warm_logs:] if "train/generator/backprop_loss" in lg]
    epoch = trainer.logged[-1][1]
    gen_moved = any(not torch.equal(a, p) for a, p in zip(gen0, task.generator.parameters()))
    disc_moved = any(not torch.equal(a, p) for a, p in zip(disc0, task.discriminator.parameters()))
    step_ms = [s * 1e3 for s in trainer.step_seconds]
    wait_ms = [s * 1e3 for s in trainer.data_wait_seconds]
    # the first batch's wait holds the loader's start (new workers, their
    # first batches made from nothing); the steps after it show whether the
    # loader keeps up with the step
    audio_s = TRAIN_B * TRAIN_T / 16000
    after_first_s = (sum(wait_ms[1:]) + sum(step_ms[1:])) / 1e3
    out = {"phase": "train", "B": TRAIN_B, "T": TRAIN_T, "compute_dtype": "bfloat16",
           "steps": len(steps), "launches": counts,
           "launches_per_step": {k: v / max(len(steps), 1) for k, v in counts.items()},
           "step_ms_median": float(np.median(step_ms)), "step_ms": step_ms,
           "audio_sec_per_sec_epoch": epoch["train/audio_seconds_per_second"],
           "audio_sec_per_sec_steps": audio_s / (np.median(step_ms) / 1e3),
           "epoch_wall_s": epoch["train/epoch_wall_seconds"],
           "first_batch_wait_ms": wait_ms[0] if wait_ms else None,
           "data_wait_ms_median_after_first": float(np.median(wait_ms[1:])) if len(wait_ms) > 1 else None,
           "data_wait_ms": wait_ms,
           "audio_sec_per_sec_after_first_batch": (len(wait_ms) - 1) * audio_s / after_first_s
           if len(wait_ms) > 1 else None,
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "first_step_logs": steps[0] if steps else None, "last_step_logs": steps[-1] if steps else None,
           "generator_moved": gen_moved, "discriminator_moved": disc_moved}
    emit(out)
    if len(steps) != TRAIN_STEPS:
        raise AssertionError(f"the timed fit ran {len(steps)} steps, not {TRAIN_STEPS}")
    if not all(math.isfinite(v) for lg in steps for v in lg.values()):
        raise AssertionError("a loss of the train step is not finite")
    if not (gen_moved and disc_moved):
        raise AssertionError("the train step did not move both networks' parameters")
    # per step: K1 6 (one per fused stack of the generator forward), K2 6
    # (the backward of Σλ·L; the balancing gradients stop at the last conv),
    # K3 6 (3 resolutions x enhanced and reference), K4 6 (3 resolutions,
    # enhanced only, once for the STFT loss's balancing norm and once in
    # the backward of Σλ·L); C1 32 (SG_CALLS_PER_STEP's calls of the four
    # MelGAN layers: 12 fprop, 16 dgrad, 4 wgrad)
    want = {**{k: 6 * TRAIN_STEPS for k in ("K1", "K2", "K3", "K4")}, "C1": C1_PER_STEP * TRAIN_STEPS, "C2": 0}
    if counts != want:
        raise AssertionError(f"kernel launches {counts} on the main path, expected {want}")
    return out


# CUDA launches of each hand-written kernel in one train step: six calls of
# each of K1-K4; a bf16 K1 call is two launches (the weight relayout, the
# stack), a K2 call is k2_passes, a K3 call one, a K4 call two (frames,
# then the sum); C1's 32 calls two each (fprop and dgrad: the weight
# layout, then the GEMM; wgrad: the GEMM's partials, then their sum)
TRAIN_KERNEL_LAUNCHES = {"K1 fused_residual": 12, "K2 fused_residual_bwd": 6 * len(k2_passes(torch.bfloat16)),
                         "K3 framed_dft_magnitude": 6, "K4 framed_dft_backward": 12,
                         "C1 strided_group_conv": 2 * C1_PER_STEP}


def phase_train_profile() -> dict:
    """Where a train step's time goes (full task, batch 32, bf16):
    ``device_profile`` of PROFILE_STEPS steps on one device batch."""
    torch.manual_seed(0)
    task = make_task("cuda", small=False, optimizer=adam(3e-4, betas=(0.5, 0.9)),
                     compute_dtype="bfloat16")
    state = task.init_state(0)
    gen = torch.Generator().manual_seed(3)
    ref = torch.randn(TRAIN_B, TRAIN_T, 1, generator=gen) * 0.1
    batch = {"audio_body_conducted": (ref * 0.5).cuda(), "audio_airborne": ref.cuda()}
    for _ in range(2):
        task.train_step(state, batch)

    def whole(events):
        counts: dict = {}
        for e in events:
            counts[kernel_kind(e.name)] = counts.get(kernel_kind(e.name), 0) + 1
        return all(counts.get(k, 0) == n * PROFILE_STEPS for k, n in TRAIN_KERNEL_LAUNCHES.items())

    out = {"phase": "train_profile", "B": TRAIN_B, "T": TRAIN_T, "compute_dtype": "bfloat16", "per": "step",
           **device_profile(lambda: task.train_step(state, batch), PROFILE_STEPS, "the train steps", whole)}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the workflow slice: the eval path and the CLI
# ---------------------------------------------------------------------------

# a whole 5.7 s synthetic test utterance, an extra shape beside the CLI's
# test batch: its residual stacks run at T = 22848 / 11424 / 2856 (K1's
# f32 second tiles, 72 / 40 / 16, leave 24 / 24 / 8 rows in the last tile)
EVAL_UTTERANCE = 6
# the published default logging (tensorboard): phase cli reads its event files back
CLI_ARGS = ("lightning_datamodule=bwe", "lightning_module=eben", "callbacks=bwe_checkpoint",
            "lightning_datamodule.dataset_name_principal=synthetic",
            "++lightning_datamodule.synthetic_size=64",
            "++trainer.limit_val_batches=4", "++trainer.limit_test_batches=4")
CLI_STEPS_PER_EPOCH, CLI_VAL_BATCHES, CLI_TEST_BATCHES = 2, 4, 4  # 64 utterances at batch 32


def cli_test_batch() -> dict:
    """The first batch of the CLI's test loader: the data module that
    ``run.main(CLI_ARGS)`` makes, after ``setup("test")`` (batch 1, the eval
    collate's centred 2.5 s crop).  Its loader runs in this process
    (num_workers 0); the eval collate is deterministic either way."""
    from vibravox_tpu_torch import run
    from vibravox_tpu_torch.core.config import compose, instantiate

    cfg = compose(run.CONFIG_DIR, "run", list(CLI_ARGS))
    run.port_targets(cfg, "cuda")
    datamodule = instantiate(dict(cfg.lightning_datamodule, num_workers=0))
    datamodule.setup("test")
    return next(iter(datamodule.test_dataloader()))


def record_shapes(run) -> tuple:
    """(B, C, T) of every fused residual stack the generator runs in
    ``run()``, and (B, T, fft, hop, win) of every framed-DFT magnitude the
    STFT loss takes there."""
    import vibravox_tpu_torch.models.eben_generator as generator_module
    import vibravox_tpu_torch.ops.stft as stft_module

    stacks, dfts = [], []
    originals = generator_module.residual_stack, stft_module.framed_dft_magnitude

    def stack(x, *args, **kwargs):
        stacks.append(tuple(x.shape))
        return originals[0](x, *args, **kwargs)

    def dft(x, fft, hop, win, *args, **kwargs):
        dfts.append((*x.shape, fft, hop, win))
        return originals[1](x, fft, hop, win, *args, **kwargs)

    generator_module.residual_stack, stft_module.framed_dft_magnitude = stack, dft
    try:
        run()
    finally:
        generator_module.residual_stack, stft_module.framed_dft_magnitude = originals
    return stacks, dfts


def eval_step_parity(cpu, gpu, states, batch, label: str) -> tuple:
    """The eval step on ``batch`` on the card against the CPU: the logs
    within 1e-4 relative, the enhanced audio within 1e-4 of its scale, K1
    and K3 six launches each, no K2 or K4.  Returns the stack and framed-DFT
    shapes the card's step ran."""
    want = cpu.eval_step(states[0], batch)
    got = {}
    reset_counts()
    stacks, dfts = record_shapes(
        lambda: got.update(gpu.eval_step(states[1], {k: v.cuda() for k, v in batch.items()})))
    torch.cuda.synchronize()
    counts = read_counts()
    log_err = {k: abs(float(got["logs"][k]) - float(v)) / max(abs(float(v)), 1e-12)
               for k, v in want["logs"].items()}
    scale = want["enhanced"].abs().max().item()
    enh_err = (got["enhanced"].cpu() - want["enhanced"]).abs().max().item()
    emit({"phase": "eval_parity", "batch": label, "B": int(batch["audio_body_conducted"].shape[0]),
          "T": int(batch["audio_body_conducted"].shape[1]), "T_cut": int(want["enhanced"].shape[1]),
          "logs_rel_err": log_err, "logs_tol": 1e-4, "enhanced_max_abs_err": enh_err,
          "enhanced_scale": scale, "enhanced_tol": 1e-4 * scale, "launches": counts,
          "stack_shapes": stacks, "dft_shapes": dfts,
          "logs_gpu": {k: float(v) for k, v in got["logs"].items()}})
    if set(got["logs"]) != set(want["logs"]) or not max(log_err.values()) <= 1e-4:
        raise AssertionError(f"the eval step's losses on the card differ from the CPU's ({label})")
    if not (got["enhanced"].shape == want["enhanced"].shape and enh_err <= 1e-4 * scale):
        raise AssertionError(f"the eval step's enhanced audio on the card differs from the CPU's ({label})")
    if counts != {"K1": 6, "K2": 0, "K3": 6, "K4": 0, "C1": 0, "C2": 0}:
        raise AssertionError(f"unexpected kernel launches in one eval step ({label}): {counts}")
    return stacks, dfts


def eval_k1_row(b: int, c: int, t: int, seed: int, label: str) -> dict:
    """K1 in float32 against its plain version (2e-5 of scale) at one eval
    stack shape, with its launch configuration and times."""
    x, ks = stack_inputs(b, c, t, torch.float32, seed=seed)
    out, ref = residual_stack(x, ks), plain_residual_stack(x, ks)
    torch.cuda.synchronize()
    sc = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    config = k1_config(b, c, t, torch.float32)
    k_ms, p_ms = [], []
    for _ in range(2):
        k_ms.append(cuda_ms(lambda: residual_stack(x, ks)))
        p_ms.append(cuda_ms(lambda: plain_residual_stack(x, ks)))
    ops_ms, bytes_ms = stack_bound_ms(b, c, t, torch.float32)
    bound_ms, bound_by = bound(ops_ms, bytes_ms)
    row = {"batch": label, "B": b, "C": c, "T": t, "dtype": "float32", "max_abs_err": err, "scale": sc,
           "tol": TOL[torch.float32] * sc, "t_mod_tile": t % config["tile"], "config": config,
           "kernel_ms": float(np.median(k_ms)), "plain_ms": float(np.median(p_ms)),
           "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "fma_ops_ms": fma_ms(24 * c * c * t * b)}
    emit({"phase": "eval_k1", **row})
    if not (math.isfinite(err) and err <= TOL[torch.float32] * sc):
        raise AssertionError(f"K1 disagrees with its plain version at an eval shape: {row}")
    return row


def eval_k3_row(b: int, t: int, fft: int, hop: int, win: int, gen: torch.Generator) -> dict:
    """K3 against its plain version at one eval shape (K3_TOL of scale),
    with kernel, plain and library (torch.stft(...).abs()) times, in turns."""
    x = (torch.randn(b, t, generator=gen) * 0.1).cuda()
    mag, ref = framed_dft_magnitude(x, fft, hop, win), plain_framed_dft_magnitude(x, fft, hop, win)
    torch.cuda.synchronize()
    window = hann_window(win, device="cuda")
    times = {k: [] for k in ("k3", "p3", "l3")}
    for _ in range(3):
        times["k3"].append(cuda_ms(lambda: framed_dft_magnitude(x, fft, hop, win), iters=20))
        times["p3"].append(cuda_ms(lambda: plain_framed_dft_magnitude(x, fft, hop, win), iters=20))
        times["l3"].append(cuda_ms(lambda: torch.stft(
            x, fft, hop_length=hop, win_length=win, window=window, center=True,
            pad_mode="reflect", return_complex=True).abs(), iters=20))
    med = {k: float(np.median(v)) for k, v in times.items()}
    ops_ms, bytes_ms = dft_bound_ms(b, t, fft, hop, win, backward=False)
    bound_ms, bound_by = bound(ops_ms, bytes_ms)
    row = {"B": b, "T": t, "fft": fft, "hop": hop, "win": win, "frames": 1 + t // hop,
           "bins": fft // 2 + 1, "k3_err_over_scale": rel_err(mag, ref), "k3_tol": K3_TOL,
           "kernel_ms": med["k3"], "plain_ms": med["p3"], "library_ms": med["l3"],
           "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "beats_library": med["k3"] < med["l3"]}
    emit({"phase": "eval_k3", **row})
    if not (mag.shape == ref.shape and math.isfinite(row["k3_err_over_scale"])
            and row["k3_err_over_scale"] <= K3_TOL):
        raise AssertionError(f"K3 disagrees with its plain version at an eval shape: {row}")
    return row


def phase_eval_parity() -> dict:
    """The eval step of the full eben.yaml task on the card against the CPU
    with the same weights (``eval_step_parity``), on the first batch of the
    CLI's test loader and, as an extra shape, on one whole synthetic test
    utterance.  Then K1 in float32 and K3 against their plain versions at
    the shapes the CLI batch's forward ran (``eval_k1`` and ``eval_k3``
    lines, with times), and K1 at the whole utterance's stack shapes, no
    multiple of K1's tile (``eval_k1`` lines labelled ``whole_utterance``)."""
    torch.manual_seed(0)
    opt = adam(3e-4, betas=(0.5, 0.9))
    cpu = make_task("cpu", small=False, optimizer=opt, compute_dtype="bfloat16")
    gpu = make_task("cuda", small=False, optimizer=opt, compute_dtype="bfloat16")
    gpu.generator.load_state_dict(cpu.generator.state_dict(), strict=True)
    gpu.discriminator.load_state_dict(cpu.discriminator.state_dict(), strict=True)
    states = (cpu.init_state(0), gpu.init_state(0))
    stacks, dfts = eval_step_parity(cpu, gpu, states, cli_test_batch(), "cli_test_batch")
    item = SyntheticVibravoxSource(EVAL_UTTERANCE + 1, split="speech_clean-test")[EVAL_UTTERANCE]
    whole = {k: torch.from_numpy(item[k][None, :, None]) for k in ("audio_body_conducted", "audio_airborne")}
    whole_stacks, _ = eval_step_parity(cpu, gpu, states, whole, "whole_utterance")

    out = {"k1": [], "k1_whole_utterance": [], "k3": []}
    with torch.inference_mode(), strict_float32():
        for i, (b, c, t) in enumerate(dict.fromkeys(stacks)):
            out["k1"].append(eval_k1_row(b, c, t, 100 + i, "cli_test_batch"))
        for i, (b, c, t) in enumerate(dict.fromkeys(whole_stacks)):
            row = eval_k1_row(b, c, t, 110 + i, "whole_utterance")
            if not row["t_mod_tile"]:
                raise AssertionError(f"a whole-utterance shape is a multiple of K1's tile: {row}")
            out["k1_whole_utterance"].append(row)
        gen = torch.Generator().manual_seed(11)
        for b, t, fft, hop, win in dict.fromkeys(dfts):
            out["k3"].append(eval_k3_row(b, t, fft, hop, win, gen))
    if not (len(out["k1"]) == len(out["k1_whole_utterance"]) == 3 and len(out["k3"]) == len(RESOLUTIONS)):
        raise AssertionError(f"the eval forwards ran {[len(v) for v in out.values()]} distinct shapes")
    if not all(b == 1 for b, _, _ in stacks):
        raise AssertionError(f"the CLI's test batch is not batch 1: {stacks}")
    return out


def wait_against_step(steps: dict) -> dict:
    """Each train step's data wait (the host's wait for its batch,
    ``Trainer.data_wait_seconds``) against its time by CUDA events; the
    first batch's wait holds the loader's start and is kept apart."""
    wait, step = steps["data_wait_ms"], steps["train_step_ms"]
    later = [w / s for w, s in zip(wait[1:], step[1:])]
    return {"first_wait_ms": wait[0], "later_wait_ms_median": float(np.median(wait[1:])),
            "later_step_ms_median": float(np.median(step[1:])),
            "later_wait_over_step_max": max(later), "later_wait_over_step_median": float(np.median(later))}


def tensorboard_check(files: set, logged: list) -> dict:
    """The one event file a CLI run wrote (the published default logger),
    read back with ``read_events`` (every record's checksums checked): its
    scalars must be the trainer's, step by step and in order (float32, as
    TensorBoard keeps them), train and validation among them; every audio
    record must decode as a 16-bit mono WAV at 16 kHz of its stated length."""
    import io
    import wave

    from vibravox_tpu_torch.core.logging import read_events

    if len(files) != 1:
        raise AssertionError(f"the CLI run wrote {len(files)} event files: {sorted(map(str, files))}")
    (path,) = files
    events = read_events(path)
    values = [(e["step"], v) for e in events[1:] for v in e.get("values", [])]
    scalars = [(step, v["tag"], v["simple_value"]) for step, v in values if "simple_value" in v]
    want = [(step, k, float(np.float32(v))) for step, d in logged for k, v in d.items()]
    audio = [v["audio"] for _, v in values if "audio" in v]
    texts = [v["tag"] for _, v in values if "text" in v]
    wavs = []
    for a in audio:
        with wave.open(io.BytesIO(a["encoded_audio_string"])) as w:
            wavs.append((w.getframerate(), w.getnchannels(), w.getsampwidth(), w.getnframes()))
    out = {"file": path.name, "bytes": path.stat().st_size, "events": len(events), "scalars": len(scalars),
           "train_scalars": sum(t.startswith("train/") for _, t, _ in scalars),
           "validation_scalars": sum(t.startswith("validation/") for _, t, _ in scalars),
           "test_scalars": sum(t.startswith("test/") for _, t, _ in scalars),
           "audio_records": len(audio), "texts": texts, "scalars_equal_logged": scalars == want}
    if events[0].get("file_version") != "brain.Event:2" or not out["scalars_equal_logged"]:
        raise AssertionError(f"the event file's scalars differ from the trainer's: {out}")
    if not (out["train_scalars"] and out["validation_scalars"] and audio):
        raise AssertionError(f"the event file lacks train or validation scalars or audio: {out}")
    if not all(wav == (16000, 1, 2, a["length_frames"]) and a["sample_rate"] == 16000 and a["length_frames"] > 0
               for wav, a in zip(wavs, audio)):
        raise AssertionError(f"an audio record is no 16 kHz mono WAV of its length: {wavs}")
    return out


def phase_cli(run_dir: str) -> dict:
    """The CLI's main path: ``vibravox_tpu_torch.run.main`` with CLI_ARGS,
    at full width, in ``run_dir`` (fit two epochs of two steps at batch 32,
    bf16, validating four batch-1 float32 batches an epoch, checkpoints by
    validation STOI, then test("last") on four batches), then again with
    max_epochs 3, which resumes at epoch 2 (phase ``cli_squim`` tests its
    ``last`` again).  The counts are
    reset before each run; fit and test are told apart at the test's entry.
    The test pass is timed per batch: the eval step (wall, synchronised,
    and CUDA events) and the host metrics (SI-SDR, the copy, STOI).  Each
    train step is timed by CUDA events around it (no added sync; a host
    stall inside the step shows as device time), and the devices of both
    Adams' step counts are read after it: they must be on the CPU in both
    runs, as in a fresh one (restored onto the card, they cost a host sync
    per parameter); the resumed run's steps are reported beside the first
    run's, the first step of each and the median of the rest."""
    from vibravox_tpu_torch import run
    from vibravox_tpu_torch.tasks import se_metrics

    timing = {"eval_step_wall": [], "eval_step_device": [], "metrics": [], "stoi": []}
    marks: dict = {}
    train_steps = {"events": [], "adam_step_devices": set()}
    train_step, eval_step, eval_metrics, stoi, test = (
        EBENTask.train_step, EBENTask.eval_step, EBENTask.eval_metrics, se_metrics.stoi, Trainer.test)
    fit, log = Trainer.fit, Trainer._log
    logged: list = []

    def recorded_log(self, scalars):
        logged.append((self.global_step, dict(scalars)))
        return log(self, scalars)

    def kept_fit(self, *args, **kwargs):
        marks["trainer"] = self
        return fit(self, *args, **kwargs)

    def timed_train_step(self, state, batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = train_step(self, state, batch)
        end.record()
        train_steps["events"].append((start, end))
        train_steps["adam_step_devices"].update(
            str(s["step"].device) for opt in (out[0].generator_optimizer, out[0].discriminator_optimizer)
            for s in opt.state.values() if isinstance(s.get("step"), torch.Tensor))
        return out

    def timed_eval_step(self, state, batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = eval_step(self, state, batch)
        end.record()
        end.synchronize()
        timing["eval_step_wall"].append(time.perf_counter() - t0)
        timing["eval_step_device"].append(start.elapsed_time(end) / 1e3)
        return out

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            timing[key].append(time.perf_counter() - t0)
            return out
        return wrapper

    def marked_test(self, *args, **kwargs):
        torch.cuda.synchronize()
        marks["fit_end"], marks["fit_counts"] = time.perf_counter(), read_counts()
        for v in timing.values():
            v.clear()  # the test pass's timings only
        out = test(self, *args, **kwargs)
        torch.cuda.synchronize()
        marks["test_end"] = time.perf_counter()
        return out

    def run_cli(run_dir, epochs):
        reset_counts()
        train_steps["events"].clear()
        train_steps["adam_step_devices"].clear()
        logged.clear()
        before = set(Path(run_dir).glob("tensorboard/events.out.tfevents.*"))
        t0 = time.perf_counter()
        metrics = run.main([*CLI_ARGS, f"++run_dir={run_dir}", f"++trainer.max_epochs={epochs}"])
        counts = read_counts()
        fit = marks["fit_counts"]
        steps = {"train_step_ms": [a.elapsed_time(b) for a, b in train_steps["events"]],
                 "data_wait_ms": [1e3 * w for w in marks["trainer"].data_wait_seconds],
                 "adam_step_devices": sorted(train_steps["adam_step_devices"]),
                 "tensorboard": tensorboard_check(set(Path(run_dir).glob("tensorboard/events.out.tfevents.*"))
                                                  - before, list(logged))}
        return metrics, {"fit": fit, "test": {k: counts[k] - fit[k] for k in counts}}, \
            marks["fit_end"] - t0, marks["test_end"] - marks["fit_end"], steps

    def want(steps, val_batches, test_batches):
        fit = {"K1": 6 * (steps + val_batches), "K2": 6 * steps, "K3": 6 * (steps + val_batches),
               "K4": 6 * steps, "C1": C1_PER_STEP * steps, "C2": 0}
        return {"fit": fit, "test": {"K1": 6 * test_batches, "K2": 0, "K3": 6 * test_batches, "K4": 0, "C1": 0,
                                     "C2": 0}}

    EBENTask.train_step, EBENTask.eval_step = timed_train_step, timed_eval_step
    EBENTask.eval_metrics = timed(eval_metrics, "metrics")
    se_metrics.stoi, Trainer.test, Trainer.fit = timed(stoi, "stoi"), marked_test, kept_fit
    Trainer._log = recorded_log
    try:
        metrics, launches, fit_s, test_s, steps = run_cli(run_dir, 2)
        test_timing = {k: list(v) for k, v in timing.items()}
        ckpt = Path(run_dir) / "checkpoints"
        index = json.loads((ckpt / "index.json").read_text())
        progress = json.loads((ckpt / "trainer_state.json").read_text())
        top_k = sorted(p.name for p in ckpt.glob("step_*"))
        have_last = (ckpt / "last" / "state.pt").exists()
        metrics2, launches2, fit2_s, test2_s, steps2 = run_cli(run_dir, 3)
        progress2 = json.loads((ckpt / "trainer_state.json").read_text())
    finally:
        EBENTask.train_step, EBENTask.eval_step, EBENTask.eval_metrics = train_step, eval_step, eval_metrics
        se_metrics.stoi, Trainer.test, Trainer.fit, Trainer._log = stoi, test, fit, log

    per_batch = {k: [1e3 * x for x in v] for k, v in test_timing.items()}
    fit_out = {"phase": "cli_fit", "epochs": 2, "steps": 2 * CLI_STEPS_PER_EPOCH, "B": 32,
               "val_batches_per_epoch": CLI_VAL_BATCHES, "fit_wall_s": fit_s, "augmentation": "light",
               "launches": launches["fit"], "checkpoints": top_k, "index": index,
               "trainer_state": progress, "last": have_last, **steps,
               "data_wait_against_step": wait_against_step(steps)}
    test_out = {"phase": "cli_test", "batches": CLI_TEST_BATCHES, "test_wall_s": test_s,
                "test_s_per_batch": test_s / CLI_TEST_BATCHES,
                "eval_step_wall_ms": per_batch["eval_step_wall"],
                "eval_step_device_ms": per_batch["eval_step_device"],
                "host_metrics_ms": per_batch["metrics"], "stoi_ms": per_batch["stoi"],
                "launches": launches["test"], "metrics": metrics}
    def by_position(ms):
        # each run's first step carries its new task's first use: compared apart
        return {"first_step_ms": ms[0], "later_steps_median_ms": float(np.median(ms[1:]))}

    first, resumed = by_position(steps["train_step_ms"]), by_position(steps2["train_step_ms"])
    resume_out = {"phase": "cli_resume", "epochs": 3, "fit_wall_s": fit2_s, "test_wall_s": test2_s,
                  "launches": launches2, "trainer_state": progress2, "metrics": metrics2, **steps2,
                  "data_wait_against_step": wait_against_step(steps2),
                  "train_steps": resumed, "first_run_train_steps": first,
                  "later_steps_resumed_over_first": resumed["later_steps_median_ms"]
                  / first["later_steps_median_ms"]}
    for out in (fit_out, test_out, resume_out):
        emit(out)
    if launches != want(2 * CLI_STEPS_PER_EPOCH, 2 * CLI_VAL_BATCHES, CLI_TEST_BATCHES):
        raise AssertionError(f"kernel launches {launches} on the CLI's fit and test")
    if launches2 != want(CLI_STEPS_PER_EPOCH, CLI_VAL_BATCHES, CLI_TEST_BATCHES):
        raise AssertionError(f"kernel launches {launches2} on the resumed run")
    if steps["adam_step_devices"] != ["cpu"] or steps2["adam_step_devices"] != ["cpu"]:
        raise AssertionError(f"Adam's step counts on {steps['adam_step_devices']}, then on "
                             f"{steps2['adam_step_devices']} after the resume: not on the CPU")
    if len(steps["train_step_ms"]) != 2 * CLI_STEPS_PER_EPOCH or len(steps2["train_step_ms"]) != CLI_STEPS_PER_EPOCH:
        raise AssertionError(f"timed train steps {steps} then {steps2}")
    if progress != {"epoch": 1, "global_step": 4} or progress2 != {"epoch": 2, "global_step": 6}:
        raise AssertionError(f"progress {progress} then {progress2}: the run did not resume at epoch 2")
    if not (have_last and len(top_k) == 2 and top_k == sorted(f"step_{int(s):08d}" for s in index)):
        raise AssertionError(f"checkpoints: last {have_last}, top-k {top_k}, index {index}")
    for m in (metrics, metrics2):
        if not ({"test/torchmetrics_stoi", "test/torchmetrics_si_sdr"} <= set(m)
                and all(math.isfinite(v) for v in m.values()) and 0 < m["test/torchmetrics_stoi"] <= 1):
            raise AssertionError(f"test metrics {m}")
    if not all(len(v) == CLI_TEST_BATCHES for v in per_batch.values()):
        raise AssertionError(f"timed test batches {per_batch}")
    return {"fit": fit_out, "test": test_out, "resume": resume_out}


# ---------------------------------------------------------------------------
# the BWE family's host pipeline: the pad collate, augmentation, npz sources
# ---------------------------------------------------------------------------

PAD_SHORT_B = 32
LIGHT = dict(p_data_augmentation=0.5, p_speed_perturbation=0.3, p_pitch_shift=0.3, p_time_masking=0.3)
PITCH_STEPS = (-4, -3, -2, -1, 1, 2, 3, 4, 5, 6)  # light.yaml / aggressive.yaml
SPEED_FACTORS = (0.7, 0.8, 0.85, 0.9, 0.95, 1.05, 1.1, 1.15, 1.2, 1.3)


def phase_pad_short() -> dict:
    """The pad collate's short batches on the card: 32 synthetic utterances
    of 0.03-0.06 s collate to T = 1024 (992 after the generator's cut);
    the full task's generator forward and STFT loss, then its backward, on
    the card against the same weights on the CPU (loss 1e-4 relative; each
    parameter's gradient within 1e-2 of its norm, as train_parity holds the
    updates).  The 2048-point resolution runs K3 and K4 at T <= fft / 2.
    The discriminator is left out: its deepest scales need about 3000
    samples, so the whole train step takes no such batch."""
    source = SyntheticVibravoxSource(PAD_SHORT_B, min_seconds=0.03, max_seconds=0.06, split="speech_clean-train")
    batch = BWECollate(16000, "pad")([source[i] for i in range(PAD_SHORT_B)])
    torch.manual_seed(0)
    cpu = make_task("cpu", small=False, optimizer=sgd(1e-2))
    gpu = make_task("cuda", small=False, optimizer=sgd(1e-2))
    gpu.generator.load_state_dict(cpu.generator.state_dict(), strict=True)

    def step(task):
        gen = task.generator
        corrupted = gen.cut_to_valid_length(batch["audio_body_conducted"].to(task.device))
        reference = gen.cut_to_valid_length(batch["audio_airborne"].to(task.device))
        enhanced, _ = gen(corrupted)
        loss = task.reconstructive_loss_freq_fn(enhanced, reference)
        loss.backward()
        return float(loss.detach()), {n: q.grad.detach().cpu() for n, q in gen.named_parameters() if q.grad is not None}

    loss_cpu, grads_cpu = step(cpu)
    out = {}
    reset_counts()
    _, dfts = record_shapes(lambda: out.update(zip(("loss", "grads"), step(gpu))))
    torch.cuda.synchronize()
    counts = read_counts()
    loss_err = abs(out["loss"] - loss_cpu) / abs(loss_cpu)
    worst, bad = 0.0, []
    for n, g in grads_cpu.items():
        diff = (out["grads"][n] - g).norm().item()
        worst = max(worst, diff / max(g.norm().item(), 1e-30))
        if diff > 1e-2 * g.norm().item() + 1e-7:
            bad.append(n)
    short = [d for d in dfts if d[1] <= d[2] // 2]
    row = {"phase": "pad_short", "B": PAD_SHORT_B, "T_batch": int(batch["audio_body_conducted"].shape[1]),
           "lengths": [len(source[i]["audio_body_conducted"]) for i in range(PAD_SHORT_B)],
           "dft_shapes": dfts, "dft_shapes_t_le_half_fft": short, "launches": counts,
           "loss_rel_err": loss_err, "loss_tol": 1e-4, "grads_max_diff_over_norm": worst, "grads_tol": 1e-2,
           "grads_out_of_tol": bad, "grads_compared": len(grads_cpu)}
    emit(row)
    if not (row["T_batch"] == 1024 and max(row["lengths"]) < 1024 and short):
        raise AssertionError(f"the pad collate's batch did not reach T <= fft / 2: {row}")
    if counts != {"K1": 6, "K2": 6, "K3": 6, "K4": 3, "C1": 0, "C2": 0}:
        raise AssertionError(f"unexpected kernel launches on the pad-collated batch: {counts}")
    if not (loss_err <= 1e-4 and not bad and len(out["grads"]) == len(grads_cpu)):
        raise AssertionError(f"the pad-collated batch's loss or gradients on the card differ from the CPU's: {row}")
    return row


def resampler_form(orig: int, new: int, window: str, banded: bool) -> KaiserResampler:
    """A resampler forced to the banded or the dense form, whatever the
    size of its dense bank."""
    limit = resample.DENSE_BANK_LIMIT
    resample.DENSE_BANK_LIMIT = 0 if banded else 1 << 62
    try:
        return KaiserResampler(orig, new, window=window)
    finally:
        resample.DENSE_BANK_LIMIT = limit


def host_ms(fn, reps: int = 3) -> float:
    """The best of ``reps`` wall times after one warm-up call (ms)."""
    fn()
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def resample_forms(body: torch.Tensor) -> dict:
    """The two forms of ``KaiserResampler`` on the same input, with the
    form that ``DENSE_BANK_LIMIT`` picks: on the host at the speed factors
    (the batch of 32 x 40000), at STOI's 16 kHz -> 10 kHz (one 2.5 s
    signal) and at pitch step -3 (the smallest dense pitch bank, 216 MB:
    one call each, its design timed apart); on the card at 48 kHz -> 16 kHz
    with the Hann window (the SE metrics' resample at 48 kHz, one 2.5 s
    signal).  The forms must agree within 1e-6 of scale."""
    cases = [(f"speed {f}", int(round(16000 * f)), 16000, "kaiser", body, 3) for f in SPEED_FACTORS]
    cases += [("stoi 16000->10000", 16000, 10000, "kaiser", body[:1], 3),
              ("pitch -3", int(16000 / 2.0 ** (3 / 12)), 16000, "kaiser", body, 0)]
    out = {}
    for label, orig, new, window, x, reps in cases:
        row = {"orig_freq": orig, "new_freq": new, "B": int(x.shape[0]), "T": int(x.shape[-1]),
               "dense_bank_bytes": bank_nbytes(*(v // math.gcd(orig, new) for v in (orig, new)))[0]}
        ys = {}
        for form in ("dense", "band"):
            t0 = time.perf_counter()
            r = resampler_form(orig, new, window, banded=form == "band")
            row[f"{form}_design_s"] = time.perf_counter() - t0
            if reps:
                row[f"{form}_ms"] = host_ms(lambda: r(x), reps)
            else:
                t0 = time.perf_counter()
                r(x)
                row[f"{form}_ms"] = 1e3 * (time.perf_counter() - t0)
            ys[form] = r(x)
            del r
        design_band.cache_clear()
        design_kernel.cache_clear()
        row["picked"] = "band" if KaiserResampler(orig, new, window=window).banded else "dense"
        row["band_over_dense"] = row["band_ms"] / row["dense_ms"]
        row["max_abs_diff_over_scale"] = rel_err(ys["band"], ys["dense"])
        out[label] = row
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 120000)).astype(np.float32)).cuda()
    row = {"orig_freq": 48000, "new_freq": 16000, "B": 1, "T": 120000, "device": "cuda"}
    ys = {}
    for form in ("dense", "band"):
        r = resampler_form(48000, 16000, "hann", banded=form == "band")
        row[f"{form}_ms"] = cuda_ms(lambda: r(x))
        ys[form] = r(x).cpu()
    row["picked"] = "band" if KaiserResampler(48000, 16000, window="hann").banded else "dense"
    row["band_over_dense"] = row["band_ms"] / row["dense_ms"]
    row["max_abs_diff_over_scale"] = rel_err(ys["band"], ys["dense"])
    out["card 48000->16000 hann"] = row
    bad = {k: v for k, v in out.items() if not v["max_abs_diff_over_scale"] <= 1e-6}
    if bad:
        raise AssertionError(f"the banded and dense resamplers disagree: {bad}")
    return out


def phase_augment() -> dict:
    """The augmentation's cost on the host, at one torch thread as in a
    loader worker.  The banks of every pitch step and speed factor of
    light / aggressive at 16 kHz, designed from nothing under tracemalloc
    (peak host bytes, and the bytes each resampler keeps); each step and
    factor on one batch of 32 x 40000 once; then the worst case, every
    transform firing at the slowest step and factor on the batch and its
    airborne pair, three times (median)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        design_band.cache_clear()
        design_kernel.cache_clear()
        tracemalloc.start()
        t0 = time.perf_counter()
        kept = {f"pitch {st}": KaiserResampler(int(16000 / 2.0 ** (-st / 12)), 16000).nbytes() for st in PITCH_STEPS}
        kept.update({f"speed {f}": KaiserResampler(int(round(16000 * f)), 16000).nbytes() for f in SPEED_FACTORS})
        design_s = time.perf_counter() - t0
        peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        items = SyntheticVibravoxSource(32, split="speech_clean-train")
        crops = BWECollate(16000, "constant_length-2500-ms", seed=0)([items[i] for i in range(32)])
        body, air = (crops[k][:, :, 0] for k in ("audio_body_conducted", "audio_airborne"))
        pitch_s, speed_s = {}, {}
        for st in PITCH_STEPS:
            t0 = time.perf_counter()
            augment.pitch_shift(body, 16000, st)
            pitch_s[st] = time.perf_counter() - t0
        for f in SPEED_FACTORS:
            t0 = time.perf_counter()
            augment.speed_perturbation(body, 16000, f)
            speed_s[f] = time.perf_counter() - t0
        step, factor = max(pitch_s, key=pitch_s.get), max(speed_s, key=speed_s.get)
        worst = augment.WaveformDataAugmentation(
            16000, p_data_augmentation=1.0, p_speed_perturbation=1.0, p_pitch_shift=1.0, p_time_masking=1.0,
            speed_perturbation_factors=(factor,), pitch_shift_steps=(step,), time_masking_percentage=(8,))
        worst_s = []
        for i in range(3):
            t0 = time.perf_counter()
            w1, w2 = worst(body, air, rng=np.random.default_rng(i), mask_rng=np.random.default_rng(i))
            worst_s.append(time.perf_counter() - t0)
        forms = resample_forms(body)
    finally:
        torch.set_num_threads(threads)
    out = {"phase": "augment", "B": 32, "T": 40000, "torch_threads": 1, "bank_design_s": design_s,
           "bank_design_peak_host_bytes": peak, "bank_kept_bytes": kept, "bank_kept_bytes_max": max(kept.values()),
           "pitch_shift_s_one_signal": pitch_s, "speed_perturbation_s_one_signal": speed_s,
           "slowest_pitch_step": step, "slowest_speed_factor": factor,
           "worst_case_s_both_signals": worst_s, "worst_case_s_median": float(np.median(worst_s)),
           "worst_case_out_T": int(w1.shape[-1]), "resample_forms": forms}
    emit(out)
    if not (max(kept.values()) <= 4e6 and all(torch.isfinite(w).all() for w in (w1, w2))):
        raise AssertionError(f"a resampler bank over 4 MB or a non-finite augmented batch: {out}")
    return out


LOADER_BATCHES = 32  # a pass of each train loader; the first workers x prefetch are made at once
LOADER_SPLIT_BATCHES = 16  # batches made again in this process, timed by part
LOADER_CONFIGS = (("bwe", "light", ("lightning_datamodule=bwe", "lightning_datamodule.dataset_name_principal=synthetic")),
                  ("noisybwe", "aggressive", ("lightning_datamodule=noisybwe", "lightning_datamodule.dataset_name=synthetic")))


def loader_pass(loader) -> dict:
    """One pass of a train loader, consumed with no work between batches:
    each batch's arrival after the iterator is made.  The first
    ``num_workers x prefetch_factor`` batches are asked for at once; from
    the last of them on, each batch is asked for as one arrives, so the
    mean interval after it is the workers' rate."""
    loader.batch_sampler.set_epoch(0)
    first = loader.num_workers * (loader.prefetch_factor or 2)
    t0 = time.perf_counter()
    arrivals = []
    for _ in loader:
        arrivals.append(1e3 * (time.perf_counter() - t0))
    steady = np.diff(arrivals[first - 1:])
    return {"batches": len(arrivals), "workers": loader.num_workers, "first_wait_ms": arrivals[0],
            "prefetched_batches": first, "steady_batches": len(steady),
            "steady_ms_per_batch": float(np.mean(steady)), "steady_interval_ms_max": float(np.max(steady)),
            "batches_per_s": 1e3 / float(np.mean(steady))}


def loader_split(loader, n: int) -> dict:
    """The first ``n`` batches of the same pass made again in this process
    at one torch thread, as a worker makes them: the source's items
    (``Keyed``: the synthetic source makes each utterance, the noisy one
    its noise too) and the collate (crops, augmentation, re-crop), each
    timed per batch (ms)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    items_ms, collate_ms = [], []
    try:
        for keys in list(loader.batch_sampler)[:n]:
            t0 = time.perf_counter()
            pairs = [loader.dataset[k] for k in keys]
            t1 = time.perf_counter()
            loader.collate_fn(pairs)
            items_ms.append(1e3 * (t1 - t0))
            collate_ms.append(1e3 * (time.perf_counter() - t1))
    finally:
        torch.set_num_threads(threads)
    return {"batches": n, "items_ms_mean": float(np.mean(items_ms)), "collate_ms_mean": float(np.mean(collate_ms)),
            "collate_ms": collate_ms, "items_ms": items_ms}


def phase_loader(step_ms: float) -> dict:
    """The published train loaders on the host, as the CLI composes them
    (``bwe.yaml`` with ``light`` and ``noisybwe.yaml`` with ``aggressive``:
    four workers, batch 32 of 2.5 s crops, the synthetic source of
    32 x LOADER_BATCHES utterances): the batches a second their workers
    make in steady state, against the train phase's median step (no step
    runs meanwhile), and the first LOADER_SPLIT_BATCHES batches of the
    pass split into the source's items and the collate with its
    augmentation, one worker's milliseconds each."""
    from vibravox_tpu_torch.core.config import compose, instantiate
    from vibravox_tpu_torch.run import CONFIG_DIR, port_targets

    out = {"phase": "loader", "train_step_ms_median": step_ms, "B": 32}
    for name, augmentation, args in LOADER_CONFIGS:
        cfg = compose(CONFIG_DIR, "run", [*args, f"++lightning_datamodule.synthetic_size={32 * LOADER_BATCHES}"])
        port_targets(cfg, "cuda")
        dm = instantiate(cfg.lightning_datamodule)
        if type(dm.data_augmentation).__name__ != "WaveformDataAugmentation":
            raise AssertionError(f"{name}'s augmentation is {dm.data_augmentation!r}")
        dm.setup("fit")
        loader = dm.train_dataloader()
        row = {"augmentation": augmentation, **loader_pass(loader)}
        del loader  # its persistent workers stop
        row["steady_ms_per_batch_over_step"] = row["steady_ms_per_batch"] / step_ms
        row["split"] = split = loader_split(dm.train_dataloader(), LOADER_SPLIT_BATCHES)
        row["worker_ms_per_batch"] = split["items_ms_mean"] + split["collate_ms_mean"]
        row["workers_ms_per_batch"] = row["worker_ms_per_batch"] / row["workers"]
        out[name] = row
    emit(out)
    for name, _, _ in LOADER_CONFIGS:
        if out[name]["batches"] != LOADER_BATCHES:
            raise AssertionError(f"the {name} train loader gave {out[name]['batches']} batches, not {LOADER_BATCHES}")
    return out


def phase_npz() -> dict:
    """The synthetic source written as npz utterances (train 64, validation
    and test 4) and read back by the data module, with light augmentation
    and two loader workers: its train batches of two epochs, and its
    validation and test batches, byte-equal to the synthetic source's."""
    def batches(dm, stage, get, epochs=(None,)):
        dm.setup(stage)
        loader = getattr(dm, get)()
        out = []
        for e in epochs:
            if e is not None:
                loader.batch_sampler.set_epoch(e)
            out += [{k: v.numpy().tobytes() for k, v in b.items()} for b in loader][:4]
        return out

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="vibravox_npz_") as root:
        for split, n in (("train", 64), ("validation", 4), ("test", 4)):
            source = SyntheticVibravoxSource(n, split=f"speech_clean-{split}")
            os.makedirs(os.path.join(root, split))
            for i in range(n):
                np.savez(os.path.join(root, split, f"{i:05d}.npz"), **source[i])
        write_s = time.perf_counter() - t0
        kw = dict(collate_strategy="constant_length-2500-ms", batch_size=32, num_workers=2, synthetic_size=64,
                  seed=42, data_augmentation=augment.WaveformDataAugmentation(16000, **LIGHT), device="cuda")
        npz, synthetic = BWEDataModule(dataset_name_principal=root, **kw), BWEDataModule(**kw)
        same = {}
        for stage, get, epochs in (("fit", "train_dataloader", (0, 1)), ("validate", "val_dataloader", (None,)),
                                   ("test", "test_dataloader", (None,))):
            a, b = batches(npz, stage, get, epochs), batches(synthetic, stage, get, epochs)
            same[get] = {"batches": len(a), "equal": a == b and len(a) > 0}
    out = {"phase": "npz", "utterances_written": 72, "write_s": write_s, "compared": same}
    emit(out)
    if not all(v["equal"] for v in same.values()):
        raise AssertionError(f"the npz directory's batches differ from the synthetic source's: {same}")
    return out


# ---------------------------------------------------------------------------
# the multi-scale MelGAN discriminator and the opt-in int8 discriminator convs
# ---------------------------------------------------------------------------

MELGAN_B, MELGAN_T, MELGAN_TOL, MELGAN_GRAD_TOL = 4, 40000, 1e-4, 1e-3  # 2.5 s at 16 kHz


def phase_melgan_multiscales(smi: str) -> dict:
    """``MelganMultiScalesDiscriminator(16000, scales=3)`` at full width on
    b4 x 2.5 s, float32 under strict_float32, on the card against the same
    weights on the CPU: every scale's resampled input and 8 embeddings
    within 1e-4 of each tensor's scale, and the gradient of a fixed linear
    read-out of every embedding with respect to the audio (through both
    resamplers) within 1e-3 of its norm (relative L2; its largest
    deviation over its scale is reported).  The gradient's bar is wider:
    a pre-activation within rounding of zero takes the leaky ReLU's other
    slope on one side, which moves the gradient over that unit's receptive
    field; the CPU's own float32 gradient is 1.6e-4 (L2) and 2.7e-3 (max,
    of scale) from float64 at b2 x 2.5 s."""
    from vibravox_tpu_torch.models.melgan_discriminator import MelganMultiScalesDiscriminator

    torch.manual_seed(0)
    cpu = MelganMultiScalesDiscriminator(16000, scales=3, device="cpu")
    gpu = MelganMultiScalesDiscriminator(16000, scales=3, device="cuda")
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    gen = torch.Generator().manual_seed(3)
    audio = torch.randn(MELGAN_B, 1, MELGAN_T, generator=gen) * 0.3

    def run(disc, x):
        x = x.clone().requires_grad_(True)
        with strict_float32():
            downs = disc.get_downsampled_versions(x.detach())
            embs = disc.embed(x)
            heads = torch.Generator().manual_seed(4)
            loss = sum((e * torch.randn(e.shape, generator=heads).to(e.device)).sum()
                       for scale in embs for e in scale)
            loss.backward()
        return downs, embs, x.grad

    want = run(cpu, audio)
    t0 = time.perf_counter()
    got = run(gpu, audio.cuda())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def err(a, b):
        scale = b.abs().max().item()
        return (a.detach().cpu() - b.detach()).abs().max().item() / max(scale, 1e-12)

    down_err = [err(a, b) for a, b in zip(got[0], want[0])]
    emb_err = [[err(a, b) for a, b in zip(sa, sb)] for sa, sb in zip(got[1], want[1])]
    grad_err = err(got[2], want[2])
    grad_l2 = ((got[2].cpu() - want[2]).norm() / want[2].norm()).item()
    out = {"phase": "melgan_multiscales", "card": smi, "B": MELGAN_B, "T": MELGAN_T, "scales": 3,
           "dtype": "float32",
           "resampled_lengths": [int(d.shape[-1]) for d in got[0]],
           "embedding_shapes": [[list(e.shape) for e in scale] for scale in got[1]],
           "resampled_err_over_scale": down_err, "embedding_err_over_scale": emb_err,
           "audio_grad_err_over_scale": grad_err, "audio_grad_rel_l2": grad_l2, "tol": MELGAN_TOL,
           "grad_rel_l2_tol": MELGAN_GRAD_TOL, "card_forward_backward_wall_s": wall}
    emit(out)
    if [int(d.shape[-1]) for d in got[0]] != [MELGAN_T, MELGAN_T // 2, MELGAN_T // 4]:
        raise AssertionError(f"resampled lengths {out['resampled_lengths']}")
    if not (max(down_err + sum(emb_err, [])) <= MELGAN_TOL and grad_l2 <= MELGAN_GRAD_TOL):
        raise AssertionError(f"the multi-scale MelGAN on the card differs from the CPU: {out}")
    return out


INT8_STEP_WARMUP, INT8_STEPS, INT8_TWIN_ROWS = 2, 5, 2
INT8_PEAK_OPS = 1979e12  # H100 SXM int8 tensor cores, dense, at 700 W


def int8_conv_row(x_shape, w_shape, stride, pad, dilation, groups, seed: int, smi: str) -> dict:
    """The int8 conv at one shape: the GEMM route on the card equal in int32
    to the exact integer convolution (a float64 cuDNN conv on the card:
    every partial sum is an integer below 2^53) over the whole batch, and to
    the plain int32 twin on the CPU over the first INT8_TWIN_ROWS rows; then
    the route's time, the whole int8 forward's (both quantisations, the
    route, the rescale) and cuDNN's bf16 conv's at the same shape, in turns,
    with their bounds."""
    from vibravox_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(seed)
    qx = torch.randint(-127, 128, x_shape, generator=gen, dtype=torch.int8).cuda()
    qw = torch.randint(-127, 128, w_shape, generator=gen, dtype=torch.int8).cuda()
    y = quant.int8_conv1d(qx, qw, stride, pad, dilation, groups)
    exact = F.conv1d(F.pad(qx.double(), pad), qw.double(), None, stride, 0, dilation, groups)
    twin = quant.plain_int8_conv1d(qx[:INT8_TWIN_ROWS].cpu(), qw.cpu(), stride, pad, dilation, groups)
    torch.cuda.synchronize()
    equal_exact = bool(torch.equal(y.double(), exact))
    equal_twin = bool(torch.equal(y[:INT8_TWIN_ROWS].cpu(), twin))
    xb = (torch.randn(x_shape, generator=gen) * 0.3).to("cuda", torch.bfloat16)
    wb = (torch.randn(w_shape, generator=gen) * 0.05).to("cuda", torch.bfloat16)
    times = {"int8_route": [], "int8_forward": [], "cudnn_bf16": []}
    with torch.no_grad():
        calls = {"int8_route": lambda: quant.int8_conv1d(qx, qw, stride, pad, dilation, groups),
                 "int8_forward": lambda: quant.conv1d_int8_ste(xb, wb, stride, pad, dilation, groups),
                 "cudnn_bf16": lambda: F.conv1d(F.pad(xb, pad), wb, None, stride, 0, dilation, groups)}
        for order in (("int8_route", "int8_forward", "cudnn_bf16"), ("cudnn_bf16", "int8_forward", "int8_route")):
            for k in order:
                times[k].append(cuda_ms(calls[k], iters=10))
    med = {k: float(np.median(v)) for k, v in times.items()}
    b, cout, t_out = y.shape
    macs = b * t_out * cout * w_shape[1] * w_shape[2]
    bytes_int8 = qx.numel() + qw.numel() + 4 * y.numel()
    bytes_bf16 = 2 * (xb.numel() + wb.numel() + y.numel())
    row = {"x": list(x_shape), "w": list(w_shape), "stride": stride, "pad": list(pad), "dilation": dilation,
           "groups": groups, "T_out": t_out, "M_per_group": b * t_out, "K": w_shape[1] * w_shape[2],
           "N_per_group": cout // groups, "equal_exact_int32": equal_exact,
           "equal_cpu_twin_first_rows": equal_twin, **{f"{k}_ms": v for k, v in med.items()},
           "int8_route_bound_ms": max(2 * macs / INT8_PEAK_OPS, bytes_int8 / HBM_BYTES_PER_S) * 1e3,
           "cudnn_bf16_bound_ms": max(2 * macs / PEAK_FLOPS[torch.bfloat16], bytes_bf16 / HBM_BYTES_PER_S) * 1e3,
           "int8_forward_over_cudnn_bf16": med["int8_forward"] / med["cudnn_bf16"]}
    emit({"phase": "int8_conv", "card": smi, **row})
    if not (equal_exact and equal_twin):
        raise AssertionError(f"the int8 conv on the card differs from the integer convolution: {row}")
    return row


def phase_int8_disc(smi: str) -> dict:
    """The opt-in int8 discriminator (``VIBRAVOX_INT8_DISC=1``).  One eben.yaml
    bf16 train step at b32 x 2.5 s with the flag against one without (the
    same weights and batch), in turns, float, int8, int8, float, each
    INT8_STEP_WARMUP steps then INT8_STEPS synchronised steps: losses and
    both networks' gradient norms finite; every int8 conv shape the int8
    step ran at batch 32 (the generator step's discriminator forward; the
    discriminator step runs the same layers at 64 rows) then goes through
    ``int8_conv_row``."""
    from vibravox_tpu_torch.ops import quant

    batch = {k: v.cuda() for k, v in dp_batch(TRAIN_B, seed=9).items()}
    tasks = {}
    for name, flag in (("float", "0"), ("int8", "1")):
        with mock.patch.dict(os.environ, {"VIBRAVOX_INT8_DISC": flag}):
            torch.manual_seed(0)
            tasks[name] = make_task("cuda", small=False, optimizer=adam(3e-4, betas=(0.5, 0.9)),
                                    compute_dtype="bfloat16")
        tasks[name].track_grad_norm = 2
    int8_layers = sum(1 for m in tasks["int8"].discriminator.modules() if getattr(m, "int8", False))
    states = {k: t.init_state(0) for k, t in tasks.items()}
    shapes, logs, ms = {}, {"float": [], "int8": []}, {"float": [], "int8": []}
    route = quant.gemm_int8_conv1d  # what int8_conv1d runs on the card, wrapped to record the shapes

    def recorded(qx, qw, stride, pad, dilation=1, groups=1):
        shapes.setdefault((tuple(qx.shape), tuple(qw.shape), stride, tuple(pad), dilation, groups), 0)
        shapes[(tuple(qx.shape), tuple(qw.shape), stride, tuple(pad), dilation, groups)] += 1
        return route(qx, qw, stride, pad, dilation, groups)

    def steps(name):
        def one():
            states[name], lg = tasks[name].train_step(states[name], batch)
            logs[name].append({k: float(v) for k, v in lg.items()})
        timed = timed_calls(one, INT8_STEP_WARMUP + INT8_STEPS)
        ms[name].extend(timed[INT8_STEP_WARMUP:])

    quant.gemm_int8_conv1d = recorded
    try:
        launches0 = quant.int8_conv1d.launches
        for name in ("float", "int8", "int8", "float"):
            steps(name)
        launches = quant.int8_conv1d.launches - launches0
    finally:
        quant.gemm_int8_conv1d = route
    step_rows = {k: {"ms_median": float(np.median(v)), "ms_p10": float(np.percentile(v, 10)),
                     "ms_p90": float(np.percentile(v, 90)), "ms": v} for k, v in ms.items()}
    n_steps = 2 * (INT8_STEP_WARMUP + INT8_STEPS)
    conv_rows = [int8_conv_row(*key, seed=20 + i, smi=smi)
                 for i, key in enumerate(sorted(k for k in shapes if k[0][0] == TRAIN_B))]
    total = {k: sum(r[k] for r in conv_rows) for k in ("int8_route_ms", "int8_forward_ms", "cudnn_bf16_ms",
                                                      "int8_route_bound_ms", "cudnn_bf16_bound_ms")}
    out = {"phase": "int8_disc", "card": smi, "B": TRAIN_B, "T": TRAIN_T, "compute_dtype": "bfloat16",
           "int8_layers": int8_layers, "int8_launches_per_step": launches / n_steps,
           "train_step": step_rows, "int8_over_float_step": step_rows["int8"]["ms_median"]
           / step_rows["float"]["ms_median"],
           "last_logs": {k: v[-1] for k, v in logs.items()},
           "shapes_b32": len(conv_rows), "calls_by_shape": {str(k): v for k, v in shapes.items()},
           "sum_over_b32_shapes": total}
    emit(out)
    if int8_layers != 3 * 6 + 5:
        raise AssertionError(f"{int8_layers} int8 layers in the published discriminator, not 23")
    if not all(math.isfinite(v) for lg in logs.values() for row in lg for v in row.values()):
        raise AssertionError(f"a loss or a gradient norm of a train step is not finite: {out['last_logs']}")
    if not any("grad_2.0_norm" in k for k in logs["int8"][-1]):
        raise AssertionError("the train step logged no gradient norm")
    if launches == 0 or len(conv_rows) != int8_layers:
        raise AssertionError(f"int8 launches {launches}, {len(conv_rows)} shapes at batch {TRAIN_B}")
    return out


NOISY_CLI_ARGS = ("lightning_datamodule=noisybwe", "lightning_module=eben", "callbacks=bwe_checkpoint",
                  "logging=csv", "lightning_datamodule.dataset_name=synthetic",
                  "++lightning_datamodule.synthetic_size=64",
                  "++trainer.limit_val_batches=4", "++trainer.limit_test_batches=4", "++trainer.max_epochs=2")


def phase_cli_noisybwe(run_dir: str) -> dict:
    """``run.main`` with NOISY_CLI_ARGS in ``run_dir``: noisybwe.yaml
    as published (its ``aggressive`` augmentation) on the synthetic source,
    fit two epochs of two steps at batch 32, validating four batches of
    each of the ``synthetic`` and ``real`` loaders an epoch, then
    test("last") on four of each.  The counts are reset before the run and
    read at the test's entry and at its end.  Every eval batch is recorded:
    the real loader's have no airborne key, so their eval step runs the
    generator only (K1, no K3) and returns no losses, and the test logs no
    metric for them.  Each train step is timed by CUDA events beside its
    data wait."""
    from vibravox_tpu_torch import run

    marks: dict = {"events": [], "eval": []}
    train_step, eval_step, test, fit = EBENTask.train_step, EBENTask.eval_step, Trainer.test, Trainer.fit

    def timed_train_step(self, state, batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = train_step(self, state, batch)
        end.record()
        marks["events"].append((start, end))
        return out

    def recorded_eval_step(self, state, batch):
        t0 = time.perf_counter()
        out = eval_step(self, state, batch)
        torch.cuda.synchronize()
        marks["eval"].append({"reference": "audio_airborne" in batch,
                              "T": int(batch["audio_body_conducted"].shape[1]), "logs": len(out["logs"]),
                              "ms": 1e3 * (time.perf_counter() - t0)})
        return out

    def marked_test(self, *args, **kwargs):
        torch.cuda.synchronize()
        marks["fit_end"], marks["fit_counts"], marks["fit_evals"] = time.perf_counter(), read_counts(), len(marks["eval"])
        return test(self, *args, **kwargs)

    def kept_fit(self, *args, **kwargs):
        marks["trainer"] = self
        return fit(self, *args, **kwargs)

    EBENTask.train_step, EBENTask.eval_step, Trainer.test, Trainer.fit = (
        timed_train_step, recorded_eval_step, marked_test, kept_fit)
    try:
        reset_counts()
        t0 = time.perf_counter()
        metrics = run.main([*NOISY_CLI_ARGS, f"++run_dir={run_dir}"])
        torch.cuda.synchronize()
        test_s = time.perf_counter() - marks["fit_end"]
        counts = read_counts()
        ckpt = Path(run_dir) / "checkpoints"
        have_last = (ckpt / "last" / "state.pt").exists()
        progress = json.loads((ckpt / "trainer_state.json").read_text())
    finally:
        EBENTask.train_step, EBENTask.eval_step, Trainer.test, Trainer.fit = train_step, eval_step, test, fit

    fit_counts = marks["fit_counts"]
    launches = {"fit": fit_counts, "test": {k: counts[k] - fit_counts[k] for k in counts}}
    steps = {"train_step_ms": [a.elapsed_time(b) for a, b in marks["events"]],
             "data_wait_ms": [1e3 * w for w in marks["trainer"].data_wait_seconds]}
    evals = {"fit": marks["eval"][:marks["fit_evals"]], "test": marks["eval"][marks["fit_evals"]:]}
    real = {k: [e for e in v if not e["reference"]] for k, v in evals.items()}
    out = {"phase": "cli_noisybwe", "epochs": 2, "steps": 2 * CLI_STEPS_PER_EPOCH, "B": 32,
           "augmentation": "aggressive", "fit_wall_s": marks["fit_end"] - t0, "test_wall_s": test_s,
           "launches": launches, "trainer_state": progress, "last": have_last, "metrics": metrics, **steps,
           "data_wait_against_step": wait_against_step(steps),
           "real_batches": {k: {"count": len(v), "T": [e["T"] for e in v], "losses_logged": sum(e["logs"] for e in v),
                                "eval_step_ms": [e["ms"] for e in v]} for k, v in real.items()},
           "synthetic_batches": {k: len(v) - len(real[k]) for k, v in evals.items()}}
    emit(out)
    val, tests = CLI_VAL_BATCHES, CLI_TEST_BATCHES
    want = {"fit": {"K1": 6 * (2 * CLI_STEPS_PER_EPOCH + 2 * 2 * val), "K2": 6 * 2 * CLI_STEPS_PER_EPOCH,
                    "K3": 6 * (2 * CLI_STEPS_PER_EPOCH + 2 * val), "K4": 6 * 2 * CLI_STEPS_PER_EPOCH,
                    "C1": C1_PER_STEP * 2 * CLI_STEPS_PER_EPOCH, "C2": 0},
            "test": {"K1": 6 * 2 * tests, "K2": 0, "K3": 6 * tests, "K4": 0, "C1": 0, "C2": 0}}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} on the noisy CLI's fit and test, expected {want}")
    if progress != {"epoch": 1, "global_step": 4} or not have_last or len(steps["train_step_ms"]) != 4:
        raise AssertionError(f"the noisy CLI's fit: progress {progress}, last {have_last}, steps {steps}")
    if not (len(real["fit"]) == 2 * val and len(real["test"]) == tests
            and not any(e["logs"] for v in real.values() for e in v)):
        raise AssertionError(f"the real loader's reference-free batches: {out['real_batches']}")
    if not ({"test/torchmetrics_stoi/synthetic", "test/torchmetrics_si_sdr/synthetic"} <= set(metrics)
            and not any(k.endswith("/real") for k in metrics)
            and all(math.isfinite(v) for v in metrics.values())):
        raise AssertionError(f"the noisy CLI's test metrics {metrics}")
    return out


# ---------------------------------------------------------------------------
# the STP slice: wav2vec2-CTC speech-to-phoneme (no hand-written kernel)
# ---------------------------------------------------------------------------

STP_B = 8  # stp.yaml's batch_size
STP_STEPS, STP_WARMUP, STP_PROFILE_STEPS = 28, 4, 5
STP_PARITY_T = 48000  # 3 s: 149 frames
STP_NARROW = dict(hidden_size=256, num_hidden_layers=4, num_attention_heads=4, intermediate_size=1024)
STP_QUIET = dict(hidden_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0, mask_time_prob=0.0,
                 mask_feature_prob=0.0, layerdrop=0.0)
STP_CLI_EPOCH_STEPS, STP_CLI_VAL_BATCHES, STP_CLI_TEST_BATCHES = 2, 2, 4


def stp_workers() -> int:
    """stp.yaml's 16 loader workers, capped at the host's CPU count."""
    return min(16, os.cpu_count() or 1)


def stp_weights(directory: str) -> str:
    """The base model (seed 0, random weights) written as a pretraining
    checkpoint: config.json and pytorch_model.bin without lm_head, the
    layout of a hub wav2vec2, read by the published from_pretrained config."""
    save_pretrained(wav2vec2_for_ctc_from_config(seed=0, device="cpu"), directory, with_lm_head=False)
    return directory


def stp_args(weights: str) -> list:
    return ["lightning_datamodule=stp", "lightning_module=wav2vec2_for_stp",
            "lightning_datamodule.dataset_name_principal=synthetic",
            f"lightning_module.wav2vec2_for_ctc.pretrained_model_name_or_path={weights}",
            f"++lightning_datamodule.num_workers={stp_workers()}"]


def phase_stp_parity() -> dict:
    """float32, cuDNN's convolutions in IEEE float32 (``strict_float32``).
    The base model (seed 0) in eval on 2 x 48000 samples, card against CPU
    (logits 1e-4 of scale); one train step at hidden 256 / 4 layers (the
    base conv stack, frozen as in the recipe; dropouts, SpecAugment and
    layerdrop off; SGD lr 1e-3, so an update is proportional to its
    gradient) on a synthetic STP batch (loss 1e-4 relative, parameters
    within 1e-2 of the update, per tensor; the attention's key biases, whose
    gradient is 0 but for noise, must move by at most 1e-6 of the largest
    update on both sides); the CTC loss at the recipe's shapes (B 8, 149-299
    frames, 38 classes, labels padded to 128; value 1e-5 relative; the
    gradient of the summed losses within 1e-5 + 1e-6 x its row's loss: each
    CTC posterior is exp(alpha + beta - loss) from float32 sums whose
    rounding grows with the loss, and at these shapes (losses 468-905) the
    CPU's float32 gradient is 1.5-3.3e-7 x the loss from float64's)."""
    out = {"phase": "stp_parity"}
    gen = np.random.default_rng(5)
    with strict_float32():
        cpu = wav2vec2_for_ctc_from_config(seed=0, device="cpu")
        gpu = wav2vec2_for_ctc_from_config(seed=0, device="cuda")
        gpu.load_state_dict(cpu.state_dict(), strict=True)
        x = torch.from_numpy(gen.standard_normal((2, STP_PARITY_T)).astype(np.float32))
        t0 = time.perf_counter()
        with torch.no_grad():
            want = cpu(x)
        cpu_s = time.perf_counter() - t0
        with torch.no_grad():
            got = gpu(x.cuda()).cpu()
        out["base_eval"] = {"B": 2, "T": STP_PARITY_T, "frames": int(want.shape[1]), "cpu_forward_s": cpu_s,
                            "err_over_scale": rel_err(got, want), "tol": 1e-4}
        del cpu, gpu

        tok = load_phoneme_tokenizer()
        src = SyntheticSTPSource(tok, n_utterances=2, sample_rate=16000, split="stp-train")
        batch = STPCollate(Wav2Vec2FeatureExtractor(), tok, deterministic=True)([src[0], src[1]])
        tasks = {}
        for device in ("cpu", "cuda"):
            model = wav2vec2_for_ctc_from_config(seed=1, device=device, **STP_NARROW, **STP_QUIET)
            tasks[device] = Wav2Vec2STPTask(wav2vec2_for_ctc=model, optimizer=sgd(1e-3), device=device)
        tasks["cuda"].wav2vec2_for_ctc.load_state_dict(tasks["cpu"].wav2vec2_for_ctc.state_dict())
        before = {k: v.detach().clone() for k, v in tasks["cpu"].wav2vec2_for_ctc.state_dict().items()}
        t0 = time.perf_counter()
        _, logs_cpu = tasks["cpu"].train_step(tasks["cpu"].init_state(0), batch)
        step_cpu_s = time.perf_counter() - t0
        _, logs_gpu = tasks["cuda"].train_step(tasks["cuda"].init_state(0), batch)
        after_cpu = tasks["cpu"].wav2vec2_for_ctc.state_dict()
        after_gpu = {k: v.cpu() for k, v in tasks["cuda"].wav2vec2_for_ctc.state_dict().items()}
        largest = max(float((after_cpu[k] - b).norm()) for k, b in before.items())
        worst, bad = 0.0, []
        for k, b in before.items():
            step, diff = float((after_cpu[k] - b).norm()), float((after_gpu[k] - after_cpu[k]).norm())
            if "attention.k_proj.bias" in k:
                if max(step, float((after_gpu[k] - b).norm())) > 1e-6 * largest:
                    bad.append(k)
                continue
            if diff > 1e-2 * step + 1e-7:
                bad.append(k)
            if step > 0:
                worst = max(worst, diff / step)
        loss_cpu, loss_gpu = float(logs_cpu["train/ctc_loss"]), float(logs_gpu["train/ctc_loss"])
        out["narrow_train_step"] = {"B": 2, "T": int(batch["audio"].shape[1]), **STP_NARROW,
                                    "cpu_step_s": step_cpu_s, "loss_cpu": loss_cpu, "loss_gpu": loss_gpu,
                                    "loss_rel_err": abs(loss_gpu - loss_cpu) / abs(loss_cpu), "loss_tol": 1e-4,
                                    "params_max_diff_over_update": worst, "params_tol": 1e-2,
                                    "params_out_of_tol": bad}
        del tasks

        lengths = [299, 280, 250, 220, 200, 180, 160, 149]
        labels_n = [60, 55, 50, 45, 40, 35, 30, 25]
        logits = torch.from_numpy(gen.standard_normal((STP_B, 299, 38)).astype(np.float32))
        logit_pad = torch.zeros(STP_B, 299)
        labels = torch.zeros(STP_B, 128, dtype=torch.int32)
        label_pad = torch.ones(STP_B, 128)
        for b, (t, n) in enumerate(zip(lengths, labels_n)):
            logit_pad[b, t:] = 1
            labels[b, :n] = torch.from_numpy(gen.integers(0, 35, n).astype(np.int32))
            label_pad[b, :n] = 0
        res = {}
        for device in ("cpu", "cuda"):
            lg = logits.to(device, copy=True).requires_grad_(True)
            per = ctc_loss(lg, logit_pad.to(device), labels.to(device), label_pad.to(device), blank_id=35)
            per.sum().backward()
            res[device] = (per.detach().cpu(), lg.grad.cpu())
        value_err = float(((res["cuda"][0] - res["cpu"][0]).abs() / res["cpu"][0].abs()).max())
        grad_err = (res["cuda"][1] - res["cpu"][1]).abs().amax(dim=(1, 2))
        grad_tol = 1e-5 + 1e-6 * res["cpu"][0]
        out["ctc"] = {"B": STP_B, "frames": lengths, "labels": labels_n, "classes": 38, "label_pad_to": 128,
                      "value_rel_err": value_err, "value_tol": 1e-5, "grad_abs_err_per_row": grad_err.tolist(),
                      "grad_tol_per_row": grad_tol.tolist(), "losses_cpu": res["cpu"][0].tolist()}
    emit(out)
    if not out["base_eval"]["err_over_scale"] <= 1e-4:
        raise AssertionError("the base model's logits on the card differ from the CPU's")
    step = out["narrow_train_step"]
    if not (step["loss_rel_err"] <= 1e-4 and not bad):
        raise AssertionError(f"the STP train step on the card differs from the CPU's: {step}")
    if not (value_err <= 1e-5 and bool((grad_err <= grad_tol).all())):
        raise AssertionError(f"the CTC loss on the card differs from the CPU's: {out['ctc']}")
    return out


def wav2vec2_flops(config, batch: int, samples: int) -> tuple:
    """Forward FLOPs of a wav2vec2 (2 per multiply-add), counted from the
    config: (the conv stack, everything after it up to the CTC head)."""
    t, cin, conv = samples, 1, 0.0
    for dim, k, s in zip(config.conv_dim, config.conv_kernel, config.conv_stride):
        t = (t - k) // s + 1
        conv += 2 * cin * dim * k * t * batch
        cin = dim
    h, f, v = config.hidden_size, config.intermediate_size, config.vocab_size
    tokens = t * batch
    rest = 2 * cin * h * tokens  # feature projection
    rest += 2 * (h // config.num_conv_pos_embedding_groups) * h * config.num_conv_pos_embeddings * tokens
    per_layer = 2 * (4 * h * h + 2 * h * f) * tokens + 2 * 2 * t * t * h * batch  # projections, FFN, QK^T and PV
    rest += config.num_hidden_layers * per_layer + 2 * h * v * tokens
    return conv, rest


def stp_step_flops(config, batch: int, samples: int) -> float:
    """Model FLOPs of one train step: the frozen conv stack forward once,
    everything after it forward and backward (3x its forward: the backward
    computes the gradients of both the activations and the weights)."""
    conv, rest = wav2vec2_flops(config, batch, samples)
    return conv + 3 * rest


def pos_conv_ms(task, frames: int) -> dict:
    """The grouped positional conv of the base model alone at the step's
    shape (B 8, 768 channels, ``frames``), in bf16 as in the step and in
    float32 (IEEE): forward, and forward plus backward, by CUDA events."""
    pos = task.wav2vec2_for_ctc.wav2vec2.encoder.pos_conv_embed
    h = torch.randn(STP_B, frames, pos.conv.in_channels, device="cuda", requires_grad=True)
    out = {"frames": frames}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        def fwd():
            with torch.no_grad():
                pos(h, dtype)

        def fwd_bwd():
            pos(h, dtype).sum().backward()

        with strict_float32():
            out[f"{name}_forward_ms"] = cuda_ms(fwd, 20)
            out[f"{name}_forward_backward_ms"] = cuda_ms(fwd_bwd, 10)
    return out


def phase_stp_train(weights: str) -> dict:
    """The STP train path: ``Trainer.fit`` of the published task
    (wav2vec2_for_stp.yaml: the base model through its from_pretrained
    config and overrides, the frozen conv stack, Adam 3e-4 / (0.5, 0.9)) on
    the synthetic ``STPDataModule`` of stp.yaml (batch 8, its 16 workers
    capped at the CPU count), ``precision="bf16-mixed"``, STP_STEPS steps
    each synchronised.  Then the untraced wall of STP_PROFILE_STEPS steps
    on one device batch, their device time by kind from a CUDA-only trace,
    the idle share, the positional conv alone, and the model FLOPs a step."""
    from vibravox_tpu_torch import run
    from vibravox_tpu_torch.core.config import compose, instantiate

    cfg = compose(run.CONFIG_DIR, "run", [*stp_args(weights),
                                          f"++lightning_datamodule.synthetic_size={STP_B * STP_STEPS}"])
    run.port_targets(cfg, "cuda")
    torch.manual_seed(0)
    dm = instantiate(cfg.lightning_datamodule)
    task = instantiate(cfg.lightning_module)
    seen = {"T": [], "batch": None}
    train_step = Wav2Vec2STPTask.train_step

    def recorded(self, state, batch):
        seen["T"].append(int(batch["audio"].shape[1]))
        seen["batch"] = batch
        return train_step(self, state, batch)

    trainer = Trainer(max_epochs=1, log_every_n_steps=1, limit_train_batches=STP_STEPS, limit_val_batches=0,
                      sync_every_step=True, precision="bf16-mixed", seed=42)
    torch.cuda.reset_peak_memory_stats()
    Wav2Vec2STPTask.train_step = recorded
    try:
        reset_counts()
        trainer.fit(task, dm)
        counts = read_counts()
    finally:
        Wav2Vec2STPTask.train_step = train_step
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [1e3 * s for s in trainer.step_seconds]
    wait_ms = [1e3 * w for w in trainer.data_wait_seconds]
    losses = [lg["train/ctc_loss"] for _, lg in trainer.logged if "train/ctc_loss" in lg]
    later = step_ms[STP_WARMUP:]
    audio_rate = [STP_B * t / 16000 / (ms / 1e3) for t, ms in zip(seen["T"][STP_WARMUP:], later)]
    config = task.wav2vec2_for_ctc.config
    flops = [stp_step_flops(config, STP_B, t) for t in seen["T"][STP_WARMUP:]]
    mfu = [f / (ms / 1e3) / PEAK_FLOPS[torch.bfloat16] for f, ms in zip(flops, later)]
    out = {"phase": "stp_train", "B": STP_B, "compute_dtype": config.compute_dtype, "workers": stp_workers(),
           "steps": len(step_ms), "warmup_steps": STP_WARMUP, "launches": counts,
           "first_step_ms": step_ms[0], "step_ms_median": float(np.median(later)),
           "step_ms_p10": float(np.percentile(later, 10)), "step_ms_p90": float(np.percentile(later, 90)),
           "step_ms_min": min(later), "step_ms_max": max(later), "step_ms": step_ms,
           "padded_T": seen["T"], "padded_T_seen": sorted(set(seen["T"])),
           "audio_sec_per_sec_median": float(np.median(audio_rate)),
           "first_batch_wait_ms": wait_ms[0], "data_wait_ms_median_after_first": float(np.median(wait_ms[1:])),
           "data_wait_ms": wait_ms, "max_memory_allocated_gib": peak,
           "model_flops_per_step_median": float(np.median(flops)),
           "model_flops_share_of_bf16_peak_median": float(np.median(mfu)),
           "first_loss": losses[0] if losses else None, "last_loss": losses[-1] if losses else None}
    emit(out)
    if len(step_ms) != STP_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"the STP fit ran {len(step_ms)} steps, losses {losses}")
    if any(counts.values()):
        raise AssertionError(f"hand-written kernels launched on the STP path: {counts}")

    batch, state = seen["batch"], trainer.state
    for _ in range(2):
        task.train_step(state, batch)

    def whole(events):
        kinds = [kernel_kind(e.name) for e in events]
        return kinds.count("Adam") >= STP_PROFILE_STEPS and kinds.count("CTC") >= 2 * STP_PROFILE_STEPS

    prof = device_profile(lambda: task.train_step(state, batch), STP_PROFILE_STEPS, "the STP train steps", whole)
    t = int(batch["audio"].shape[1])
    frames = config.feat_extract_output_length(t)
    prof_out = {"phase": "stp_profile", "B": STP_B, "T": t, "frames": frames, "per": "step", **prof,
                "model_flops": stp_step_flops(config, STP_B, t),
                "model_flops_share_of_bf16_peak_untraced": stp_step_flops(config, STP_B, t)
                / (prof["wall_us_untraced"] / 1e6) / PEAK_FLOPS[torch.bfloat16],
                "pos_conv_alone": pos_conv_ms(task, frames)}
    emit(prof_out)
    return {"train": out, "profile": prof_out}


def phase_cli_stp(weights: str, run_dir: str) -> dict:
    """``run.main`` with ``lightning_datamodule=stp lightning_module=wav2vec2_for_stp
    callbacks=stp_checkpoint logging=csv`` on the synthetic source (16
    utterances: two steps an epoch at batch 8) and the base model through
    the published from_pretrained config reading ``weights``: fit two epochs
    (float32, as the published trainer runs) validating two batches an
    epoch, then test("last") on four batch-1 utterances; then again with
    max_epochs 3, which resumes at epoch 2, in ``run_dir`` (phase
    ``scripts`` exports its ``last``).  The fit is timed; each test batch is
    split into the eval step (synchronised) and the host decode + CER.  The
    hand-written kernels' counts are read around each run."""
    from vibravox_tpu_torch import run

    timing = {"eval_step": [], "decode_cer": []}
    marks: dict = {}
    eval_step, eval_metrics, test = Wav2Vec2STPTask.eval_step, Wav2Vec2STPTask.eval_metrics, Trainer.test

    def timed_eval_step(self, state, batch):
        t0 = time.perf_counter()
        out = eval_step(self, state, batch)
        torch.cuda.synchronize()
        timing["eval_step"].append(time.perf_counter() - t0)
        return out

    def timed_metrics(self, outputs):
        t0 = time.perf_counter()
        out = eval_metrics(self, outputs)
        timing["decode_cer"].append(time.perf_counter() - t0)
        return out

    def marked_test(self, *args, **kwargs):
        torch.cuda.synchronize()
        marks["fit_end"] = time.perf_counter()
        for v in timing.values():
            v.clear()
        return test(self, *args, **kwargs)

    def run_cli(run_dir, epochs):
        reset_counts()
        t0 = time.perf_counter()
        metrics = run.main([*stp_args(weights), "callbacks=stp_checkpoint", "logging=csv",
                            "++lightning_datamodule.synthetic_size=16",
                            f"++trainer.limit_val_batches={STP_CLI_VAL_BATCHES}",
                            f"++trainer.limit_test_batches={STP_CLI_TEST_BATCHES}",
                            f"++trainer.max_epochs={epochs}", f"++run_dir={run_dir}"])
        torch.cuda.synchronize()
        end = time.perf_counter()
        progress = json.loads((Path(run_dir) / "checkpoints" / "trainer_state.json").read_text())
        return {"epochs": epochs, "fit_wall_s": marks["fit_end"] - t0, "test_wall_s": end - marks["fit_end"],
                "test_s_per_batch": (end - marks["fit_end"]) / STP_CLI_TEST_BATCHES,
                "eval_step_ms": [1e3 * s for s in timing["eval_step"]],
                "decode_cer_ms": [1e3 * s for s in timing["decode_cer"]],
                "launches": read_counts(), "trainer_state": progress, "metrics": metrics,
                "last": (Path(run_dir) / "checkpoints" / "last" / "state.pt").exists()}

    Wav2Vec2STPTask.eval_step, Wav2Vec2STPTask.eval_metrics, Trainer.test = timed_eval_step, timed_metrics, marked_test
    try:
        first = run_cli(run_dir, 2)
        resumed = run_cli(run_dir, 3)
    finally:
        Wav2Vec2STPTask.eval_step, Wav2Vec2STPTask.eval_metrics, Trainer.test = eval_step, eval_metrics, test
    out = {"phase": "cli_stp", "B": STP_B, "steps_per_epoch": STP_CLI_EPOCH_STEPS,
           "val_batches": STP_CLI_VAL_BATCHES, "test_batches": STP_CLI_TEST_BATCHES, "workers": stp_workers(),
           "first": first, "resumed": resumed}
    emit(out)
    for r, progress in ((first, {"epoch": 1, "global_step": 4}), (resumed, {"epoch": 2, "global_step": 6})):
        m = r["metrics"]
        if set(m) != {"test/ctc_loss", "test/char_error_rate"} or not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"the STP CLI's test metrics {m}")
        if r["trainer_state"] != progress or not r["last"]:
            raise AssertionError(f"the STP CLI's progress {r['trainer_state']}, last {r['last']}")
        if any(r["launches"].values()):
            raise AssertionError(f"hand-written kernels launched on the STP CLI: {r['launches']}")
        if len(r["eval_step_ms"]) != STP_CLI_TEST_BATCHES:
            raise AssertionError(f"timed test batches {r['eval_step_ms']}")
    return out


def phase_scripts(cli_dir: str, stp_cli_dir: str, smi: str) -> dict:
    """The port's remaining scripts on this run's own checkpoints, in a
    temporary directory: ``push_dis_to_hub`` on phase ``cli``'s ``last``,
    its export loaded on the card by ``eben_discriminator_from_pretrained``
    bit-equal to the checkpoint's discriminator; ``upload_phonemizer_to_hub``
    on phase ``cli_stp``'s ``last`` (the base model), loaded on the card by
    ``wav2vec2_for_ctc_from_pretrained`` bit-equal to the checkpoint's
    model; ``test_all_phonemizers`` on that export over the six sensors of
    the synthetic source, two utterances each, on the card (finite PERs);
    ``sweep --dry-run`` over the three published tables (one command a
    line).  Each script's wall."""
    import contextlib
    import io

    from vibravox_tpu_torch.models.hub import eben_discriminator_from_pretrained
    from vibravox_tpu_torch.models.wav2vec2 import wav2vec2_for_ctc_from_pretrained
    from vibravox_tpu_torch.scripts import push_dis_to_hub, sweep, test_all_phonemizers, upload_phonemizer_to_hub

    def same(sd, model):
        got = model.state_dict()
        return list(got) == list(sd) and all(torch.equal(got[k].cpu(), sd[k].cpu()) for k in sd)

    wall = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        return out

    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix="vibravox_scripts_") as tmp:
        last = Path(cli_dir) / "checkpoints" / "last"
        timed("push_dis_to_hub", lambda: push_dis_to_hub.main(["--checkpoint", str(last), "--out", f"{tmp}/dis"]))
        disc_sd = torch.load(last / "state.pt", map_location="cpu", weights_only=True)["discriminator"]
        disc = eben_discriminator_from_pretrained(f"{tmp}/dis/discriminator", q=4, min_channels=24)
        disc_equal = same(disc_sd, disc) and next(disc.parameters()).is_cuda
        stp_last = Path(stp_cli_dir) / "checkpoints" / "last"
        timed("upload_phonemizer_to_hub", lambda: upload_phonemizer_to_hub.main(
            ["--checkpoint", str(stp_last), "--out", f"{tmp}/phonemizer"]))
        model_sd = torch.load(stp_last / "state.pt", map_location="cpu", weights_only=True)["model"]
        model = wav2vec2_for_ctc_from_pretrained(f"{tmp}/phonemizer")
        phonemizer_equal = same(model_sd, model) and next(model.parameters()).is_cuda
        exported = sorted(p.name for p in Path(f"{tmp}/phonemizer").iterdir())
        del model
        per = timed("test_all_phonemizers", lambda: test_all_phonemizers.main(
            ["--dataset", "synthetic", "--phonemizers", f"{tmp}/phonemizer", "--out", f"{tmp}/per", "--limit", "2"]))
        confusions = json.loads(Path(f"{tmp}/per/confusions.json").read_text())
        dry = {}
        for table in ("bwe", "spkv", "stp"):
            path = root / "configs" / "sweeps" / f"{table}.txt"
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                timed(f"sweep_{table}", lambda: sweep.main([str(path), "--dry-run"]))
            lines = buf.getvalue().splitlines()
            dry[table] = {"commands": len(lines), "table_lines": len(sweep.commands(str(path))),
                          "first": lines[0] if lines else None}
    out = {"phase": "scripts", "card": smi, "discriminator_bit_equal": disc_equal,
           "phonemizer_bit_equal": phonemizer_equal,
           "phonemizer_files": exported, "per_matrix": per, "confusion_kinds": len(confusions),
           "sweep_dry_run": dry, "wall_s": wall}
    emit(out)
    if not (disc_equal and phonemizer_equal):
        raise AssertionError(f"an export did not load back bit-equal: {out}")
    if len(per) != 6 or not all(math.isfinite(v) for v in per.values()):
        raise AssertionError(f"the PER matrix {per}")
    if not all(d["commands"] == d["table_lines"] > 0 and "-m vibravox_tpu_torch.run" in d["first"]
               for d in dry.values()):
        raise AssertionError(f"the sweep's dry runs {dry}")
    return out


SPKV_B, SPKV_T = 32, 48000  # bench.py's spkv regime: b32, 3 s at 16 kHz
SPKV_WARMUP, SPKV_BATCHES, SPKV_PROFILE_BATCHES = 3, 20, 5
MEL = (512, 160, 400)  # the log-mel front end's fft, hop, win (ops/mel.py)
MEL_LOG_TOL, SPKV_EMB_TOL, SPKV_BF16_TOL = 1e-3, 1e-4, 0.08
SPKV_CLI_ARGS = ("lightning_datamodule=spkv", "lightning_module=ecapa2", "logging=csv",
                 "lightning_datamodule.dataset_name=synthetic")
SPKV_CLI_TRIALS = 120  # the synthetic test split: 24 utterances, 4 speakers, 60 target + 60 non-target


def randomise_batch_norms(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every BatchNorm's affine parameters and running statistics drawn
    from ``seed``, so the comparisons exercise them."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    return model


def ecapa2_flops(config, batch: int, samples: int) -> float:
    """Model FLOPs of one ECAPA2 forward, counted from the config's conv and
    dense shapes (2 per multiply-add); the front end's FFT and mel product
    are not counted."""
    frames = 1 + samples // MEL[1]
    freq, cin = config.n_mels, config.stem_channels
    flops = 2 * 9 * cin * frames * freq  # the stem
    for ch, n_blocks, stride in config.lfe_stages:
        for bi in range(n_blocks):
            s = stride if bi == 0 else 1
            freq = (freq - 1) // s + 1
            flops += 2 * 9 * (cin + ch) * ch * frames * freq  # conv1, conv2
            flops += 2 * 2 * freq * 128  # fwSE
            if cin != ch or s != 1:
                flops += 2 * cin * ch * frames * freq  # shortcut
            cin = ch
    c, width = config.gfe_channels, config.gfe_channels // config.res2_scale
    flops += 2 * freq * cin * c * frames  # gfe_proj
    flops += 2 * 2 * c * c * frames + 2 * (config.res2_scale - 1) * 3 * width * width * frames  # conv_in / out, res2
    flops += 2 * 2 * c * 128  # SE
    flops += 2 * (3 * c * 128 + 128 * c) * frames  # attention
    flops += 2 * 2 * c * config.embed_dim
    return float(flops * batch)


def mel_err(feats: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |difference| of log-mel features on the bins whose power is at
    least 1e-6 of their frame's largest."""
    power = ref.exp()
    loud = power >= 1e-6 * power.amax(dim=-1, keepdim=True)
    return float((feats.cpu() - ref).abs()[loud].max())


def embedder_parity(name: str, make, audio: torch.Tensor) -> tuple:
    """One embedder (seed 0, BatchNorms randomised) on the card against the
    same weights on the CPU, float32: its log-mel features and embeddings;
    one K3 launch per card forward.  Returns the row and the card's model."""
    torch.manual_seed(0)
    cpu = randomise_batch_norms(make("cpu"), 1)
    card = make("cuda")
    card.load_state_dict(cpu.state_dict())
    with torch.no_grad():
        ref_feats, ref = cpu.features(audio), cpu(audio)
        feats = card.features(audio.cuda())
        before = framed_dft_magnitude.launches
        out = card(audio.cuda())
        torch.cuda.synchronize()
        launches = framed_dft_magnitude.launches - before
    row = {"embedder": name, "B": audio.shape[0], "T": audio.shape[1],
           "params": sum(p.numel() for p in cpu.parameters()),
           "log_mel_max_abs_err": mel_err(feats, ref_feats), "log_mel_tol": MEL_LOG_TOL,
           "embedding_err_over_scale": rel_err(out.cpu(), ref), "embedding_tol": SPKV_EMB_TOL,
           "k3_launches_per_forward": launches}
    emit({"phase": "spkv_parity", **row})
    if not (row["log_mel_max_abs_err"] <= MEL_LOG_TOL and row["embedding_err_over_scale"] <= SPKV_EMB_TOL):
        raise AssertionError(f"{name} on the card disagrees with the CPU: {row}")
    if launches != 1 or out.shape != (audio.shape[0], ref.shape[1]):
        raise AssertionError(f"{name}: {launches} K3 launches a forward, output {tuple(out.shape)}")
    return row, card


def k3_mel_row(b: int, t: int, gen: torch.Generator) -> dict:
    """K3 against its plain version at the front end's fft / hop / win, with
    kernel, plain, library (``torch.stft(...).abs()``) and bound times of
    whole wrapper calls, in turns (the median of each)."""
    fft, hop, win = MEL
    x = (torch.randn(b, t, generator=gen) * 0.1).cuda()
    mag = framed_dft_magnitude(x, fft, hop, win)
    ref = plain_framed_dft_magnitude(x, fft, hop, win)
    torch.cuda.synchronize()
    window = hann_window(win, device="cuda")
    times = {k: [] for k in ("kernel", "plain", "library")}
    for _ in range(3):
        times["kernel"].append(cuda_ms(lambda: framed_dft_magnitude(x, fft, hop, win), iters=20))
        times["plain"].append(cuda_ms(lambda: plain_framed_dft_magnitude(x, fft, hop, win), iters=10))
        times["library"].append(cuda_ms(lambda: torch.stft(
            x, fft, hop_length=hop, win_length=win, window=window, center=True, pad_mode="reflect",
            return_complex=True).abs(), iters=20))
    ops_ms, bytes_ms = dft_bound_ms(b, t, fft, hop, win, backward=False)
    bound_ms, bound_by = bound(ops_ms, bytes_ms)
    row = {"fft": fft, "hop": hop, "win": win, "B": b, "T": t, "frames": 1 + t // hop, "bins": fft // 2 + 1,
           "k3_err_over_scale": rel_err(mag, ref), "k3_tol": K3_TOL,
           "kernel_ms": float(np.median(times["kernel"])), "plain_ms": float(np.median(times["plain"])),
           "library_ms": float(np.median(times["library"])), "ops_ms": ops_ms, "bytes_ms": bytes_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "times_ms": times}
    emit({"phase": "spkv_parity", **row})
    if not (mag.shape == ref.shape and row["k3_err_over_scale"] <= K3_TOL):
        raise AssertionError(f"K3 disagrees with its plain version at the log-mel shape: {row}")
    return row


def phase_spkv_parity() -> dict:
    """float32, cuDNN's convolutions in IEEE float32 (the embedders set it
    themselves).  The full-width ECAPA2 and ECAPA-TDNN at their default
    widths (seed 0, BatchNorms randomised) on 2 x 48000 samples of the
    synthetic speech, card against CPU: log-mel features within 1e-3 (log
    units) on the bins whose power is at least 1e-6 of their frame's
    largest, embeddings within 1e-4 of scale; ECAPA2's bf16 trunk on the
    card within 0.08 of scale of its float32 (the JAX package's bar); then
    K3 against its plain version at fft 512 / hop 160 / win 400 at (32,
    48000) and at one ragged batch-1 trial, with times."""
    source = SyntheticVibravoxSource(n_utterances=2, split="spkv-test", with_metadata=True)
    audio = torch.stack([torch.from_numpy(source[i]["audio_body_conducted"][:SPKV_T]) for i in range(2)])
    ecapa2, card = embedder_parity("ECAPA2 full", lambda d: ECAPA2(device=d), audio)
    tdnn, _ = embedder_parity("ECAPATDNN default", lambda d: ECAPATDNN(device=d), audio)
    bf16 = ECAPA2(dataclasses.replace(card.config, compute_dtype="bfloat16"), device="cuda")
    bf16.load_state_dict(card.state_dict())
    with torch.no_grad():
        e32, e16 = card(audio.cuda()), bf16(audio.cuda())
    bf16_row = {"embedder": "ECAPA2 full, bf16 trunk against float32 on the card",
                "embedding_err_over_scale": rel_err(e16, e32), "embedding_tol": SPKV_BF16_TOL,
                "dtype": str(e16.dtype)}
    emit({"phase": "spkv_parity", **bf16_row})
    if not (bf16_row["embedding_err_over_scale"] <= SPKV_BF16_TOL and e16.dtype == torch.float32):
        raise AssertionError(f"the bf16 trunk is off its float32: {bf16_row}")
    gen = torch.Generator().manual_seed(11)
    ragged = len(source[1]["audio_body_conducted"])
    k3 = [k3_mel_row(SPKV_B, SPKV_T, gen), k3_mel_row(1, ragged, gen)]
    return {"embedders": [ecapa2, tdnn, bf16_row], "k3": k3}


def phase_spkv_embed() -> dict:
    """bench.py's spkv regime on the port: the full-width ECAPA2 (seed 0)
    on batches of 32 x 3 s of noise, 3 warm-up batches then 20 timed ones,
    each synchronised, with the bf16 trunk (bench.py's default) and in
    float32: ms a batch, audio-s/s, peak memory, model FLOPs and their
    share of the type's peak, the K1-K4 launches (K3 once a batch); then
    ``device_profile`` of 5 batches."""
    out = {}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((SPKV_B, SPKV_T)).astype(np.float32)).cuda()
    for dtype in ("bfloat16", "float32"):
        torch.manual_seed(0)
        model = ecapa2_from_config(compute_dtype=dtype, device="cuda").eval()
        result = {}

        def batch():
            result["emb"] = model(x)

        flops = ecapa2_flops(model.config, SPKV_B, SPKV_T)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            reset_counts()
            ms = timed_calls(batch, SPKV_WARMUP + SPKV_BATCHES)
            counts = read_counts()
            emb = result["emb"]

            def whole(events):
                return sum("framed_dft_magnitude_kernel" in e.name for e in events) >= SPKV_PROFILE_BATCHES

            prof = device_profile(batch, SPKV_PROFILE_BATCHES, f"the {dtype} ECAPA2 batches", whole)
        row = {"phase": "spkv_embed", "compute_dtype": dtype, "B": SPKV_B, "T": SPKV_T,
               "warmup_batches": SPKV_WARMUP, "batches": SPKV_BATCHES,
               **spread(ms, SPKV_WARMUP, SPKV_B * SPKV_T / 16000, flops, getattr(torch, dtype)),
               "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": counts,
               "profile": prof, "embedding_finite": bool(torch.isfinite(emb).all())}
        emit(row)
        want = {"K1": 0, "K2": 0, "K3": SPKV_WARMUP + SPKV_BATCHES, "K4": 0, "C1": 0, "C2": 0}
        if counts != want or not row["embedding_finite"] or emb.shape != (SPKV_B, model.config.embed_dim):
            raise AssertionError(f"the {dtype} embedder's launches {counts} (want {want}), output {tuple(emb.shape)}")
        out[dtype] = row
        del model
    return out


def phase_cli_spkv() -> dict:
    """``run.main`` with ``lightning_datamodule=spkv lightning_module=ecapa2
    logging=csv``, the synthetic source, the published batch 1 and loader
    worker, and the full-width ECAPA2 from a seed-0 state dict written to a
    temporary file (``++lightning_module.checkpoint_path``): 24 test
    utterances of 4 speakers, 120 trials (60 target).  Twice: the published
    ``mixed_gender`` with generated pairs, then ``same_gender`` over the
    pickle of the port's ``gen_pairs_for_spkv``.  Each run's K1-K4 counts
    are reset just before it and read just after (K3 twice a trial, the
    rest 0); the test's seconds per trial are split into the two embedder
    forwards (synchronised) and the host's scoring, the rest being the
    loader (pairs, the source, the collate) and Python."""
    from vibravox_tpu_torch import run
    from vibravox_tpu_torch.scripts.gen_pairs_for_spkv import main as gen_pairs

    timing = {"eval_step": [], "scoring": []}
    marks: dict = {}
    eval_step, batch_end, epoch_end = SPKVTask.eval_step, SPKVTask.on_eval_batch_end, SPKVTask.on_eval_epoch_end
    test = Trainer.test

    def timed(fn, key, sync):
        def wrapper(self, *args):
            t0 = time.perf_counter()
            result = fn(self, *args)
            if sync:
                torch.cuda.synchronize()
            timing[key].append(time.perf_counter() - t0)
            return result
        return wrapper

    def marked_test(self, *args, **kwargs):
        torch.cuda.synchronize()
        marks["fit_end"] = time.perf_counter()
        for v in timing.values():
            v.clear()
        return test(self, *args, **kwargs)

    def run_cli(run_dir, extra):
        reset_counts()
        t0 = time.perf_counter()
        metrics = run.main([*SPKV_CLI_ARGS, f"++lightning_module.checkpoint_path={weights}", *extra,
                            f"++run_dir={run_dir}"])
        torch.cuda.synchronize()
        end = time.perf_counter()
        counts = read_counts()
        trials = len(timing["eval_step"])
        test_s = end - marks["fit_end"]
        forwards_s, scoring_s = sum(timing["eval_step"]), sum(timing["scoring"])
        return {"fit_wall_s": marks["fit_end"] - t0, "test_wall_s": test_s, "trials": trials,
                "test_s_per_trial": test_s / max(trials, 1),
                "embedder_forwards_s_per_trial": forwards_s / max(trials, 1),
                "host_scoring_s_per_trial": scoring_s / max(trials, 1),
                "rest_s_per_trial": (test_s - forwards_s - scoring_s) / max(trials, 1),
                "eval_step_ms_first_5": [1e3 * s for s in timing["eval_step"][:5]],
                "eval_step_ms_median": 1e3 * float(np.median(timing["eval_step"])) if trials else None,
                "launches": counts, "metrics": metrics}

    SPKVTask.eval_step = timed(eval_step, "eval_step", True)
    SPKVTask.on_eval_batch_end = timed(batch_end, "scoring", False)
    SPKVTask.on_eval_epoch_end = timed(epoch_end, "scoring", False)
    Trainer.test = marked_test
    try:
        with tempfile.TemporaryDirectory(prefix="vibravox_spkv_cli_") as tmp:
            torch.manual_seed(0)
            weights = str(Path(tmp) / "ecapa2_full_seed0.pt")
            torch.save(ECAPA2(device="cpu").state_dict(), weights)
            gen_pairs(["--dataset", "synthetic", "--output-dir", str(Path(tmp) / "pairs")])
            mixed = run_cli(str(Path(tmp) / "mixed"), [])
            same = run_cli(str(Path(tmp) / "same"), ["lightning_datamodule.gender_policy=same_gender",
                                                      f"lightning_datamodule.pairs_file={Path(tmp) / 'pairs' / 'same_gender.pkl'}"])
    finally:
        SPKVTask.eval_step, SPKVTask.on_eval_batch_end, SPKVTask.on_eval_epoch_end = eval_step, batch_end, epoch_end
        Trainer.test = test
    out = {"phase": "cli_spkv", "trials": SPKV_CLI_TRIALS, "workers": 1, "mixed_gender": mixed,
           "same_gender": same}
    emit(out)
    keys = {"test/equal_error_rate", "test/eer_threshold", "test/minimum_dcf",
            *(f"test/{d}_{s}" for d in ("cosine", "euclidean")
              for s in ("mean_same", "std_same", "mean_different", "std_different"))}
    for r in (mixed, same):
        m = r["metrics"]
        if set(m) != keys or not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"the SPKV CLI's test metrics {m}")
        want = {"K1": 0, "K2": 0, "K3": 2 * SPKV_CLI_TRIALS, "K4": 0, "C1": 0, "C2": 0}
        if r["trials"] != SPKV_CLI_TRIALS or r["launches"] != want:
            raise AssertionError(f"the SPKV CLI ran {r['trials']} trials, launches {r['launches']} (want {want})")
    return out


MIMI_B, MIMI_PARITY_B = 32, 2  # bench.py's mimi and codec regimes: b32, 2 s at 24 kHz
MIMI_T = 49920  # Mimi.valid_length(2 s): 26 frames of 1920 samples
MIMI_AUDIO_S = 2.0  # the audio in a row, as bench.py's codec regime counts it (MIMI_T is its padded length)
MIMI_WARMUP, MIMI_STEPS, MIMI_PROFILE_STEPS = 3, 20, 5
MIMI_CODE_TIE = 1e-4  # a code the card and the CPU disagree on must be this near a tie
MIMI_LATENT_TOL, MIMI_DECODE_TOL = 1e-4, 1e-3
# the bf16 codec, and the bf16 train step's loss (relative) and gradient,
# against their float32 on the card, of scale: about 2.5x the sound
# readings at full width (1.1e-2, 2.1e-3, 2.1e-2 on an H100)
MIMI_BF16_TOL, MIMI_LOSS_TOL, MIMI_GRAD_TOL = 3e-2, 1e-2, 5e-2
MIMI_CLI_ARGS = ("lightning_datamodule=bwe", "lightning_module=regressive_mimi", "sample_rate=24000",
                 "lightning_datamodule.batch_size=16", "lightning_datamodule.dataset_name_principal=synthetic",
                 "logging=csv", "callbacks=bwe_checkpoint", "++lightning_datamodule.synthetic_size=32",
                 "++trainer.limit_val_batches=2", "++trainer.limit_test_batches=4")
MIMI_CLI_TEST_BATCHES = 4


def mimi_flops(config, batch: int, samples: int) -> dict:
    """Model FLOPs (2 per multiply-add) of ``encode_to_latent`` and of
    ``decode_latent`` on ``batch`` signals of ``samples`` (a whole number of
    frames), counted from the config's conv, dense and codebook shapes;
    attention counts the whole T x T products (SDPA with a mask computes
    them all)."""
    nf, d, ff = config.n_filters, config.dimension, config.transformer_ff

    def transformer(t):
        return config.transformer_layers * (4 * d * d * t + 2 * d * ff * t + 2 * t * t * d)

    length, mult = samples, 1
    enc = 7 * nf * length  # conv_in
    for r in reversed(config.ratios):
        c = mult * nf
        enc += c * (c // 2) * 3 * length + (c // 2) * c * length  # the residual unit
        length //= r
        enc += c * 2 * c * 2 * r * length  # down_i
        mult *= 2
    enc += mult * nf * d * 3 * length  # conv_out
    enc += transformer(length)
    frames = length // config.downsample
    enc += d * d * 2 * config.downsample * frames  # downsample
    dec = 2 * 2 * d * config.rvq_dimension * frames  # both input and output projections, twice
    dec += config.rvq_n_q * config.rvq_codebook_size * config.rvq_dimension * frames  # distances
    dec += d * 2 * config.downsample * frames  # the depthwise upsample
    length = frames * config.downsample
    dec += transformer(length)
    mult = 2 ** len(config.ratios)
    dec += d * mult * nf * 7 * length  # conv_in
    for r in config.ratios:
        c = mult * nf
        dec += c * (c // 2) * 2 * r * length  # up_i
        length *= r
        dec += (c // 2) * (c // 4) * 3 * length + (c // 4) * (c // 2) * length
        mult //= 2
    dec += nf * 3 * length  # conv_out
    return {"encode_to_latent": 2.0 * enc * batch, "decode_latent": 2.0 * dec * batch}


def mimi_speech(b: int, t: int, sample_rate: int = 24000) -> torch.Tensor:
    """(b, t, 1) of the synthetic source's airborne speech."""
    source = SyntheticVibravoxSource(n_utterances=b, sample_rate=sample_rate, split="speech_clean-test")
    rows = [np.resize(source[i]["audio_airborne"], t) for i in range(b)]
    return torch.from_numpy(np.stack(rows)[:, :, None].astype(np.float32))


def rvq_residuals64(quantizer, latent: torch.Tensor, codes: torch.Tensor) -> list:
    """Each stage's input residual (B, T, D), float64, of the CPU's own
    codes: the semantic stage on its projection, the acoustic ones on theirs."""
    out = []
    x = latent.double()
    for part, stages in ((quantizer.semantic, codes[:1]), (quantizer.acoustic, codes[1:])):
        books = part.codebooks.detach().double()
        residual = x @ part.input_proj.weight.detach().double().T
        for q in range(stages.shape[0]):
            out.append(residual)
            residual = residual - books[q][stages[q]]
    return out


def code_agreement(model, latent: torch.Tensor, codes_cpu: torch.Tensor, codes_card: torch.Tensor) -> dict:
    """The share of codes that agree card vs CPU by stage; at each frame's
    first disagreeing stage, both candidates' distances to the CPU's
    residual in float64, which must be within MIMI_CODE_TIE of each other
    (relative): a near tie.  Later stages of such a frame start from
    another residual and are not held."""
    n_q = codes_cpu.shape[0]
    agree = codes_cpu == codes_card
    residuals = rvq_residuals64(model.quantizer, latent, codes_cpu)
    ties, worst = [], 0.0
    first = (~agree).int().argmax(0)  # the first disagreeing stage of each (b, t)
    for b, t in (~agree).any(0).nonzero().tolist():
        q = int(first[b, t])
        part, k = (model.quantizer.semantic, q) if q == 0 else (model.quantizer.acoustic, q - 1)
        book = part.codebooks.detach()[k].double()
        r = residuals[q][b, t]
        d_cpu = float(((r - book[codes_cpu[q, b, t]]) ** 2).sum())
        d_card = float(((r - book[codes_card[q, b, t]]) ** 2).sum())
        rel = abs(d_cpu - d_card) / max(abs(d_cpu), abs(d_card), 1e-30)
        worst = max(worst, rel)
        ties.append({"b": b, "t": t, "stage": q, "rel_distance_gap": rel})
    return {"share_agree_by_stage": agree.float().mean(dim=(1, 2)).tolist(),
            "frames": int(agree.shape[1] * agree.shape[2]),
            "frames_with_a_flip": len(ties), "flips": ties[:20], "worst_rel_distance_gap": worst,
            "rows_all_agree": agree.all(0).all(-1).tolist(), "n_q": n_q}


def randomise_mimi(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Conv biases, LayerNorms' affine parameters and layer scales drawn
    from ``seed`` (the initialisers leave them 0, 1 and 0.01), so the
    comparisons exercise them."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "layer_scale" in name:
                p.copy_(torch.rand(p.shape, generator=gen) * 0.45 + 0.05)
            elif ".norm" in name:
                p.copy_(torch.rand(p.shape, generator=gen) + 0.5 if name.endswith("weight")
                        else torch.randn(p.shape, generator=gen) * 0.1)
            elif name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def mimi_bf16_faults() -> dict:
    """Faults a bf16 path could have, each planted for one comparison: the
    bf16 check must catch each of the first two.  The third is read and
    reported only: torch's bf16 LayerNorm keeps float32 statistics and its
    output feeds only the bf16 projections, so it moves the codec by about
    bf16's rounding."""
    from vibravox_tpu_torch.models.mimi import rvq, seanet

    def no_bias(t, dtype):
        return None if dtype is not None and t is not None and t.ndim == 1 else seanet_cast(t, dtype)

    def bf16_ln(self, x):
        return F.layer_norm(x.bfloat16(), self.normalized_shape, self.weight.bfloat16(), self.bias.bfloat16(),
                            self.eps).float()

    def bf16_rvq():
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(rvq, "nearest", lambda book, x: nearest(book.bfloat16(), x.bfloat16())))
        stack.enter_context(mock.patch.object(rvq.ResidualVectorQuantizer, "forward",
                                              lambda self, x: rvq_forward(self, x.bfloat16().float())))
        return stack

    seanet_cast, nearest, rvq_forward = seanet.cast, rvq.nearest, rvq.ResidualVectorQuantizer.forward
    return {"conv biases lost in bf16": (True, lambda: mock.patch.object(seanet, "cast", no_bias)),
            "RVQ input and distances in bf16": (True, bf16_rvq),
            "transformer LayerNorms in bf16": (False, lambda: mock.patch.object(torch.nn.LayerNorm, "forward",
                                                                                bf16_ln))}


def mimi_grads(model, x: torch.Tensor) -> tuple:
    """The regressive loss of one ``RegressiveMimiTask.train_step`` (body
    ``x * 0.5``, airborne ``x``, the frozen copy at the same weights) and
    the gradient of the trainable side, flat; an SGD of lr 0 leaves the
    weights as they were."""
    task = RegressiveMimiTask(mimi=model, optimizer=sgd(0.0), device="cuda")
    state = task.init_state(0)
    _, logs = task.train_step(state, {"audio_body_conducted": x * 0.5, "audio_airborne": x})
    grad = torch.cat([p.grad.flatten() for p in state.optimizer.param_groups[0]["params"]])
    return float(logs["train/l1_latent_loss"]), grad


def phase_mimi_parity() -> dict:
    """float32 (IEEE, ``strict_float32`` in every method).  The published
    ``MimiConfig()`` at full width from one seed-0 state dict (biases,
    LayerNorms and layer scales randomised) on the card and on the CPU, on
    b2 x 2 s of synthetic speech: ``encode_to_latent`` within
    MIMI_LATENT_TOL of scale; the codes by stage, each disagreement a near
    tie (``code_agreement``); ``decode`` of the CPU's codes, and
    ``decode_latent`` on the rows whose codes all agree (if any), within
    MIMI_DECODE_TOL of scale.  Then the bf16 compute path on the card
    against its float32: the latents and the decode of the same latents
    within MIMI_BF16_TOL of scale and the same codes of those latents, and
    each planted fault of ``mimi_bf16_faults`` caught by one of the two;
    the train step's loss within MIMI_LOSS_TOL (relative) and trainable
    gradient within MIMI_GRAD_TOL of scale."""
    x = mimi_speech(MIMI_PARITY_B, MIMI_T)
    cpu = randomise_mimi(Mimi(seed=0, device="cpu").eval(), 1)
    card = Mimi(seed=0, device="cuda").eval()
    card.load_state_dict(cpu.state_dict())
    before = read_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        latent_cpu = cpu.encode_to_latent(x)
        codes_cpu = cpu.quantizer(latent_cpu)[1]
        rec_cpu = cpu.decode_latent(latent_cpu)
        dec_cpu = cpu.decode(codes_cpu)
        cpu_s = time.perf_counter() - t0
        latent = card.encode_to_latent(x.cuda())
        codes = card.quantizer(latent)[1].cpu()
        rec = card.decode_latent(latent).cpu()
        dec = card.decode(codes_cpu.cuda()).cpu()
        latent = latent.cpu()
    codes_row = code_agreement(cpu, latent_cpu, codes_cpu, codes)
    rows = [i for i, ok in enumerate(codes_row["rows_all_agree"]) if ok]
    out = {"phase": "mimi_parity", "B": MIMI_PARITY_B, "T": MIMI_T, "frames": int(latent.shape[1]),
           "params": sum(p.numel() for p in cpu.parameters()), "cpu_forward_s": cpu_s,
           "latent_err_over_scale": rel_err(latent, latent_cpu), "latent_tol": MIMI_LATENT_TOL,
           "codes": codes_row, "code_tie_tol": MIMI_CODE_TIE,
           "decode_codes_err_over_scale": rel_err(dec, dec_cpu),
           "decode_latent_rows": rows,
           "decode_latent_err_over_scale": rel_err(rec[rows], rec_cpu[rows]) if rows else None,
           "decode_tol": MIMI_DECODE_TOL}
    del cpu
    bf16 = Mimi(seed=0, device="cuda", compute_dtype="bfloat16").eval()
    bf16.load_state_dict(card.state_dict())
    xc, latent = x.cuda(), latent.cuda()

    def bf16_errs() -> dict:
        """The bf16 codec against float32: the latents and the decode of the
        same latents, of scale, and the codes of those latents, which the
        float32 RVQ must give unchanged."""
        with torch.no_grad():
            lat16, rec16 = bf16.encode_to_latent(xc), bf16.decode_latent(latent)
            codes16 = bf16.quantizer(latent)[1]
        return {"latent": rel_err(lat16, latent), "decode_latent": rel_err(rec16, rec32),
                "codes_differ": int((codes16 != codes32).sum()), "dtypes": [str(lat16.dtype), str(rec16.dtype)]}

    def caught(errs) -> bool:
        return max(errs["latent"], errs["decode_latent"]) > MIMI_BF16_TOL or errs["codes_differ"] > 0

    with torch.no_grad():
        rec32, codes32 = card.decode_latent(latent), card.quantizer(latent)[1]
    sound = bf16_errs()
    faults = {}
    for name, (must_catch, plant) in mimi_bf16_faults().items():
        with plant():
            errs = bf16_errs()
        faults[name] = {"err_over_scale": max(errs["latent"], errs["decode_latent"]),
                        "codes_differ": errs["codes_differ"], "caught": caught(errs), "must_catch": must_catch}
    loss32, grad32 = mimi_grads(card, xc)
    loss16, grad16 = mimi_grads(bf16, xc)
    out["bf16"] = {"latent_err_over_scale": sound["latent"], "decode_latent_err_over_scale": sound["decode_latent"],
                   "codes_differ": sound["codes_differ"], "tol": MIMI_BF16_TOL, "dtypes": sound["dtypes"],
                   "planted_faults": faults,
                   "train_loss": {"bfloat16": loss16, "float32": loss32},
                   "train_loss_rel_err": abs(loss16 - loss32) / abs(loss32),
                   "train_grad_err_over_scale": rel_err(grad16, grad32),
                   "train_grad_cosine": float(F.cosine_similarity(grad16, grad32, dim=0)),
                   "train_loss_tol": MIMI_LOSS_TOL, "train_grad_tol": MIMI_GRAD_TOL}
    out["launches"] = {k: v - before[k] for k, v in read_counts().items()}
    emit(out)
    if not out["latent_err_over_scale"] <= MIMI_LATENT_TOL:
        raise AssertionError(f"the codec's latents on the card differ from the CPU's: {out}")
    if not codes_row["worst_rel_distance_gap"] <= MIMI_CODE_TIE:
        raise AssertionError(f"a code differs card vs CPU away from a near tie: {codes_row}")
    if not (out["decode_codes_err_over_scale"] <= MIMI_DECODE_TOL
            and (not rows or out["decode_latent_err_over_scale"] <= MIMI_DECODE_TOL)):
        raise AssertionError(f"the codec's decode on the card differs from the CPU's: {out}")
    b = out["bf16"]
    if caught(sound) or sound["dtypes"] != ["torch.float32"] * 2:
        raise AssertionError(f"the bf16 codec is off its float32: {b}")
    missed = [name for name, f in faults.items() if f["must_catch"] and not f["caught"]]
    if missed:
        raise AssertionError(f"the bf16 check misses planted faults {missed}: {faults}")
    if not (b["train_loss_rel_err"] <= MIMI_LOSS_TOL and b["train_grad_err_over_scale"] <= MIMI_GRAD_TOL):
        raise AssertionError(f"the bf16 train step is off its float32: {b}")
    if any(out["launches"].values()):
        raise AssertionError(f"hand-written kernels launched on the Mimi path: {out['launches']}")
    return out


def phase_mimi_train() -> dict:
    """bench.py's mimi regime on the port: the full-width codec in bf16
    (seed 0), ``RegressiveMimiTask`` with bench's Adam (lr 1e-4), one
    device batch of 32 x 2 s (bench's: noise x 0.1 airborne, half of it
    body-conducted), MIMI_WARMUP then MIMI_STEPS steps, each synchronised:
    step ms (median, p10-p90), audio-s/s, peak memory, FLOPs (a frozen
    forward, a trainable forward and its backward, 4x ``encode_to_latent``)
    over the bf16 peak, the K1-K4 launches (none); the loss on this fixed
    batch falls and the decoder side, the quantizer and the frozen copy are
    bit-equal after the steps; then a trace of MIMI_PROFILE_STEPS steps."""
    torch.manual_seed(0)
    task = RegressiveMimiTask(mimi=Mimi(seed=0, compute_dtype="bfloat16", device="cuda"), optimizer=adam(1e-4))
    rng = np.random.default_rng(0)
    ref = torch.from_numpy(rng.standard_normal((MIMI_B, MIMI_T, 1)).astype(np.float32) * 0.1).cuda()
    batch = {"audio_body_conducted": ref * 0.5, "audio_airborne": ref}
    state = task.init_state(0)
    frozen_parts = {k: v.clone() for k, v in task.mimi.state_dict().items() if k.split(".")[0] not in ENCODER_SIDE}
    frozen_copy = {k: v.clone() for k, v in state.frozen.state_dict().items()}
    logged = []

    def step():
        logged.append(task.train_step(state, batch)[1]["train/l1_latent_loss"])

    flops = mimi_flops(task.mimi.config, MIMI_B, MIMI_T)
    step_flops = 4 * flops["encode_to_latent"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms = timed_calls(step, MIMI_WARMUP + MIMI_STEPS)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in logged]
    after = task.mimi.state_dict()
    unchanged = all(torch.equal(after[k], v) for k, v in frozen_parts.items()) and all(
        torch.equal(state.frozen.state_dict()[k], v) for k, v in frozen_copy.items())
    out = {"phase": "mimi_train", "B": MIMI_B, "T": MIMI_T, "compute_dtype": "bfloat16",
           "warmup_steps": MIMI_WARMUP, "steps": MIMI_STEPS, "launches": counts,
           **spread(ms, MIMI_WARMUP, MIMI_B * MIMI_T / 24000, step_flops),
           "flops_per_audio_second": step_flops / (MIMI_B * MIMI_T / 24000),
           "encode_flops_per_audio_second": flops["encode_to_latent"] / (MIMI_B * MIMI_T / 24000),
           "max_memory_allocated_gib": peak, "first_loss": losses[0], "last_loss": losses[-1],
           "losses": losses, "frozen_parts_bit_equal": unchanged,
           "trainable_params": sum(p.numel() for p in state.optimizer.param_groups[0]["params"])}
    out["profile"] = profile = device_profile(step, MIMI_PROFILE_STEPS, "the Mimi train steps")
    profile["flops_share_of_bf16_peak_untraced"] = step_flops / (profile["wall_us_untraced"] / 1e6) / PEAK_FLOPS[
        torch.bfloat16]
    emit(out)
    if any(counts.values()):
        raise AssertionError(f"hand-written kernels launched on the Mimi train path: {counts}")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0] and unchanged):
        raise AssertionError(f"the Mimi train steps: losses {losses}, frozen parts unchanged {unchanged}")
    return out


def phase_codec() -> dict:
    """bench.py's codec regime on the port: the full-width codec in bf16
    (seed 0), ``encode_to_latent`` then ``decode_latent`` of 32 x 2 s of
    noise x 0.1 under ``no_grad``, MIMI_WARMUP then MIMI_STEPS round trips,
    each synchronised, with the figures of ``phase_mimi_train`` (FLOPs: one
    encode and one decode, over the padded MIMI_T; audio-s/s from
    MIMI_AUDIO_S a row, as bench.py's codec regime counts it)."""
    model = Mimi(seed=0, compute_dtype="bfloat16", device="cuda").eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((MIMI_B, MIMI_T, 1)).astype(np.float32) * 0.1).cuda()
    result = {}

    @torch.no_grad()
    def round_trip():
        result["y"] = model.decode_latent(model.encode_to_latent(x))

    flops = mimi_flops(model.config, MIMI_B, MIMI_T)
    total = flops["encode_to_latent"] + flops["decode_latent"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms = timed_calls(round_trip, MIMI_WARMUP + MIMI_STEPS)
    counts = read_counts()
    y = result["y"]
    out = {"phase": "codec", "B": MIMI_B, "T": MIMI_T, "compute_dtype": "bfloat16",
           "warmup_calls": MIMI_WARMUP, "calls": MIMI_STEPS, "launches": counts,
           **spread(ms, MIMI_WARMUP, MIMI_B * MIMI_AUDIO_S, total), "flops_by_half": flops,
           "flops_per_audio_second": total / (MIMI_B * MIMI_T / 24000),
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "output_shape": list(y.shape), "output_finite": bool(torch.isfinite(y).all()),
           "output_dtype": str(y.dtype)}
    out["profile"] = profile = device_profile(round_trip, MIMI_PROFILE_STEPS, "the codec round trips")
    profile["flops_share_of_bf16_peak_untraced"] = total / (profile["wall_us_untraced"] / 1e6) / PEAK_FLOPS[
        torch.bfloat16]
    emit(out)
    if any(counts.values()):
        raise AssertionError(f"hand-written kernels launched on the codec path: {counts}")
    if not (out["output_finite"] and y.shape == x.shape and y.dtype == torch.float32):
        raise AssertionError(f"the codec's output: {out['output_shape']}, finite {out['output_finite']}")
    return out


def phase_cli_mimi() -> dict:
    """``run.main`` with MIMI_CLI_ARGS: the published ``bwe`` data module at
    24 kHz (``sample_rate=24000``, which also sets the ``light``
    augmentation's rate) at batch 16 on 32 synthetic utterances, and
    ``regressive_mimi.yaml`` (the full-width codec in bf16, seed 0): fit two
    epochs of two steps validating two batch-1 batches an epoch, checkpoints
    by validation STOI, then test("last") on four batches; then again with
    max_epochs 3, which resumes at epoch 2.  The fit is timed; each test
    batch is split into the eval step (synchronised) and the host SE
    metrics; the K1-K4 counts are read around each run (all 0)."""
    from vibravox_tpu_torch import run

    timing = {"eval_step": [], "metrics": []}
    marks: dict = {}
    eval_step, eval_metrics, test = RegressiveMimiTask.eval_step, RegressiveMimiTask.eval_metrics, Trainer.test

    def timed_eval_step(self, state, batch):
        t0 = time.perf_counter()
        out = eval_step(self, state, batch)
        torch.cuda.synchronize()
        timing["eval_step"].append(time.perf_counter() - t0)
        return out

    def timed_metrics(self, outputs):
        t0 = time.perf_counter()
        out = eval_metrics(self, outputs)
        timing["metrics"].append(time.perf_counter() - t0)
        return out

    def marked_test(self, *args, **kwargs):
        torch.cuda.synchronize()
        marks["fit_end"] = time.perf_counter()
        for v in timing.values():
            v.clear()
        return test(self, *args, **kwargs)

    def run_cli(run_dir, epochs):
        reset_counts()
        t0 = time.perf_counter()
        metrics = run.main([*MIMI_CLI_ARGS, f"++trainer.max_epochs={epochs}", f"++run_dir={run_dir}"])
        torch.cuda.synchronize()
        end = time.perf_counter()
        progress = json.loads((Path(run_dir) / "checkpoints" / "trainer_state.json").read_text())
        return {"epochs": epochs, "fit_wall_s": marks["fit_end"] - t0, "test_wall_s": end - marks["fit_end"],
                "test_s_per_batch": (end - marks["fit_end"]) / MIMI_CLI_TEST_BATCHES,
                "eval_step_ms": [1e3 * s for s in timing["eval_step"]],
                "se_metrics_ms": [1e3 * s for s in timing["metrics"]],
                "launches": read_counts(), "trainer_state": progress, "metrics": metrics,
                "last": (Path(run_dir) / "checkpoints" / "last" / "state.pt").exists()}

    RegressiveMimiTask.eval_step, RegressiveMimiTask.eval_metrics, Trainer.test = (
        timed_eval_step, timed_metrics, marked_test)
    try:
        with tempfile.TemporaryDirectory(prefix="vibravox_mimi_cli_") as run_dir:
            first = run_cli(run_dir, 2)
            resumed = run_cli(run_dir, 3)
    finally:
        RegressiveMimiTask.eval_step, RegressiveMimiTask.eval_metrics, Trainer.test = eval_step, eval_metrics, test
    out = {"phase": "cli_mimi", "B": 16, "steps_per_epoch": 2, "val_batches": 2,
           "test_batches": MIMI_CLI_TEST_BATCHES, "first": first, "resumed": resumed}
    emit(out)
    keys = {"test/l1_latent_loss", "test/torchmetrics_si_sdr", "test/torchmetrics_stoi"}
    for r, progress in ((first, {"epoch": 1, "global_step": 4}), (resumed, {"epoch": 2, "global_step": 6})):
        m = r["metrics"]
        if set(m) != keys or not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"the Mimi CLI's test metrics {m}")
        if r["trainer_state"] != progress or not r["last"]:
            raise AssertionError(f"the Mimi CLI's progress {r['trainer_state']}, last {r['last']}")
        if any(r["launches"].values()):
            raise AssertionError(f"hand-written kernels launched on the Mimi CLI: {r['launches']}")
        if len(r["eval_step_ms"]) != MIMI_CLI_TEST_BATCHES:
            raise AssertionError(f"timed test batches {r['eval_step_ms']}")
    return out


# ---------------------------------------------------------------------------
# slice 7: the SQUIM metrics and pretrained EBEN (no new hand-written kernel)
# ---------------------------------------------------------------------------

SQUIM_T = 40000  # 2.5 s at 16 kHz: 1249 encoder frames, 38 chunks of 71
SQUIM_B = 4
SQUIM_BATCH_B = 32  # the objective alone at bench's batch
SQUIM_TOL = 1e-4
SQUIM_WARMUP, SQUIM_CALLS, SQUIM_PROFILE_CALLS = 3, 20, 5
HUB_UTTERANCES = 8


def randomise_squim(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """GroupNorm and LayerNorm scales and biases, PReLU slopes and
    AutoPool's alpha drawn from ``seed`` (their initialisers make each an
    identity or a constant), so the comparisons exercise them."""
    from vibravox_tpu_torch.models.squim import AutoPool

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
                module.weight.copy_(torch.rand(module.weight.shape, generator=gen) + 0.5)
                module.bias.copy_(torch.randn(module.bias.shape, generator=gen) * 0.1)
            elif isinstance(module, torch.nn.PReLU):
                module.weight.copy_(torch.rand(module.weight.shape, generator=gen) * 0.5)
            elif isinstance(module, AutoPool):
                module.alpha.copy_(torch.rand(1, generator=gen) + 0.5)
    return model


def squim_objective_flops(config, batch: int, samples: int) -> dict:
    """Forward FLOPs of the objective (2 per multiply-add), counted from the
    config and the input's shape: the encoder, the bi-LSTMs' gate GEMMs (4
    per block: row and column, each both directions), their projections,
    the 1x1 conv, the three transformer branches and their heads."""
    n, h, d, k = config.feat_dim, config.hidden_dim, config.d_model, config.chunk_size
    t = (samples - config.win_len) // (config.win_len // 2) + 1
    stride = k // 2
    gap = (k - (stride + t % k) % k) % k
    chunks = 2 * (t + stride + gap) // k
    positions = batch * chunks * k
    tokens = batch * t
    branch = (2 * tokens * d * 4 * d  # q/k/v and out projections
              + 2 * 2 * t * t * d * batch  # QK^T and PV
              + 2 * 2 * tokens * d * 4 * d  # the feed-forward
              + 2 * batch * (d * d + d))  # the head's MLP
    out = {"frames": t, "chunks": chunks, "encoder": 2.0 * n * config.win_len * tokens,
           "lstm": 2.0 * config.num_blocks * 2 * 2 * positions * 4 * h * (n + h),
           "lstm_projections": 2.0 * config.num_blocks * 2 * positions * 2 * h * n,
           "conv_1x1": 2.0 * positions * n * d, "transformer_branches": 3.0 * branch}
    out["total"] = sum(v for key, v in out.items() if key not in ("frames", "chunks"))
    out["lstm_share"] = out["lstm"] / out["total"]
    return out


def squim_subjective_flops(config, batch: int, samples: int) -> float:
    """Forward FLOPs of the subjective: the backbone on the estimate and on
    the reference, then the projector, attention pooling and MOS head."""
    conv, rest = wav2vec2_flops(config.ssl, 2 * batch, samples)
    rest -= 2 * config.ssl.hidden_size * config.ssl.vocab_size * 2 * batch * config.ssl.feat_extract_output_length(samples)
    tokens = batch * config.ssl.feat_extract_output_length(samples)
    head = 2 * tokens * (2 * config.ssl.hidden_size * config.proj_dim + config.proj_dim * (1 + config.att_dim))
    return conv + rest + head + 2 * batch * config.att_dim


def phase_squim_parity(squim_dir: str) -> dict:
    """The SQUIM networks at full width (``squim_objective_base()`` and
    ``squim_subjective_base()``, seed 0, norms, PReLU slopes and alpha
    randomised), written to ``squim_dir`` as torchaudio-schema state dicts
    and loaded on the card by ``load_squim_predictors`` (the SE eval's
    route), on 4 x 2.5 s of the synthetic source's speech at 16 kHz (the
    MOS against four other utterances): card against CPU in IEEE float32
    (``strict_float32``, cuDNN's RNNs included), every score within
    SQUIM_TOL of its scale.  The objective is read again with the LSTMs
    left in TF32, reported and not held: what the RNN setting is worth.  No
    hand-written kernel lies on this path."""
    from vibravox_tpu_torch.metrics.squim import load_squim_predictors
    from vibravox_tpu_torch.models import squim as squim_module
    from vibravox_tpu_torch.models.squim import squim_objective_base, squim_subjective_base

    objective = randomise_squim(squim_objective_base(seed=0, device="cpu"), 10)
    subjective = randomise_squim(squim_subjective_base(seed=0, device="cpu"), 11)
    torch.save(objective.state_dict(), Path(squim_dir) / "squim_objective.pt")
    torch.save(subjective.torchaudio_state_dict(), Path(squim_dir) / "squim_subjective.pt")
    reset_counts()
    (_, obj_card), (subj_fn, subj_card) = load_squim_predictors(squim_dir)
    audio = mimi_speech(2 * SQUIM_B, SQUIM_T, 16000)[:, :, 0]
    estimate, reference = audio[:SQUIM_B], audio[SQUIM_B:]

    def timed(fn):
        with torch.no_grad():
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    want_obj, cpu_obj_s = timed(lambda: objective(estimate))
    want_mos, cpu_mos_s = timed(lambda: subjective(estimate, reference))
    got_obj, card_obj_s = timed(lambda: obj_card(estimate.cuda()))
    got_mos, card_mos_s = timed(lambda: subj_fn(subj_card, estimate.cuda(), reference.cuda()))

    def err(got, want):
        diff = (got.cpu() - want).abs().max().item()
        scale = want.abs().max().item()
        return {"max_abs_err": diff, "scale": scale, "err_over_scale": diff / scale}

    @contextlib.contextmanager
    def rnn_in_tf32():  # strict_float32 as it was before the RNN setting joined it
        with strict_float32():
            torch.backends.cudnn.rnn.fp32_precision = "tf32"
            yield

    with mock.patch.object(squim_module, "strict_float32", rnn_in_tf32):
        tf32, _ = timed(lambda: obj_card(estimate.cuda()))
    names = ("stoi", "pesq", "sisdr")
    scores = {name: err(g, w) for name, g, w in zip(names, got_obj, want_obj)}
    mos = err(got_mos, want_mos)
    out = {"phase": "squim_parity", "B": SQUIM_B, "T": SQUIM_T, "objective_params": sum(
        p.numel() for p in objective.parameters()), "subjective_params": sum(p.numel() for p in subjective.parameters()),
        "objective": scores, "mos": mos, "tol": SQUIM_TOL,
        "objective_with_rnn_in_tf32": {n: err(g, w) for n, g, w in zip(names, tf32, want_obj)},
        "scores_gpu": {n: g.tolist() for n, g in zip(names, got_obj)}, "mos_gpu": got_mos.tolist(),
        "cpu_seconds": {"objective": cpu_obj_s, "subjective": cpu_mos_s},
        "card_first_call_seconds": {"objective": card_obj_s, "subjective": card_mos_s},
        "launches": read_counts()}
    emit(out)
    for name, e in {**scores, "mos": mos}.items():
        if not (math.isfinite(e["err_over_scale"]) and e["err_over_scale"] <= SQUIM_TOL):
            raise AssertionError(f"SQUIM {name} on the card differs from the CPU's: {e}")
    if not (bool(((got_obj[0] >= 0) & (got_obj[0] <= 1)).all()) and bool(torch.isfinite(got_mos).all())):
        raise AssertionError(f"SQUIM scores out of range: {out['scores_gpu']}, MOS {out['mos_gpu']}")
    if any(out["launches"].values()):
        raise AssertionError(f"hand-written kernels launched on the SQUIM path: {out['launches']}")
    return out


def phase_squim_eval(squim_dir: str) -> dict:
    """The SE eval with SQUIM on the card: ``SEMetrics`` with the weights of
    ``squim_dir`` on the first batch of the CLI's test loader (batch 1, the
    eval collate's 2.5 s crop cut to the generator's valid length; its
    body-conducted signal as the estimate, the airborne one as the
    reference), 3 warm-up and 20 synchronised calls, split into the
    objective, the subjective and the rest (resampling, SI-SDR, STOI on the
    host); then the objective alone on 32 x 2.5 s.  Each with FLOPs counted
    from the shapes and a ``device_profile`` (device time by kind, idle
    share, kernels a call), taken without the split's synchronisations."""
    from vibravox_tpu_torch.models.squim import SquimObjectiveConfig, SquimSubjectiveConfig
    from vibravox_tpu_torch.tasks.se_metrics import SEMetrics

    batch = cli_test_batch()
    t = batch["audio_body_conducted"].shape[1]
    t -= (t + 32) % 256  # EBENGenerator.valid_length at n = 32, m = 4: what the eval step hands on
    outputs = {"enhanced": batch["audio_body_conducted"][:, :t].cuda(),
               "reference": batch["audio_airborne"][:, :t].cuda()}
    se = SEMetrics(16000, squim_dir=squim_dir)
    predictors = {"objective": se.squim_stoi.predictor, "subjective": se.noresqa_mos.predictor}
    parts = {k: [] for k in predictors}

    def timed_part(key):
        fn, model = predictors[key]

        def wrapper(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            parts[key].append(1e3 * (time.perf_counter() - t0))
            return out
        return wrapper, model

    se.squim_stoi.predictor, se.noresqa_mos.predictor = timed_part("objective"), timed_part("subjective")
    reset_counts()
    metrics = {}
    calls = timed_calls(lambda: metrics.update(se(outputs)), SQUIM_WARMUP + SQUIM_CALLS)
    se.squim_stoi.predictor, se.noresqa_mos.predictor = predictors["objective"], predictors["subjective"]
    ms = {"total": np.array(calls), **{k: np.array(v) for k, v in parts.items()}}
    ms["rest"] = ms["total"] - ms["objective"] - ms["subjective"]
    obj_cfg = SquimObjectiveConfig()
    flops = {"objective": squim_objective_flops(obj_cfg, 1, t),
             "subjective": squim_subjective_flops(SquimSubjectiveConfig(), 1, t)}

    def summary(v):
        later = v[SQUIM_WARMUP:]
        return {"first": float(v[0]), "median": float(np.median(later)), "p10": float(np.percentile(later, 10)),
                "p90": float(np.percentile(later, 90))}

    cli_batch = {"B": 1, "T": t, "ms": {k: summary(v) for k, v in ms.items()}, "metrics": metrics,
                 "flops": flops, "flops_share_of_f32_peak_median": {
                     "objective": flops["objective"]["total"] / (np.median(ms["objective"][SQUIM_WARMUP:]) / 1e3)
                     / PEAK_FLOPS[torch.float32],
                     "subjective": flops["subjective"] / (np.median(ms["subjective"][SQUIM_WARMUP:]) / 1e3)
                     / PEAK_FLOPS[torch.float32]},
                 "calls_timed": {k: len(v) for k, v in parts.items()},
                 "profile": device_profile(lambda: se(outputs), SQUIM_PROFILE_CALLS, "the SE metrics with SQUIM")}

    apply_fn, model = predictors["objective"]
    x = mimi_speech(SQUIM_BATCH_B, SQUIM_T, 16000)[:, :, 0].cuda()
    b32_flops = squim_objective_flops(obj_cfg, SQUIM_BATCH_B, SQUIM_T)
    torch.cuda.reset_peak_memory_stats()
    b32_ms = timed_calls(lambda: apply_fn(model, x), SQUIM_WARMUP + SQUIM_CALLS)
    b32 = {"B": SQUIM_BATCH_B, "T": SQUIM_T,
           **spread(b32_ms, SQUIM_WARMUP, SQUIM_BATCH_B * SQUIM_T / 16000, b32_flops["total"], torch.float32),
           "flops_detail": b32_flops, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "profile": device_profile(lambda: apply_fn(model, x), SQUIM_PROFILE_CALLS, "the SQUIM objective at b32")}
    launches = read_counts()
    out = {"phase": "squim_eval", "cli_batch": cli_batch, "objective_b32": b32, "launches": launches}
    emit(out)
    if set(metrics) != {"torchmetrics_si_sdr", "torchmetrics_stoi", "torchsquim_stoi", "noresqa_mos"}:
        raise AssertionError(f"the SE metrics with SQUIM logged {sorted(metrics)}")
    if cli_batch["calls_timed"] != {"objective": SQUIM_WARMUP + SQUIM_CALLS, "subjective": SQUIM_WARMUP + SQUIM_CALLS}:
        raise AssertionError(f"timed SQUIM calls {cli_batch['calls_timed']}")
    if any(launches.values()):
        raise AssertionError(f"hand-written kernels launched by the SE metrics or the objective: {launches}")
    return out


def phase_hub_enhance() -> dict:
    """Pretrained EBEN through the hub layout: the full-width generator
    (m=4, n=32, p=2, seed 0) saved by ``save_eben_generator`` (the port's
    safetensors writer), loaded on the card by
    ``eben_generator_from_pretrained``, its forward bit-equal to the saved
    one's; then ``scripts/eben_enhanced_vibravox.py`` on the card over 8
    synthetic test utterances: each npz within 1e-5 of scale of the source
    generator's direct forward, K1 six launches an utterance (counts reset
    just before the script), seconds an utterance."""
    from vibravox_tpu_torch.data.bwe import resolve_source
    from vibravox_tpu_torch.models.hub import eben_generator_from_pretrained, save_eben_generator
    from vibravox_tpu_torch.scripts.eben_enhanced_vibravox import main as enhance

    torch.manual_seed(0)
    source = EBENGenerator(device="cuda").eval()
    with tempfile.TemporaryDirectory(prefix="vibravox_hub_") as tmp:
        save_eben_generator(source, Path(tmp) / "weights")
        loaded = eben_generator_from_pretrained(Path(tmp) / "weights")
        audio = mimi_speech(1, source.valid_length(SQUIM_T), 16000).cuda()
        with torch.inference_mode():
            bit_equal = torch.equal(loaded(audio)[0], source(audio)[0])
        reset_counts()
        t0 = time.perf_counter()
        enhance(["--dataset", "synthetic", "--sensors", "body_conducted", "--weights", str(Path(tmp) / "weights"),
                 "--out", str(Path(tmp) / "out"), "--limit", str(HUB_UTTERANCES)])
        torch.cuda.synchronize()
        script_s = time.perf_counter() - t0
        launches = read_counts()
        rows = resolve_source("synthetic", "speech_clean", "test", "body_conducted", 16000, False)
        errs, lengths = [], []
        for i in range(HUB_UTTERANCES):
            got = np.load(Path(tmp) / "out" / "body_conducted" / f"{i:06d}.npz")["audio_enhanced"]
            body = torch.from_numpy(rows[i]["audio_body_conducted"])[None, :, None].cuda()
            with torch.inference_mode():
                want = source(source.cut_to_valid_length(body))[0][0, :, 0].cpu().numpy()
            lengths.append(len(want))
            errs.append(float(np.abs(got - want).max() / np.abs(want).max()) if got.shape == want.shape else math.inf)
    out = {"phase": "hub_enhance", "generator_bit_equal": bit_equal, "utterances": HUB_UTTERANCES,
           "samples": lengths, "script_wall_s": script_s, "s_per_utterance": script_s / HUB_UTTERANCES,
           "audio_s": sum(lengths) / 16000, "err_over_scale": errs, "tol": 1e-5, "launches": launches}
    emit(out)
    if not bit_equal:
        raise AssertionError("the generator loaded from the hub layout differs from the one saved")
    if not max(errs) <= 1e-5:
        raise AssertionError(f"the enhancement script's output differs from the direct forward: {errs}")
    if launches != {"K1": 6 * HUB_UTTERANCES, "K2": 0, "K3": 0, "K4": 0, "C1": 0, "C2": 0}:
        raise AssertionError(f"kernel launches {launches} enhancing {HUB_UTTERANCES} utterances")
    return out


def phase_cli_squim(squim_dir: str, cli_dir: str, noisy_dir: str, cli: dict, noisy: dict) -> dict:
    """The CLI's test with SQUIM: ``run.main`` again on phase ``cli``'s
    run_dir (max_epochs 3, its last epoch: no step, then test("last") on
    four batches) and on phase ``cli_noisybwe``'s (max_epochs 2: the four
    ``synthetic`` and four ``real`` test batches), with
    ``VIBRAVOX_SQUIM_DIR`` at ``squim_dir``.  ``torchsquim_stoi`` must be
    logged within [0, 1] and ``noresqa_mos`` finite, on the noisy CLI's
    reference-free batches too; the K1-K4 launches of each test equal those
    of the phase it repeats; the test seconds a batch are split into the
    SQUIM calls and the rest."""
    from vibravox_tpu_torch import run
    from vibravox_tpu_torch.metrics.squim import NoresqaMOS, TorchsquimSTOI

    squim_ms: list = []
    marks: dict = {}
    calls = {"stoi": TorchsquimSTOI.__call__, "mos": NoresqaMOS.__call__, "test": Trainer.test}

    def timed(fn):
        def wrapper(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            squim_ms.append(1e3 * (time.perf_counter() - t0))
            return out
        return wrapper

    def marked_test(self, *args, **kwargs):
        torch.cuda.synchronize()
        marks["test_start"] = time.perf_counter()
        squim_ms.clear()
        return calls["test"](self, *args, **kwargs)

    def test_again(args, run_dir, batches):
        reset_counts()
        t0 = time.perf_counter()
        metrics = run.main([*args, f"++run_dir={run_dir}"])
        torch.cuda.synchronize()
        end = time.perf_counter()
        test_s = end - marks["test_start"]
        return {"metrics": metrics, "launches": read_counts(), "run_wall_s": end - t0, "test_wall_s": test_s,
                "batches": batches, "test_s_per_batch": test_s / batches, "squim_calls": len(squim_ms),
                "squim_ms_per_batch": sum(squim_ms) / batches,
                "rest_ms_per_batch": (1e3 * test_s - sum(squim_ms)) / batches}

    TorchsquimSTOI.__call__, NoresqaMOS.__call__ = timed(calls["stoi"]), timed(calls["mos"])
    Trainer.test = marked_test
    try:
        with mock.patch.dict(os.environ, {"VIBRAVOX_SQUIM_DIR": squim_dir}):
            eben = test_again([*CLI_ARGS, "++trainer.max_epochs=3"], cli_dir, CLI_TEST_BATCHES)
            noisy_run = test_again(NOISY_CLI_ARGS, noisy_dir, 2 * CLI_TEST_BATCHES)
    finally:
        TorchsquimSTOI.__call__, NoresqaMOS.__call__, Trainer.test = calls["stoi"], calls["mos"], calls["test"]
    out = {"phase": "cli_squim", "eben": eben, "noisybwe": noisy_run,
           "note": "the test restores last (its fit restored it too and ran no step); test_wall_s is the test pass"}
    emit(out)
    for name, r, want in (("eben", eben, cli["test"]["launches"]), ("noisybwe", noisy_run, noisy["launches"]["test"])):
        if r["launches"] != want:
            raise AssertionError(f"the {name} CLI's test with SQUIM launched {r['launches']}, its phase {want}")
    m = eben["metrics"]
    if not (0 <= m.get("test/torchsquim_stoi", -1) <= 1 and math.isfinite(m.get("test/noresqa_mos", math.nan))):
        raise AssertionError(f"the EBEN CLI's test metrics with SQUIM {m}")
    m = noisy_run["metrics"]
    for split in ("synthetic", "real"):
        if not (0 <= m.get(f"test/torchsquim_stoi/{split}", -1) <= 1
                and math.isfinite(m.get(f"test/noresqa_mos/{split}", math.nan))):
            raise AssertionError(f"the noisy CLI's test metrics with SQUIM {m}")
    if eben["squim_calls"] != 2 * CLI_TEST_BATCHES or noisy_run["squim_calls"] != 4 * CLI_TEST_BATCHES:
        raise AssertionError(f"SQUIM calls {eben['squim_calls']} and {noisy_run['squim_calls']} in the tests")
    return out


# ---------------------------------------------------------------------------
# the parallel layer: ranks as processes that share the card
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_WARMUP, DP_STEPS, DP_COLLECTIVE_STEPS = 2, 8, 3
OVERHEAD_WARMUP, OVERHEAD_ROUNDS, OVERHEAD_STEPS = 2, 4, 3
FSDP_STP_T = 48000  # 3 s, 149 frames
WORKER_TIMEOUT_S = 420
# cli_dp's cut of CLI_ARGS: 32 utterances (one step an epoch), one validation and one test batch
CLI_DP_CUT = ("++lightning_datamodule.synthetic_size=32", "++trainer.limit_val_batches=1",
              "++trainer.limit_test_batches=1")
GLOO_NOTE = ("two processes share one H100 over gloo, whose collectives stage CUDA tensors through the "
             "host: these times say nothing of NCCL's")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(kind: str, world: int, backend: str, timeout: float = WORKER_TIMEOUT_S) -> list:
    """``world`` ranks of ``python chip_smoke.py --worker kind`` (rank,
    world size, a localhost rendezvous and the backend in the torchrun
    variables), each rank's result in rank order.  A rank that exits
    non-zero, or any rank still running after ``timeout`` seconds, stops
    every rank and fails the phase."""
    with tempfile.TemporaryDirectory(prefix=f"vibravox_{kind}_") as tmp:
        port, procs, logs = free_port(), [], []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), VIBRAVOX_DIST_BACKEND=backend,
                       VIBRAVOX_WORKER_OUT=tmp)
            logs.append(open(Path(tmp) / f"rank{rank}.log", "w"))
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--worker", kind],
                                          env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline, failed = time.monotonic() + timeout, None
        try:
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
                if time.monotonic() > deadline:
                    break
                time.sleep(0.5)
            failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()
        codes = [p.returncode for p in procs]
        if any(codes):
            tails = {r: (Path(tmp) / f"rank{r}.log").read_text()[-3000:] for r in range(world)}
            why = f"rank {failed} failed" if failed is not None else f"a rank ran past {timeout} s"
            raise AssertionError(f"{kind} over {world} {backend} ranks: {why}, exit codes {codes}; logs {tails}")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def worker_main(kind: str) -> int:
    """One rank of a ``run_workers`` phase: joins the process group from
    the torchrun variables, runs ``WORKERS[kind]`` and saves its result."""
    import faulthandler

    from vibravox_tpu_torch.parallel.distributed import initialize_distributed

    faulthandler.enable()  # a crash in native code leaves its Python stack in the rank's log
    initialize_distributed("cuda")
    try:
        out = WORKERS[kind]()
        torch.save(out, Path(os.environ["VIBRAVOX_WORKER_OUT"]) / f"rank{os.environ['RANK']}.pt")
    finally:
        torch.distributed.destroy_process_group()
    return 0


def host(tree):
    """Tensors to the CPU, floats for 0-dim ones."""
    if isinstance(tree, torch.Tensor):
        return float(tree) if tree.dim() == 0 else tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    return tree


def dp_batch(b: int, seed: int) -> dict:
    """A global EBEN batch of ``b`` 2.5 s crops (CPU): noise x 0.1 airborne,
    half of it plus a little noise body-conducted."""
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((b, TRAIN_T, 1)).astype(np.float32) * 0.1
    noise = rng.standard_normal((b, TRAIN_T, 1)).astype(np.float32) * 0.01
    return {"audio_body_conducted": torch.from_numpy(ref * 0.5 + noise), "audio_airborne": torch.from_numpy(ref)}


def my_rows(batch: dict, dp) -> dict:
    """This data rank's rows of a global batch, on the card."""
    n = next(iter(batch.values())).shape[0] // dp.data_size
    return {k: v[dp.data_rank * n:(dp.data_rank + 1) * n].cuda() for k, v in batch.items()}


def free_card() -> None:
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def worker_dp_parity() -> dict:
    """A dp_parity rank: the float32 SGD step on its 16 rows of the global
    batch, then bf16 Adam steps timed (the K1-K4 counts reset just before
    them and read just after), then steps whose gradient all-reduce is
    timed (each synchronised on both sides)."""
    from vibravox_tpu_torch.parallel.mesh import DataParallel, MeshConfig, build_mesh

    torch.manual_seed(0)
    task = make_task("cuda", small=False, optimizer=sgd(1e-2))
    dp = DataParallel(task, build_mesh(MeshConfig(data=DP_RANKS), "cuda"))
    state = dp.init_state(0)
    reset_counts()
    state, logs = dp.train_step(state, my_rows(dp_batch(TRAIN_B, 7), dp))
    torch.cuda.synchronize()
    out = {"rank": dp.data_rank, "mesh": [dp.data_size, dp.model_size], "backend": torch.distributed.get_backend(),
           "parity_logs": host(logs), "parity_launches": read_counts()}
    full = dp.full_state_dict(state)
    if dp.data_rank == 0:
        out["parity_state"] = {k: host(full[k]) for k in ("generator", "discriminator")}
    del task, dp, state, full
    free_card()

    torch.manual_seed(0)
    task = make_task("cuda", small=False, optimizer=adam(3e-4, betas=(0.5, 0.9)), compute_dtype="bfloat16")
    dp = DataParallel(task, build_mesh(MeshConfig(data=DP_RANKS), "cuda"))
    state = dp.init_state(0)
    rows = my_rows(dp_batch(TRAIN_B, 8), dp)
    logged = []

    def step():
        logged.append(host(dp.train_step(state, rows)[1]))

    timed_calls(step, DP_WARMUP)
    torch.cuda.reset_peak_memory_stats()
    dp.allreduce_bytes = 0
    reset_counts()
    ms = timed_calls(step, DP_STEPS)
    counts = read_counts()
    allreduce_bytes = dp.allreduce_bytes
    dp.time_collectives, dp.allreduce_seconds = True, 0.0
    ms_timed = timed_calls(step, DP_COLLECTIVE_STEPS)
    out.update(step_ms=ms, launches=counts, allreduce_bytes_per_step=allreduce_bytes / DP_STEPS,
               allreduce_ms_per_step=1e3 * dp.allreduce_seconds / DP_COLLECTIVE_STEPS,
               steps_with_timed_allreduce_ms=ms_timed,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               losses_finite=all(math.isfinite(v) for lg in logged for v in lg.values()),
               grad_params=sum(p.numel() for p in task.generator.parameters())
               + sum(p.numel() for p in task.discriminator.parameters()))
    return out


def worker_dp_overhead() -> dict:
    """One NCCL rank: the bf16 b32 step of the train phase called plainly
    and through ``DataParallel`` (world size 1), in alternating rounds of
    synchronised steps on the same task and state."""
    from vibravox_tpu_torch.parallel.mesh import DataParallel, MeshConfig, build_mesh

    torch.manual_seed(0)
    task = make_task("cuda", small=False, optimizer=adam(3e-4, betas=(0.5, 0.9)), compute_dtype="bfloat16")
    dp = DataParallel(task, build_mesh(MeshConfig(), "cuda"))
    state = dp.init_state(0)
    batch = {k: v.cuda() for k, v in dp_batch(TRAIN_B, 8).items()}
    plain, wrapped = [], []
    timed_calls(lambda: task.train_step(state, batch), OVERHEAD_WARMUP)
    timed_calls(lambda: dp.train_step(state, batch), OVERHEAD_WARMUP)
    for _ in range(OVERHEAD_ROUNDS):
        plain += timed_calls(lambda: task.train_step(state, batch), OVERHEAD_STEPS)
        wrapped += timed_calls(lambda: dp.train_step(state, batch), OVERHEAD_STEPS)
    return {"backend": torch.distributed.get_backend(), "world": dp.world, "mesh": [dp.data_size, dp.model_size],
            "plain_ms": plain, "data_parallel_ms": wrapped}


def eben_parity(ref: dict, got: dict, before: dict) -> tuple:
    """train_parity's bars between two updates of both networks: the worst
    tensor's distance over its update, the tensors out of 1e-2 of their
    update."""
    worst, bad = 0.0, []
    for net in ("generator", "discriminator"):
        for k, b0 in before[net].items():
            if "pqmf." in k:
                continue
            diff = (got[net][k] - ref[net][k]).norm().item()
            step = (ref[net][k] - b0).norm().item()
            if diff > 1e-2 * step + 1e-7:
                bad.append(f"{net}.{k}")
            if step > 0:
                worst = max(worst, diff / step)
    return worst, bad


def phase_dp_parity(train: dict) -> dict:
    """This slice's main path.  Two processes share the card over gloo and
    run the full-width eben.yaml GAN step through ``DataParallel`` on 16
    rows each of a global batch of 32 x 2.5 s crops.  In float32 with SGD
    the step equals the one-process b32 step on the card at train_parity's
    bars (losses 1e-4 relative, every tensor within 1e-2 of its update).
    Then bf16 Adam steps at two ranks: step ms (median, p10-p90), the
    gradient all-reduce's ms and bytes a step, K1-K4 launches a step on
    each rank (6 / 6 / 6 / 6, the counts reset just before and read just
    after the timed steps in each rank).  Then ``DataParallel`` at world
    size 1 over NCCL against the plain step in the same process: the
    wrapper's own ms, beside the train phase's step."""
    free_card()
    torch.manual_seed(0)
    task = make_task("cuda", small=False, optimizer=sgd(1e-2))
    before = {"generator": host(task.generator.state_dict()), "discriminator": host(task.discriminator.state_dict())}
    state = task.init_state(0)
    _, ref_logs = task.train_step(state, {k: v.cuda() for k, v in dp_batch(TRAIN_B, 7).items()})
    ref = {"generator": host(task.generator.state_dict()), "discriminator": host(task.discriminator.state_dict())}
    ref_logs = host(ref_logs)
    del task, state
    free_card()

    ranks = run_workers("dp_parity", DP_RANKS, "gloo")
    got = ranks[0]
    loss_err = max(abs(got["parity_logs"][k] - v) / max(abs(v), 1e-12) for k, v in ref_logs.items())
    worst, bad = eben_parity(ref, got["parity_state"], before)
    per_step = [{k: v / DP_STEPS for k, v in r["launches"].items()} for r in ranks]
    out = {"phase": "dp_parity", "ranks": DP_RANKS, "backend": got["backend"], "global_batch": TRAIN_B,
           "rows_per_rank": TRAIN_B // DP_RANKS, "T": TRAIN_T, "note": GLOO_NOTE,
           "parity": {"dtype": "float32", "optimizer": "sgd 1e-2", "losses_max_rel_err": loss_err,
                      "losses_tol": 1e-4, "params_max_diff_over_update": worst, "params_tol": 1e-2,
                      "params_out_of_tol": bad, "launches_by_rank": [r["parity_launches"] for r in ranks]},
           "bf16": [{"rank": r["rank"], "step_ms": r["step_ms"], "step_ms_median": float(np.median(r["step_ms"])),
                     "step_ms_p10": float(np.percentile(r["step_ms"], 10)),
                     "step_ms_p90": float(np.percentile(r["step_ms"], 90)),
                     "launches": r["launches"], "launches_per_step": p,
                     "allreduce_ms_per_step": r["allreduce_ms_per_step"],
                     "allreduce_bytes_per_step": r["allreduce_bytes_per_step"],
                     "steps_with_timed_allreduce_ms": r["steps_with_timed_allreduce_ms"],
                     "max_memory_allocated_gib": r["max_memory_allocated_gib"]}
                    for r, p in zip(ranks, per_step)],
           "grad_params": got["grad_params"]}
    one = run_workers("dp_overhead", 1, "nccl")[0]
    plain, wrapped = float(np.median(one["plain_ms"])), float(np.median(one["data_parallel_ms"]))
    out["world_size_1"] = {"backend": one["backend"], "mesh": one["mesh"], "plain_step_ms_median": plain,
                           "data_parallel_step_ms_median": wrapped, "wrapper_ms": wrapped - plain,
                           "plain_ms": one["plain_ms"], "data_parallel_ms": one["data_parallel_ms"],
                           "train_phase_step_ms_median": train["step_ms_median"]}
    emit(out)
    if not loss_err <= 1e-4 or bad:
        raise AssertionError(f"the two-rank step differs from the one-process step: losses {loss_err}, {bad}")
    if not all(r["losses_finite"] for r in ranks):
        raise AssertionError("a loss of the two-rank bf16 steps is not finite")
    if any(r["parity_launches"] != {"K1": 6, "K2": 6, "K3": 6, "K4": 6, "C1": 0, "C2": 0} for r in ranks):
        raise AssertionError(f"kernel launches of the parity step: {[r['parity_launches'] for r in ranks]}")
    if any(p != {"K1": 6, "K2": 6, "K3": 6, "K4": 6, "C1": C1_PER_STEP, "C2": 0} for p in per_step):
        raise AssertionError(f"kernel launches a step on the ranks: {per_step}")
    return out


def stp_fsdp_task():
    torch.manual_seed(0)
    return Wav2Vec2STPTask(wav2vec2_for_ctc=wav2vec2_for_ctc_from_config(seed=0, device="cuda"),
                           optimizer=sgd(1e-2), compute_dtype="bfloat16", device="cuda")


def stp_fsdp_batch() -> dict:
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 35, (STP_B, 24)).astype(np.int64)
    labels[::2, 16:] = -100
    return {"audio": torch.from_numpy(rng.standard_normal((STP_B, FSDP_STP_T)).astype(np.float32) * 0.1),
            "phonemes_ids": torch.from_numpy(labels)}


def mimi_tp_task():
    torch.manual_seed(0)
    return RegressiveMimiTask(mimi=Mimi(seed=0, compute_dtype="bfloat16", device="cuda"), optimizer=sgd(1e-2))


def mimi_tp_batch() -> dict:
    ref = torch.from_numpy(np.random.default_rng(0).standard_normal((MIMI_B, MIMI_T, 1)).astype(np.float32) * 0.1)
    return {"audio_body_conducted": ref * 0.5, "audio_airborne": ref}


def flat(sd: dict, keys) -> torch.Tensor:
    return torch.cat([sd[k].float().flatten() for k in keys])


def worker_fsdp_stp() -> dict:
    """An fsdp_tp rank for STP (data=2): the bf16 SGD step on its 4 rows
    of the global b8, through plain DP and then through FSDP2 (the leaves
    ``fsdp_spec`` picks at its default 2**15 elements): the loss, the full
    parameters after that step (rank 0), the peak memory of that step and
    of three more, the parameter bytes each rank holds and the leaves
    sharded."""
    from vibravox_tpu_torch.parallel.mesh import DataParallel, MeshConfig, build_mesh

    out = {"backend": torch.distributed.get_backend()}
    for fsdp in (False, True):
        free_card()
        task = stp_fsdp_task()
        dp = DataParallel(task, build_mesh(MeshConfig(data=DP_RANKS, fsdp=fsdp), "cuda"), fsdp=fsdp)
        state = dp.init_state(0)
        rows = my_rows(stp_fsdp_batch(), dp)
        names = dict(task.wav2vec2_for_ctc.named_parameters())
        local = dp.local_view(state).state_dict()["model"]
        row = {"rank": dp.data_rank, "mesh": [dp.data_size, dp.model_size], "fsdp": dp.fsdp,
               "param_bytes_held": sum(v.numel() * v.element_size() for k, v in local.items() if k in names),
               "sharded_leaves": sorted(k for k, p in names.items() if type(p).__name__ == "DTensor")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, logs = dp.train_step(state, rows)
        torch.cuda.synchronize()
        row["loss"] = float(logs["train/ctc_loss"])
        full = dp.full_state_dict(state)["model"]
        if dp.data_rank == 0:
            row["model_after_step"] = host(full)
        row["later_steps_ms"] = timed_calls(lambda: dp.train_step(state, rows), 2)
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["fsdp" if fsdp else "plain"] = row
        del task, dp, state, full, local
    return out


def worker_tp_mimi() -> dict:
    """An fsdp_tp rank for Mimi (data=1, model=2): the bf16 SGD step of the
    full-width codec on the whole b32 x 2 s batch, each rank holding half
    of every transformer block: the loss, the full trainable parameters
    after it (rank 0), three more steps' ms and the peak memory."""
    from vibravox_tpu_torch.parallel.mesh import DataParallel, MeshConfig, build_mesh

    task = mimi_tp_task()
    dp = DataParallel(task, build_mesh(MeshConfig(data=1, model=DP_RANKS), "cuda"))
    state = dp.init_state(0)
    batch = {k: v.cuda() for k, v in mimi_tp_batch().items()}
    split = sorted(n for n, m in task.mimi.named_modules() if getattr(m, "tp_attention", None) is not None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, logs = dp.train_step(state, batch)
    torch.cuda.synchronize()
    out = {"backend": torch.distributed.get_backend(), "rank": dp.model_rank, "mesh": [dp.data_size, dp.model_size],
           "loss": float(logs["train/l1_latent_loss"]), "split_layers": split}
    full = dp.full_state_dict(state)["model"]
    if dp.model_rank == 0:
        out["model_after_step"] = {k: v for k, v in host(full).items() if k.split(".")[0] in ENCODER_SIDE}
    out["later_steps_ms"] = timed_calls(lambda: dp.train_step(state, batch), 3)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def one_process_step(task, batch: dict, keys_from) -> tuple:
    """(loss, parameters before, after, peak GiB) of one step in this process."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = keys_from(task)
    before = host(model.state_dict())
    state = task.init_state(0)
    _, logs = task.train_step(state, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    return host(logs), before, host(model.state_dict()), torch.cuda.max_memory_allocated() / 2**30


def update_err(before: dict, ref: dict, got: dict, keys) -> float:
    """The W-rank update against the one-process update (SGD: lr times the
    gradient), over the largest of the latter: the bf16 gradient bar."""
    keys = [k for k in keys if not torch.equal(ref[k], before[k])]
    return rel_err(flat(got, keys) - flat(before, keys), flat(ref, keys) - flat(before, keys))


def phase_fsdp_tp() -> dict:
    """FSDP2 and tensor parallelism on the card.  Two processes share it
    over gloo, whose CUDA collectives carry FSDP2's all-gather and
    reduce-scatter and DTensor's (checked on the H100, PERF.md).  STP: the
    full-width wav2vec2-base bf16 step at b8 (3 s) through plain DP, then
    with ``fsdp: true``; Mimi: the full-width bf16 codec step at b32 x 2 s
    (as mimi_train) on a model axis of two.  Each against the one-process
    step on the card at mimi_parity's bf16 bars (loss 1e-2 relative, the
    update 5e-2 of scale; SGD, so the update is the gradient), with each
    rank's peak memory beside plain DP's (for Mimi the one-process step's)."""
    free_card()
    logs, before, ref, ref_peak = one_process_step(stp_fsdp_task(), stp_fsdp_batch(), lambda t: t.wav2vec2_for_ctc)
    free_card()
    ranks = run_workers("fsdp_stp", DP_RANKS, "gloo")
    stp = {"global_batch": STP_B, "T": FSDP_STP_T, "one_process_loss": logs["train/ctc_loss"],
           "one_process_peak_gib": ref_peak}
    for mode in ("plain", "fsdp"):
        got = ranks[0][mode]
        stp[mode] = {"loss": got["loss"], "loss_rel_err": abs(got["loss"] - logs["train/ctc_loss"])
                     / abs(logs["train/ctc_loss"]),
                     "update_err_over_scale": update_err(before, ref, got["model_after_step"], ref),
                     "ranks": [{k: r[mode][k] for k in ("rank", "mesh", "fsdp", "peak_gib", "param_bytes_held",
                                                        "later_steps_ms")} for r in ranks],
                     "sharded_leaves": len(got["sharded_leaves"]),
                     "sharded_examples": got["sharded_leaves"][:4]}
    del before, ref
    free_card()
    mlogs, mbefore, mref, mref_peak = one_process_step(mimi_tp_task(), mimi_tp_batch(), lambda t: t.mimi)
    trained = [k for k in mref if k.split(".")[0] in ENCODER_SIDE]
    free_card()
    mranks = run_workers("tp_mimi", DP_RANKS, "gloo")
    m0 = mranks[0]
    mimi = {"global_batch": MIMI_B, "T": MIMI_T, "one_process_loss": mlogs["train/l1_latent_loss"],
            "one_process_peak_gib": mref_peak, "loss": m0["loss"],
            "loss_rel_err": abs(m0["loss"] - mlogs["train/l1_latent_loss"]) / abs(mlogs["train/l1_latent_loss"]),
            "update_err_over_scale": update_err(mbefore, mref, m0["model_after_step"], trained),
            "split_layers": m0["split_layers"],
            "ranks": [{k: r[k] for k in ("rank", "mesh", "peak_gib", "later_steps_ms")} for r in mranks]}
    out = {"phase": "fsdp_tp", "ranks": DP_RANKS, "backend": ranks[0]["backend"], "degenerate_mesh": False,
           "note": GLOO_NOTE, "loss_tol": MIMI_LOSS_TOL, "update_tol": MIMI_GRAD_TOL, "stp": stp, "mimi": mimi}
    emit(out)
    for name, row in (("STP plain DP", stp["plain"]), ("STP FSDP", stp["fsdp"]), ("Mimi TP", mimi)):
        if not (row["loss_rel_err"] <= MIMI_LOSS_TOL and row["update_err_over_scale"] <= MIMI_GRAD_TOL):
            raise AssertionError(f"{name} over two ranks differs from the one-process step: {row}")
    if not (stp["fsdp"]["sharded_leaves"] > 0 and stp["plain"]["sharded_leaves"] == 0):
        raise AssertionError(f"FSDP2 sharded {stp['fsdp']['sharded_leaves']} leaves")
    if not mimi["split_layers"]:
        raise AssertionError("no Mimi transformer layer was split over the model axis")
    return out


def phase_cli_dp(run_dir: str) -> dict:
    """The path of a multi-GPU user: ``python -m torch.distributed.run
    --standalone --nproc_per_node 1 -m vibravox_tpu_torch.run`` with
    CLI_ARGS and ``logging=csv`` (the EBEN CLI, the default ``trainer.mesh``
    of every process, over NCCL) cut to one step an epoch and one
    validation and test batch (CLI_DP_CUT): fit two epochs and
    test("last"), then a resumed third epoch and its test.  Each run's
    wall; the progress, the checkpoints and the CSV's finite test metrics
    are checked."""
    args = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
            "-m", "vibravox_tpu_torch.run", *CLI_ARGS, "logging=csv", *CLI_DP_CUT, f"++run_dir={run_dir}"]
    runs = []
    for epochs in (2, 3):
        t0 = time.perf_counter()
        done = subprocess.run(args + [f"++trainer.max_epochs={epochs}"], capture_output=True, text=True,
                              timeout=WORKER_TIMEOUT_S, cwd=str(Path(__file__).resolve().parent))
        wall = time.perf_counter() - t0
        if done.returncode != 0:
            raise AssertionError(f"torchrun exited {done.returncode}: {done.stderr[-4000:]}")
        ckpt = Path(run_dir) / "checkpoints"
        with open(Path(run_dir) / "csv" / "metrics.csv") as f:
            rows = [r for r in csv.DictReader(f) if r.get("test/torchmetrics_stoi")]
        runs.append({"epochs": epochs, "wall_s": wall,
                     "trainer_state": json.loads((ckpt / "trainer_state.json").read_text()),
                     "last": (ckpt / "last" / "state.pt").exists(),
                     "test_metrics": {k: float(v) for k, v in rows[-1].items() if k.startswith("test/") and v}})
    out = {"phase": "cli_dp", "nproc_per_node": 1, "backend": "nccl", "runs": runs}
    emit(out)
    if [r["trainer_state"] for r in runs] != [{"epoch": 1, "global_step": 2}, {"epoch": 2, "global_step": 3}]:
        raise AssertionError(f"progress {[r['trainer_state'] for r in runs]}: the run did not resume at epoch 2")
    for r in runs:
        m = r["test_metrics"]
        if not (r["last"] and all(math.isfinite(v) for v in m.values()) and 0 < m["test/torchmetrics_stoi"] <= 1):
            raise AssertionError(f"the torchrun CLI's test: {r}")
    return out


WEIGHTS_DAY_TRIALS = 8  # the executed spkv_ecapa2_eval's limit_test_batches, one trial a batch
WEIGHTS_DAY_ARTIFACTS = {"eben_temple_vibration_pickup", "phonemizer_throat_microphone", "ecapa2", "squim", "mimi"}


def phase_weights_day(smi: str) -> dict:
    """The port's weights-day runbook as a user runs it on the card:
    ``python -m vibravox_tpu_torch.scripts.weights_day --stage all
    --offline-dry-run`` (``main``), full-width donors in the published
    formats, in a temporary ``--cache-dir``.  Each stage (fetch: the donors;
    convert; parity) is timed, with the K1-K4 launches it made (counts reset
    just before it, read just after): convert runs the EBEN forward (K1 six
    times) and the ECAPA2 embedding (K3 once), parity the executed
    ``spkv_ecapa2_eval`` (K3 twice a trial).  Fails unless every artifact is
    staged, the executed row's EER and minDCF are numbers, those launches
    happened, and ``VIBRAVOX_ECAPA2_CKPT`` / ``VIBRAVOX_SQUIM_DIR`` are as
    they were."""
    from vibravox_tpu_torch.scripts import weights_day

    stages: dict = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            reset_counts()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages[name] = {"wall_s": time.perf_counter() - t0, "launches": read_counts()}
            return result
        return wrapper

    env = {k: os.environ.get(k) for k in weights_day.STAGED_ENV}
    with tempfile.TemporaryDirectory(prefix="vibravox_weights_day_") as tmp, \
            mock.patch.object(weights_day, "stage_make_offline_donors",
                              timed("fetch", weights_day.stage_make_offline_donors)), \
            mock.patch.object(weights_day, "stage_convert", timed("convert", weights_day.stage_convert)), \
            mock.patch.object(weights_day, "stage_parity", timed("parity", weights_day.stage_parity)):
        t0 = time.perf_counter()
        weights_day.main(["--stage", "all", "--offline-dry-run", "--cache-dir", str(Path(tmp) / "cache"),
                          "--output", str(Path(tmp) / "REAL_DATA.md")])
        wall = time.perf_counter() - t0
        manifest = json.loads((Path(tmp) / "cache/staged/manifest.json").read_text())
        raw_bytes = sum(f.stat().st_size for f in (Path(tmp) / "cache/raw").rglob("*") if f.is_file())
        rows = {line.split("|")[1].strip(): json.loads(line.split("|")[2].strip())
                for line in (Path(tmp) / "REAL_DATA.md").read_text().splitlines()
                if line.startswith("| ") and not line.startswith("| config")}
    executed = rows.get("spkv_ecapa2_eval", {}).get("dry_run_executed", {})
    launches = {k: sum(st["launches"][k] for st in stages.values()) for k in ("K1", "K2", "K3", "K4", "C1", "C2")}
    env_after = {k: os.environ.get(k) for k in weights_day.STAGED_ENV}
    out = {"phase": "weights_day", "card": smi, "wall_s": wall, "stages": stages, "launches": launches,
           "manifest_keys": sorted(manifest), "raw_bytes": raw_bytes, "executed": executed, "rows": rows,
           "env_restored": env_after == env}
    emit(out)
    if set(manifest) != WEIGHTS_DAY_ARTIFACTS:
        raise AssertionError(f"the runbook staged {sorted(manifest)}, not {sorted(WEIGHTS_DAY_ARTIFACTS)}")
    if set(executed) != {"test/equal_error_rate", "test/minimum_dcf"} or not all(
            isinstance(v, (int, float)) and math.isfinite(v) for v in executed.values()):
        raise AssertionError(f"the executed spkv_ecapa2_eval row: {rows.get('spkv_ecapa2_eval')}")
    if len(rows) != 5 or any(rows[n] != {"dry_run": "compose+instantiate ok"} for n in rows if n != "spkv_ecapa2_eval"):
        raise AssertionError(f"the parity rows: {rows}")
    want = {"fetch": {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "C1": 0, "C2": 0},
            "convert": {"K1": 6, "K2": 0, "K3": 1, "K4": 0, "C1": 0, "C2": 0},
            "parity": {"K1": 0, "K2": 0, "K3": 2 * WEIGHTS_DAY_TRIALS, "K4": 0, "C1": 0, "C2": 0}}
    if {k: st["launches"] for k, st in stages.items()} != want:
        raise AssertionError(f"the runbook's launches by stage {stages} (want {want})")
    if env_after != env:
        raise AssertionError(f"the runbook left {env_after} in the environment (before: {env})")
    return out


WORKERS = {"dp_parity": worker_dp_parity, "dp_overhead": worker_dp_overhead, "fsdp_stp": worker_fsdp_stp,
           "tp_mimi": worker_tp_mimi}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--worker"]:  # one rank of a parallel phase (run_workers)
        return worker_main(sys.argv[2])

    # The phases take several CUDA-only torch.profiler traces in one process,
    # and a trace can miss the kernels launched at its start (cuda_trace
    # retries).  By default Kineto also tears CUPTI down after each trace and
    # re-initialises it lazily in the next, which made such losses more
    # frequent on an H100 with torch 2.11 (scripts/torch_trace_check.py).
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    k1_rows = phase_k1_parity()
    phase_generator_parity()
    serve_launches = phase_serve(None) + phase_serve("bfloat16")
    phase_profile()
    k2_rows = phase_k2_parity()
    dft_rows = phase_k3_k4_parity()
    sg_rows = phase_sgconv_parity(smi)
    ga_row = phase_gated_attention_parity(smi)
    wavlm_row = phase_wavlm_step(smi)
    pad_short = phase_pad_short()
    phase_train_parity()
    train = phase_train()
    train_profile = phase_train_profile()
    evals = phase_eval_parity()
    phase_augment()
    phase_loader(train["step_ms_median"])
    phase_npz()
    phase_melgan_multiscales(smi)
    phase_int8_disc(smi)
    # the two CLI runs stay on disk for phase cli_squim, which tests them again
    with tempfile.TemporaryDirectory(prefix="vibravox_cli_") as cli_dir, \
            tempfile.TemporaryDirectory(prefix="vibravox_noisy_cli_") as noisy_dir:
        cli = phase_cli(cli_dir)
        noisy = phase_cli_noisybwe(noisy_dir)
        phase_stp_parity()
        with tempfile.TemporaryDirectory(prefix="vibravox_stp_weights_") as weights, \
                tempfile.TemporaryDirectory(prefix="vibravox_stp_cli_") as stp_cli_dir:
            stp_weights(weights)
            stp = phase_stp_train(weights)
            cli_stp = phase_cli_stp(weights, stp_cli_dir)
            phase_scripts(cli_dir, stp_cli_dir, smi)
        spkv = {"parity": phase_spkv_parity(), "embed": phase_spkv_embed(), "cli": phase_cli_spkv()}
        mimi = {"parity": phase_mimi_parity(), "train": phase_mimi_train(), "codec": phase_codec(),
                "cli": phase_cli_mimi()}
        with tempfile.TemporaryDirectory(prefix="vibravox_squim_") as squim_dir:
            squim = {"parity": phase_squim_parity(squim_dir), "eval": phase_squim_eval(squim_dir),
                     "hub": phase_hub_enhance(),
                     "cli": phase_cli_squim(squim_dir, cli_dir, noisy_dir, cli, noisy)}
    dp = phase_dp_parity(train)
    phase_fsdp_tp()
    with tempfile.TemporaryDirectory(prefix="vibravox_cli_dp_") as cli_dp_dir:
        phase_cli_dp(cli_dp_dir)
    weights_day = phase_weights_day(smi)
    emit(kernels_line(smi, k1_rows, k2_rows, dft_rows, sg_rows, ga_row, wavlm_row, serve_launches, train,
                      train_profile, evals, cli, noisy, pad_short, stp, cli_stp, spkv, mimi, squim, dp, weights_day))
    emit({"phase": "done", "wall_seconds": time.perf_counter() - t_start})
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def summed(rows, keys, ops_key: str, bytes_key: str, times: int = 1) -> dict:
    """``times`` the sum over rows of each (out, src) of ``keys``, and the
    bound: the sum of each row's own max(operations, bytes), with the kind
    that gives most of it."""
    out = {k: times * sum(r[src] for r in rows) for k, src in keys}
    led = {"operations": 0.0, "bytes": 0.0}
    for r in rows:
        led["operations" if r[ops_key] >= r[bytes_key] else "bytes"] += max(r[ops_key], r[bytes_key])
    out.update(ops_ms=times * sum(r[ops_key] for r in rows), bytes_ms=times * sum(r[bytes_key] for r in rows),
               bound_ms=times * sum(led.values()), bound_by=max(led, key=led.get))
    return out


def _per_step(rows, dtype, kernel_key, plain_key, ops_key, bytes_key, launches_per_shape=2):
    """Sum over the shapes of one launch each, times the launches of each
    shape (each residual shape runs twice in a train step and in a
    generator forward)."""
    rows = [r for r in rows if kernel_key in r and r["dtype"] == dtype]
    return summed(rows, (("kernel_ms", kernel_key), ("plain_ms", plain_key)), ops_key, bytes_key,
                  launches_per_shape)


def c1_entry(sg_rows, train, train_profile, launches, launches_by_path, smi) -> dict:
    """C1's entry of the ``kernels`` line from phase sgconv_parity's rows:
    ``ms``, ``plain_ms`` (the polyphase twin), ``library_ms`` (cuDNN's bf16
    call) and ``bound_ms`` a train step (``sg_per_step``), and each call's
    row."""
    step = sg_per_step(sg_rows)
    return {"name": "strided_group_conv", "route": "cuda",
            "source": "vibravox_tpu_torch/ops/csrc/strided_group_conv.cu",
            "replaces": None, "note": "no TPU kernel: the JAX package leaves these convolutions to XLA",
            "launches": launches, "launches_by_path": launches_by_path,
            "launches_per_step": train["launches_per_step"]["C1"],
            "max_abs_err": max(max(r["err_over_scale"], r["err_over_scale_f64"]) for r in sg_rows),
            "max_err_over_tol": max(max(r["err_over_scale"], r["err_over_scale_f64"]) / r["tol"] for r in sg_rows),
            "ms": step["kernel_ms"], "plain_ms": step["plain_ms"], "library_ms": step["library_ms"],
            "bound_ms": step["bound_ms"], "bound_by": step["bound_by"], "per": step["per"],
            "traced_us_per_step": train_profile["by_kind_us"].get("C1 strided_group_conv"), "card": smi,
            "train": step,
            "calls": [{k: r[k] for k in ("layer", "B", "pass", "calls_per_step", "kernel_ms", "plain_ms",
                                         "library_ms", "bound_ms", "bound_by", "err_over_scale",
                                         "err_over_scale_f64", "tol")} for r in sg_rows],
            "errors": "max_abs_err is the larger of the errors against IEEE float32 and float64, over the "
                      "reference's largest magnitude"}


def c2_entry(ga_row, wavlm_row, launches_by_path, smi) -> dict:
    """C2's entry of the ``kernels`` line: ms a WavLM train step (24 forward
    and 24 backward calls at the cell's shape) of the kernel, the library
    route (SDPA on the materialised bias) and the plain twin, beside the
    bound at the float32 FMAs' 67 TFLOP/s, from phase
    gated_attention_parity's row; ``launches`` and ``launches_per_step``
    from phase wavlm_step's WavLM-Large train step on the kernel's route,
    C2's main path (every other path of this script runs no WavLM)."""
    step = ga_row["per_train_step"]
    launches = wavlm_row["kernel"]["launches"]["C2"]
    return {"name": "gated_attention", "route": "cuda",
            "source": "vibravox_tpu_torch/ops/csrc/gated_attention.cu",
            "replaces": None, "note": "no TPU kernel: the JAX package has no WavLM",
            "launches": launches, "launches_by_path": launches_by_path,
            "launches_per_step": launches,
            "max_abs_err": max(ga_row["err_over_scale"].values()),
            "max_err_over_tol": max(ga_row["err_over_scale"].values()) / ga_row["tol"],
            "ms": step["kernel_ms"], "plain_ms": step["plain_ms"], "library_ms": step["library_ms"],
            "bound_ms": step["fma_ops_ms"], "bound_by": "operations at the float32 FMAs' 67 TFLOP/s",
            "tf32_bound_ms": step["tf32_ops_ms"],
            "per": "per WavLM train step: 24 layers at B 8, H 16, T 999, float32", "card": smi,
            "calls": {p: ga_row[p] for p in ("forward", "backward")},
            "errors": "max_abs_err is the largest of the six outputs' errors against the float64 twin, over "
                      "its largest magnitude"}


def kernels_line(smi, k1_rows, k2_rows, dft_rows, sg_rows, ga_row, wavlm_row, serve_launches, train,
                 train_profile, evals, cli, noisy, pad_short, stp, cli_stp, spkv, mimi, squim, dp, weights_day) -> dict:
    """All six kernels: K1-K4, then C1 (``c1_entry``) and C2 (``c2_entry``).  ``ms``, ``plain_ms``, ``library_ms`` and
    ``bound_ms`` are per train step (batch 32, 2.5 s, bfloat16 networks,
    float32 STFT): each kernel's launches of one step at their shapes,
    measured one by one with CUDA events.  ``launches`` is the count over
    this slice's main path, the CLI's first run (fit and test), and for C2
    the WavLM-Large train step of phase wavlm_step;
    ``launches_by_path`` has it per path, the timed fit of the train phase
    included, that WavLM step on both routes (C2 alone, on the kernel's), the STP, Mimi and SQUIM paths, which run none of the four
    kernels, the hub enhancement script (K1 alone), the CLI tests with
    SQUIM (K1 and K3), the dp_parity ranks' own counts (the timed bf16
    steps, the float32 parity step), the weights-day runbook (K1 and K3),
    and the SPKV paths, which run K3 alone (its ``spkv`` block: the log-mel front
    end's fft-512 times and bounds, per call at the b32 regime's shape and
    at a batch-1 trial).  K1's serving numbers (per forward, float32 and bfloat16, 1 s
    bucket, batch 8) and its float32 eval numbers (per eval forward of the
    CLI's test batch, batch 1, and of the whole utterance, an extra shape)
    stay beside them, with K1's launch configuration at every timed shape;
    so do K3's eval numbers (per eval step of the CLI's test batch).  Every
    bound is the sum of each shape's own max(operations, bytes)."""
    def by_path(key):
        return {"train_fit": train["launches"][key],
                "cli_fit": cli["fit"]["launches"][key], "cli_test": cli["test"]["launches"][key],
                "cli_resumed_fit": cli["resume"]["launches"]["fit"][key],
                "cli_resumed_test": cli["resume"]["launches"]["test"][key],
                "cli_noisybwe_fit": noisy["launches"]["fit"][key],
                "cli_noisybwe_test": noisy["launches"]["test"][key],
                "pad_short": pad_short["launches"][key],
                "stp_train": stp["train"]["launches"][key],
                "cli_stp": cli_stp["first"]["launches"][key],
                "cli_stp_resumed": cli_stp["resumed"]["launches"][key],
                "spkv_embed": sum(r["launches"][key] for r in spkv["embed"].values()),
                "cli_spkv": spkv["cli"]["mixed_gender"]["launches"][key],
                "cli_spkv_same_gender": spkv["cli"]["same_gender"]["launches"][key],
                "mimi_parity": mimi["parity"]["launches"][key], "mimi_train": mimi["train"]["launches"][key],
                "codec": mimi["codec"]["launches"][key], "cli_mimi": mimi["cli"]["first"]["launches"][key],
                "cli_mimi_resumed": mimi["cli"]["resumed"]["launches"][key],
                "squim_parity": squim["parity"]["launches"][key], "squim_eval": squim["eval"]["launches"][key],
                "hub_enhance": squim["hub"]["launches"][key],
                "cli_squim_test": squim["cli"]["eben"]["launches"][key],
                "cli_squim_noisybwe_test": squim["cli"]["noisybwe"]["launches"][key],
                "dp_parity_timed_steps_by_rank": [r["launches"][key] for r in dp["bf16"]],
                "dp_parity_float32_step_by_rank": [r[key] for r in dp["parity"]["launches_by_rank"]],
                "weights_day": weights_day["launches"][key],
                "wavlm_train_step": wavlm_row["kernel"]["launches"][key],
                "wavlm_train_step_library_route": wavlm_row["library"]["launches"][key]}

    main_path = {k: cli["fit"]["launches"][k] + cli["test"]["launches"][k]
                 for k in ("K1", "K2", "K3", "K4", "C1", "C2")}
    eval_rows = evals["k1"] + evals["k1_whole_utterance"]

    def k1_eval(rows, what):
        # each stack shape runs twice in a generator forward
        out = summed(rows, (("kernel_ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                            ("fma_ops_ms", "fma_ops_ms")), "ops_ms", "bytes_ms", 2)
        out.update(per=what, shapes=[{k: r[k] for k in ("B", "C", "T", "t_mod_tile")} for r in rows])
        return out

    k1_eval_cli = k1_eval(evals["k1"], "per eval forward of the CLI's test batch (batch 1, float32)")
    k1_eval_cli["launches_per_test_batch"] = cli["test"]["launches"]["K1"] // CLI_TEST_BATCHES
    k3_eval = summed(evals["k3"], (("kernel_ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                                   ("library_ms", "library_ms")), "ops_ms", "bytes_ms", 2)
    k3_eval.update(per="per eval step of the CLI's test batch: 3 resolutions x 2 signals, batch 1",
                   launches_per_test_batch=cli["test"]["launches"]["K3"] // CLI_TEST_BATCHES,
                   resolutions=evals["k3"])
    per_step = train["launches_per_step"]
    kinds = train_profile["by_kind_us"]
    # per forward at the serving bucket: each stack shape runs twice
    k1_serve = {dt: _per_step(k1_rows, dt, "kernel_ms", "plain_ms", "ops_ms", "bytes_ms")
                for dt in ("float32", "bfloat16")}
    k1_serve["launches"] = serve_launches
    k1 = {dt: _per_step(k2_rows, dt, "k1_kernel_ms", "k1_plain_ms", "k1_ops_ms", "k1_bytes_ms")
          for dt in ("bfloat16", "float32")}
    k2 = {dt: _per_step(k2_rows, dt, "kernel_ms", "plain_ms", "ops_ms", "bytes_ms")
          for dt in ("bfloat16", "float32")}
    # float32's bound is at 3xTF32; the same work at 67 TFLOP/s of FMAs beside it
    for out, rows, key in ((k1_serve, k1_rows, "fma_ops_ms"), (k1, k2_rows, "k1_fma_ops_ms"),
                           (k2, k2_rows, "fma_ops_ms")):
        out["float32"]["fma_ops_ms"] = 2 * sum(r[key] for r in rows if key in r and r["dtype"] == "float32")
    # K2 float32's design bound: its recompute on FMAs, its products in 3xTF32
    k2["float32"]["mixed_ops_ms"] = 2 * sum(r["mixed_ops_ms"] for r in k2_rows
                                            if "kernel_ms" in r and r["dtype"] == "float32")

    def dft(prefix, signals):
        out = summed(dft_rows, tuple((k, f"{prefix}_{src}") for k, src in
                                     (("kernel_ms", "ms"), ("plain_ms", "plain_ms"),
                                      ("library_ms", "library_ms"))),
                     f"{prefix}_ops_ms", f"{prefix}_bytes_ms", signals)
        out["resolutions"] = [{k: r[k] for k in ("fft", "hop", "win", "frames", "bins",
                                                 f"{prefix}_ms", f"{prefix}_plain_ms",
                                                 f"{prefix}_library_ms", f"{prefix}_ops_ms",
                                                 f"{prefix}_bytes_ms", f"{prefix}_err_over_scale",
                                                 f"{prefix}_beats_library")}
                              for r in dft_rows]
        return out

    k3, k4 = dft("k3", 2), dft("k4", 2)  # per step: K3 on 2 signals, K4 twice on one
    k2_errs = [max(r["dx_err_over_scale"] / r["dx_tol"],
                   r["dw_err_over_scale"] / r["dw_tol"] if r["dw_held"] else 0.0)
               for r in k2_rows]
    step = "per train step: batch 32, 2.5 s, bfloat16 networks"
    return {"kernels": [
        {"name": "fused_residual_stack", "route": "cuda",
         "source": "vibravox_tpu_torch/ops/csrc/fused_residual.cu",
         "replaces": "vibravox_tpu/ops/fused_residual.py:140",
         "launches": main_path["K1"], "launches_by_path": by_path("K1"),
         "launches_per_step": per_step["K1"],
         "max_abs_err": max([r["max_abs_err"] for r in k1_rows + eval_rows if r["dtype"] == "float32"]
                            + [r["k1_max_abs_err"] for r in k2_rows if r["dtype"] == "float32"]),
         "max_err_over_tol": max([r["max_abs_err"] / r["tol"] for r in k1_rows + eval_rows]
                                 + [r["k1_max_abs_err"] / r["k1_tol"] for r in k2_rows]),
         "ms": k1["bfloat16"]["kernel_ms"], "plain_ms": k1["bfloat16"]["plain_ms"],
         "bound_ms": k1["bfloat16"]["bound_ms"], "bound_by": k1["bfloat16"]["bound_by"],
         "library_ms": None, "per": step, "traced_us_per_step": kinds.get("K1 fused_residual"),
         "card": smi, "train": k1, "serve_per_forward": k1_serve, "eval_per_forward_f32": k1_eval_cli,
         "eval_whole_utterance_extra_f32": k1_eval(evals["k1_whole_utterance"],
                                                   "per eval forward of a whole 5.7 s utterance, an extra shape"),
         "configs": [{"C": r["C"], "T": r["T"], "B": r["B"], "dtype": r["dtype"], **r["config"]}
                     for r in k1_rows + eval_rows if "kernel_ms" in r]
         + [{"C": r["C"], "T": r["T"], "B": r["B"], "dtype": r["dtype"], **r["k1_config"]}
            for r in k2_rows if "kernel_ms" in r]},
        {"name": "fused_residual_stack_backward", "route": "cuda",
         "source": "vibravox_tpu_torch/ops/csrc/fused_residual_bwd.cu",
         "replaces": "vibravox_tpu/ops/fused_residual.py:193",
         "launches": main_path["K2"], "launches_by_path": by_path("K2"),
         "launches_per_step": per_step["K2"],
         "max_abs_err": max(r["dx_err_over_scale"] for r in k2_rows if r["dtype"] == "float32"),
         "max_err_over_tol": max(k2_errs),
         "ms": k2["bfloat16"]["kernel_ms"], "plain_ms": k2["bfloat16"]["plain_ms"],
         "bound_ms": k2["bfloat16"]["bound_ms"], "bound_by": k2["bfloat16"]["bound_by"],
         "library_ms": None, "per": step, "traced_us_per_step": kinds.get("K2 fused_residual_bwd"),
         "card": smi, "train": k2,
         "passes_us_per_call": [{"C": r["C"], "T": r["T"], "dtype": r["dtype"], **r["k2_passes_us"]}
                                for r in k2_rows if "k2_passes_us" in r],
         "errors": "max_abs_err is dx's error over the largest |dx| (float32)"},
        {"name": "framed_dft_magnitude", "route": "cuda",
         "source": "vibravox_tpu_torch/ops/csrc/framed_dft.cu",
         "replaces": "vibravox_tpu/ops/pallas_stft.py:101",
         "launches": main_path["K3"], "launches_by_path": by_path("K3"),
         "launches_per_step": per_step["K3"],
         "max_abs_err": max(r["k3_err_over_scale"] for r in dft_rows + evals["k3"] + spkv["parity"]["k3"]),
         "max_err_over_tol": max(r["k3_err_over_scale"] / r["k3_tol"]
                                 for r in dft_rows + evals["k3"] + spkv["parity"]["k3"]),
         "ms": k3["kernel_ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "per": "per train step: 3 resolutions x 2 signals, B 32, T 39904, float32",
         "traced_us_per_step": kinds.get("K3 framed_dft_magnitude"), "card": smi, "detail": k3,
         "eval": k3_eval,
         "spkv": {"per": "per call at fft 512, hop 160, win 400: the b32 regime (32 x 48000) and a batch-1 trial",
                  "calls": spkv["parity"]["k3"],
                  "traced_us_per_embed_batch": {dt: r["profile"]["by_kind_us"].get("K3 framed_dft_magnitude")
                                                for dt, r in spkv["embed"].items()},
                  "launches_per_embed_batch": 1, "launches_per_cli_trial": 2},
         "errors": "max_abs_err is the error over the largest magnitude"},
        {"name": "framed_dft_magnitude_backward", "route": "cuda",
         "source": "vibravox_tpu_torch/ops/csrc/framed_dft.cu",
         "replaces": "vibravox_tpu/ops/pallas_stft.py:178",
         "launches": main_path["K4"], "launches_by_path": by_path("K4"),
         "launches_per_step": per_step["K4"],
         "max_abs_err": max(r["k4_err_over_scale"] for r in dft_rows),
         "max_err_over_tol": max(r["k4_err_over_scale"] / r["k4_tol"] for r in dft_rows),
         "ms": k4["kernel_ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": k4["library_ms"],
         "per": "per train step: 3 resolutions x 2 backward passes, B 32, T 39904, float32",
         "traced_us_per_step": kinds.get("K4 framed_dft_backward"), "card": smi, "detail": k4,
         "errors": "max_abs_err is the error over the largest |dx|"},
        c1_entry(sg_rows, train, train_profile, main_path["C1"], by_path("C1"), smi),
        c2_entry(ga_row, wavlm_row, by_path("C2"), smi),
    ]}


if __name__ == "__main__":
    sys.exit(main())
