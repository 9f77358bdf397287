#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check every kernel on its path.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
The kernels build from ``vibravox_tpu_torch/ops/csrc`` at first use.  Phases
(one JSON line each; any failure raises and exits non-zero):

1. device: the card's name and power limit as nvidia-smi reports them;
2. build: every kernel source (K1; K2; K3 and K4), one nvcc each, all
   started together, with the nvcc time, the ptxas resource report and the
   HMMA (tensor-core) and LDSM (ldmatrix) instruction counts of each
   kernel; K1's bf16 kernel must have HMMA and LDSM and its f32 one no
   HMMA; K2's bf16 unit kernels must have HMMA and its f32 ones none;
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
   at the same shapes; K1 and K2 times, and K2's device time by pass from
   a CUDA-only trace of one call;
8. k3_k4_parity: the framed-DFT magnitude (K3) and its backward (K4)
   against ``torch.stft`` and its autograd at B = 32, T = 39904, the three
   loss resolutions, and at a ragged T, B = 1, T just above fft / 2, hops
   below 32, and T <= fft / 2 (T = 900 at fft 2048, T = 300 at fft 1024),
   where the reflect pad reflects more than once; K4 bit-equal over two
   runs; kernel, plain, library and bound times of whole wrapper calls, in
   turns;
9. pad_short: the ``pad`` collate on 32 utterances under 1024 samples
   (T = 1024, 992 after the generator's cut) through the full task's
   generator and its STFT loss, forward and backward, on the card against
   the CPU: K1, K2, K3, K4 launched, the 2048-point resolution at
   T <= fft / 2 (the discriminator needs about 3000 samples, so the whole
   train step does not take such a batch);
10. train_parity: one seeded float32 train step at small sizes on the card
    (K1-K4) against the same step on the CPU (the plain versions);
11. train: the training path.  ``Trainer.fit`` of the full ``eben.yaml``
    task at batch 32 on 2.5 s synthetic crops, bfloat16; the counts are
    reset after a warm-up fit and must equal 6 launches per step for each
    of K1-K4 over the timed fit;
12. train_profile: the untraced train-step wall, its device time by kernel
    kind from a CUDA-only trace, and the idle share;
13. eval_parity: the full task's float32 eval step on the first batch of
    the CLI's test loader (batch 1, a centred 2.5 s crop) and, as an extra
    shape, on one whole 5.7 s synthetic test utterance, on the card
    against the CPU (logs 1e-4 relative, enhanced audio 1e-4 of scale), K1
    and K3 six launches each; then K1 in float32 and K3 against their
    plain versions at the shapes the CLI batch's forward ran, and K1 at the
    whole utterance's (T no multiple of K1's tile), with times and K1's
    launch configuration (``eval_k1`` and ``eval_k3`` lines);
14. augment: on the host, at one torch thread as in a loader worker, the
    augmentation's worst case for one batch of 32 x 40000 samples and its
    airborne pair: every transform fires, at the slowest pitch step and
    speed factor (each step and factor timed once first), and the peak host
    memory of designing every resampler bank of ``light`` / ``aggressive``
    at 16 kHz with the bytes each keeps; then the resampler's dense and
    banded forms side by side (``resample_forms``): on the host at the
    speed factors, STOI's 16 -> 10 kHz and pitch step -3, on the card at
    48 -> 16 kHz, agreeing within 1e-6 of scale;
15. loader: the published train loaders (``bwe`` with ``light``,
    ``noisybwe`` with ``aggressive``, four workers) as the CLI composes
    them, over 32 batches of the synthetic source: the batches a second
    in steady state against the train phase's step, and 16 batches split
    into the source's items and the collate with its augmentation;
16. npz: the synthetic source written to a temporary directory of npz
    utterances; the data module over it (``light`` augmentation, two
    workers) gives the synthetic source's train, validation and test
    batches byte for byte;
17. cli: this slice's main path.  ``vibravox_tpu_torch.run.main`` with
    ``lightning_datamodule=bwe lightning_module=eben callbacks=bwe_checkpoint
    logging=csv``, the synthetic source (64 utterances) with the published
    ``light`` augmentation, two epochs, four validation and four test
    batches, in a temporary run_dir: the K1-K4 launches of fit and of
    test("last") are asserted (test: K1 and K3 only), with the fit's wall,
    each step's data wait against its time, the test's seconds per batch
    (the eval step on the card, the host metrics, STOI) and the test
    metrics; ``last``, ``index.json`` and the top-2 checkpoints must exist;
    a second run with ``max_epochs=3`` must resume at epoch 2, its Adam
    step counts on the CPU, its train steps timed against the first run's;
18. cli_noisybwe: ``run.main`` with ``lightning_datamodule=noisybwe
    lightning_module=eben callbacks=bwe_checkpoint logging=csv`` on the
    synthetic source (64 utterances) with its published ``aggressive``
    augmentation, fit two epochs then test("last"), four batches of each
    of the ``synthetic`` and ``real`` loaders: K1-K4 launches asserted, the
    real loader's batches reference-free (no airborne key, no losses, no
    metrics), each step's data wait against its time;
19. stp_parity: the STP slice (wav2vec2-CTC, no hand-written kernel on its
    path) in float32 under ``strict_float32``: the full-width base model
    (seed 0) in eval on 2 x 48000 samples, card against CPU (1e-4 of
    scale); one train step at hidden 256 / 4 layers with the random parts
    off (loss 1e-4 relative, parameters within 1e-2 of the update); the
    CTC loss at the recipe's shapes (value 1e-5 relative, each row's
    gradient within 1e-5 + 1e-6 x its loss);
20. stp_train / stp_profile: ``Trainer.fit`` of the published STP task
    (the base model through the from_pretrained config, reading a local
    checkpoint written from seed 0) on the synthetic ``STPDataModule`` at
    batch 8, bf16-mixed, 28 synchronised steps: step times, audio-s/s,
    padded lengths, data waits, peak memory, model FLOPs and their share of
    the bf16 peak; then a CUDA-only trace of 5 steps by kernel kind, the
    idle share, and the positional conv alone; no K1-K4 launch;
21. cli_stp: ``run.main`` with ``lightning_datamodule=stp
    lightning_module=wav2vec2_for_stp callbacks=stp_checkpoint
    logging=csv`` on the synthetic source, two epochs of two steps, then
    test("last"), then a resumed third epoch: finite ``test/ctc_loss`` and
    ``test/char_error_rate``, the fit's wall, the test seconds per batch
    split into the eval step and the host decode + CER;
22. the ``kernels`` line (all four kernels), then the result line.

Phases 3 and 7 change PyTorch's precision settings, and only around the
comparison; the other phases run the port as a user calls it.  Each trace
is taken again, up to four times, until it records every launch of the
hand-written kernels that its run made (``cuda_trace``).
"""

from __future__ import annotations

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

import numpy as np
import torch

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
from vibravox_tpu_torch.models.wav2vec2 import save_pretrained, wav2vec2_for_ctc_from_config
from vibravox_tpu_torch.ops import _build
from vibravox_tpu_torch.ops import augment
from vibravox_tpu_torch.ops.fused_residual import (
    plain_residual_stack,
    plain_residual_stack_backward,
    residual_stack,
    residual_stack_backward,
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
from vibravox_tpu_torch.ops.ctc import ctc_loss
from vibravox_tpu_torch.ops.resample import KaiserResampler, bank_nbytes, design_band, design_kernel
from vibravox_tpu_torch.ops.stft import MultiResolutionSTFTLoss
from vibravox_tpu_torch.serving import EnhanceServer
from vibravox_tpu_torch.tasks.eben import EBENTask
from vibravox_tpu_torch.tasks.wav2vec2_stp import Wav2Vec2STPTask

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12

BATCH = 8  # serving max_batch
# (stacks, C, T) of the 1 s serving bucket: T = 15840 samples -> 3968 PQMF frames
SERVING_SHAPES = (("enc_0,dec_2", 32, 3968), ("enc_1,dec_1", 64, 1984), ("enc_2,dec_0", 128, 496))
EXTRA_SHAPES = ((3, 64, 1001), (2, 32, 40), (2, 128, 40))  # (B, C, T)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# K1's CUDA kernels: f32, bf16, and the bf16 path's weight relayout
K1_KERNELS = ("residual_stack_kernel", "residual_stack_mma_kernel", "relayout_weights_kernel")
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


def stack_bound_ms(b: int, c: int, t: int, dtype: torch.dtype):
    """(operations ms, bytes ms) of one stack: 24 C^2 T B FLOP at the type's
    peak; x read and y written once plus the six weight tensors read once."""
    flops = 24 * c * c * t * b
    nbytes = (2 * b * c * t + 12 * c * c) * torch.empty((), dtype=dtype).element_size()
    return flops / PEAK_FLOPS[dtype] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


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
    """Tensor-core (HMMA) and ldmatrix (LDSM) instructions per kernel in a
    built library's SASS, from ``cuobjdump -sass``; keys are the mangled
    kernel names."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"HMMA": 0, "LDSM": 0}
        elif name is not None:
            for op in ("HMMA", "LDSM"):
                if op in line:
                    counts[name][op] += 1
    return counts


def check_tensor_cores(source: str, counts: dict, bf16_kernel: str, f32_kernel: str, ops) -> None:
    """Raises unless every bf16 kernel whose name holds ``bf16_kernel`` has
    each of ``ops`` in its SASS and no f32 kernel whose name holds
    ``f32_kernel`` has HMMA (a kernel is bf16 if its mangled name has the
    type)."""
    bf16 = {k: v for k, v in counts.items() if bf16_kernel in k and "__nv_bfloat16" in k}
    f32 = {k: v for k, v in counts.items() if f32_kernel in k and "__nv_bfloat16" not in k}
    if not bf16 or not f32:
        raise AssertionError(f"{source}: its bf16 or f32 kernels are not in its SASS: {sorted(counts)}")
    for k, v in bf16.items():
        if not all(v[op] for op in ops):
            raise AssertionError(f"{source}: a bf16 kernel lacks {ops}: {k} {v}")
    for k, v in f32.items():
        if v["HMMA"]:
            raise AssertionError(f"{source}: an f32 kernel has HMMA: {k} {v}")


def phase_build() -> None:
    """Every kernel source, one nvcc each, all started together; the HMMA
    and LDSM counts of each kernel.  K1's bf16 kernel must run on the tensor
    cores from ldmatrix fragments and its f32 one must not use them; K2's
    bf16 unit kernels must have HMMA and its f32 ones none."""
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
            for kernel in ("unit_forward_kernel", "unit_backward_kernel"):
                check_tensor_cores(name, counts, kernel, kernel, ("HMMA",))


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
                               bound_by=bound_by)
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
    """Where a batched float32 forward's time goes at the serving bucket: the
    wall time of forwards run back to back with no tracing, the device time
    of the same forwards by kernel kind from a CUDA-only torch.profiler trace
    (no host tracing to slow the host), and the device's idle share."""
    from torch.autograd import DeviceType

    torch.manual_seed(0)
    model = EBENGenerator(m=4, n=32, p=2)
    x = torch.randn(BATCH, model.valid_length(16000), 1, device="cuda") * 0.1
    n_fwd = 20
    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_fwd):
            model(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

        def forwards():
            for _ in range(n_fwd):
                model(x)

        # float32 K1 is one launch a call, six calls a forward
        prof, _ = cuda_trace(forwards, lambda events: sum(
            any(k in e.name for k in K1_KERNELS) for e in events) == 6 * n_fwd, "the serving forwards")
    groups: dict = {}
    top = []
    launches = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        launches += e.count
        us = e.self_device_time_total / n_fwd
        name = e.key
        kind = ("K1 fused_residual" if any(k in name for k in K1_KERNELS)
                else "reflection pad" if "reflection" in name.lower()
                else "conv (cuDNN/GEMM)" if any(s in name.lower() for s in
                                                ("conv", "gemm", "xmma", "cudnn", "sm90"))
                else "other")
        groups[kind] = groups.get(kind, 0.0) + us
        top.append((us, e.count // n_fwd, name[:90]))
    device_us = sum(groups.values())
    top.sort(reverse=True)
    if not device_us:
        raise AssertionError("the CUDA-only trace recorded no device time")
    emit({"phase": "profile", "B": BATCH, "T": int(x.shape[1]), "dtype": "float32",
          "forwards": n_fwd, "forward_wall_us_untraced": wall_us / n_fwd,
          "device_us_per_forward": device_us,
          "device_idle_share": 1.0 - device_us / (wall_us / n_fwd),
          "device_kernels_per_forward": launches / n_fwd,
          "by_kind_us": groups,
          "top_kernels": [{"us": us, "per_forward": n, "name": nm} for us, n, nm in top[:10]]})


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
# bf16 semantics), which alone moves dW by up to 6.8e-2 of scale
K2_TOL = {torch.float32: (1e-4, 2e-4), torch.bfloat16: (5e-2, 1e-1)}
BF16_DW_MIN_ROWS = 1000
RESOLUTIONS = ((512, 50, 240), (1024, 120, 600), (2048, 240, 1200))  # multi_stft.yaml
K3_TOL, K4_TOL = 1e-5, 2e-4
TRAIN_WARMUP, TRAIN_STEPS, PROFILE_STEPS = 3, 10, 5


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def k2_bound_ms(b: int, c: int, t: int, dtype: torch.dtype):
    """(operations ms, bytes ms) of one stack backward: 72 C^2 T B FLOP (the
    recompute of the forward 24, dx 24, dW 24) at the type's peak; x and g
    read, dx written, the weights read and the float32 dW written once."""
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = 3 * b * c * t * elt + 12 * c * c * (elt + 4)
    return 72 * c * c * t * b / PEAK_FLOPS[dtype] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


# K2's CUDA launches in the order of one call: the recompute of x1 and x2,
# then each unit's backward and its dW reduction, units at d = 9, 3, 1
K2_PASSES = (("unit_forward d=1", "unit_forward_kernel"), ("unit_forward d=3", "unit_forward_kernel"),
             ("unit_backward d=9", "unit_backward_kernel"), ("reduce_partials d=9", "reduce_partials_kernel"),
             ("unit_backward d=3", "unit_backward_kernel"), ("reduce_partials d=3", "reduce_partials_kernel"),
             ("unit_backward d=1", "unit_backward_kernel"), ("reduce_partials d=1", "reduce_partials_kernel"))


def k2_passes_us(x, ks, g) -> dict:
    """K2's device time by pass (µs), from a CUDA-only torch.profiler trace
    of one call after a warm-up call; the kernels in launch order."""
    residual_stack_backward(x, ks, g)
    torch.cuda.synchronize()
    kinds = {kernel for _, kernel in K2_PASSES}

    def passes(events):
        return sorted((e for e in events if any(k in e.name for k in kinds)), key=lambda e: e.time_range.start)

    def whole(events):
        ev = passes(events)
        return len(ev) == len(K2_PASSES) and all(k in e.name for (_, k), e in zip(K2_PASSES, ev))

    _, events = cuda_trace(lambda: residual_stack_backward(x, ks, g), whole, "one K2 call")
    events = passes(events)
    return {label: e.time_range.elapsed_us() for (label, _), e in zip(K2_PASSES, events)}


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
                           k1_config=k1_config(b, c, t, dtype))
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
                               ops_ms=ops_ms, bytes_ms=bytes_ms,
                               k1_kernel_ms=float(np.median(k1)), k1_plain_ms=float(np.median(p1)),
                               k1_ops_ms=ops1, k1_bytes_ms=bytes1,
                               k2_passes_us=passes, k2_passes_sum_us=sum(passes.values()))
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


def read_counts() -> dict:
    return {"K1": residual_stack.launches, "K2": residual_stack_backward.launches,
            "K3": framed_dft_magnitude.launches, "K4": framed_dft_backward.launches}


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
    if counts != {"K1": 6, "K2": 6, "K3": 2, "K4": 2}:
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
    # the backward of Σλ·L)
    want = {k: 6 * TRAIN_STEPS for k in ("K1", "K2", "K3", "K4")}
    if counts != want:
        raise AssertionError(f"kernel launches {counts} on the main path, expected {want}")
    return out


# CUDA launches of each hand-written kernel in one train step: six calls of
# each; a bf16 K1 call is two launches (the weight relayout, the stack), a
# K2 call is K2_PASSES, a K3 call one, a K4 call two (frames, then the sum)
TRAIN_KERNEL_LAUNCHES = {"K1 fused_residual": 12, "K2 fused_residual_bwd": 6 * len(K2_PASSES),
                         "K3 framed_dft_magnitude": 6, "K4 framed_dft_backward": 12}


def train_kind(name: str) -> str:
    low = name.lower()
    return ("K1 fused_residual" if any(k in name for k in K1_KERNELS)
            else "K2 fused_residual_bwd" if any(s in name for s in (
                "unit_forward_kernel", "unit_backward_kernel", "reduce_partials_kernel"))
            else "K3 framed_dft_magnitude" if "framed_dft_magnitude_kernel" in name
            else "K4 framed_dft_backward" if "framed_dft_backward" in name  # both passes
            else "cuDNN conv / GEMM" if any(s in low for s in ("conv", "gemm", "xmma", "cudnn", "sm90"))
            else "other")


def phase_train_profile() -> dict:
    """Where a train step's time goes (full task, batch 32, bf16): the wall
    of PROFILE_STEPS steps run back to back with no tracing on one device
    batch, the device time of as many more by kernel kind from a CUDA-only
    torch.profiler trace, and the device's idle share."""
    from torch.autograd import DeviceType

    torch.manual_seed(0)
    task = make_task("cuda", small=False, optimizer=adam(3e-4, betas=(0.5, 0.9)),
                     compute_dtype="bfloat16")
    state = task.init_state(0)
    gen = torch.Generator().manual_seed(3)
    ref = torch.randn(TRAIN_B, TRAIN_T, 1, generator=gen) * 0.1
    batch = {"audio_body_conducted": (ref * 0.5).cuda(), "audio_airborne": ref.cuda()}
    for _ in range(2):
        task.train_step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        task.train_step(state, batch)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / PROFILE_STEPS

    def steps():
        for _ in range(PROFILE_STEPS):
            task.train_step(state, batch)

    def whole(events):
        counts: dict = {}
        for e in events:
            counts[train_kind(e.name)] = counts.get(train_kind(e.name), 0) + 1
        return all(counts.get(k, 0) == n * PROFILE_STEPS for k, n in TRAIN_KERNEL_LAUNCHES.items())

    prof, _ = cuda_trace(steps, whole, "the train steps")
    groups: dict = {}
    top = []
    launches = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        launches += e.count
        us = e.self_device_time_total / PROFILE_STEPS
        name = e.key
        kind = train_kind(name)
        groups[kind] = groups.get(kind, 0.0) + us
        top.append((us, e.count / PROFILE_STEPS, name[:90]))
    device_us = sum(groups.values())
    top.sort(reverse=True)
    if not device_us:
        raise AssertionError("the CUDA-only trace recorded no device time")
    out = {"phase": "train_profile", "B": TRAIN_B, "T": TRAIN_T, "compute_dtype": "bfloat16",
           "steps": PROFILE_STEPS, "step_wall_us_untraced": wall_us, "device_us_per_step": device_us,
           "device_idle_share": 1.0 - device_us / wall_us,
           "device_kernels_per_step": launches / PROFILE_STEPS, "by_kind_us": groups,
           "top_kernels": [{"us": us, "per_step": n, "name": nm} for us, n, nm in top[:15]]}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the workflow slice: the eval path and the CLI
# ---------------------------------------------------------------------------

# a whole 5.7 s synthetic test utterance, an extra shape beside the CLI's
# test batch: its residual stacks run at T = 22848 / 11424 / 2856, no
# multiple of a K1 tile (f32 128 / 64 / 32)
EVAL_UTTERANCE = 6
CLI_ARGS = ("lightning_datamodule=bwe", "lightning_module=eben", "callbacks=bwe_checkpoint",
            "logging=csv", "lightning_datamodule.dataset_name_principal=synthetic",
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
    if counts != {"K1": 6, "K2": 0, "K3": 6, "K4": 0}:
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
           "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_ms": bound_ms, "bound_by": bound_by}
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


def phase_cli() -> dict:
    """The CLI's main path: ``vibravox_tpu_torch.run.main`` with CLI_ARGS,
    at full width, in a temporary run_dir (fit two epochs of two steps at
    batch 32, bf16, validating four batch-1 float32 batches an epoch,
    checkpoints by validation STOI, then test("last") on four batches),
    then again with max_epochs 3, which resumes at epoch 2.  The counts are
    reset before each run; fit and test are told apart at the test's entry.
    The test pass is timed per batch: the eval step (wall, synchronised,
    and CUDA events) and the host metrics (SI-SDR, the copy, STOI).  Each
    train step is timed by CUDA events around it (no added sync; a host
    stall inside the step shows as device time), and the devices of both
    Adams' step counts are read after it: they must be on the CPU in both
    runs, as in a fresh one (restored onto the card, they cost a host sync
    per parameter); the resumed run's steps are reported beside the first
    run's, the first step of each and the median of the rest."""
    import tempfile

    from vibravox_tpu_torch import run
    from vibravox_tpu_torch.tasks import se_metrics

    timing = {"eval_step_wall": [], "eval_step_device": [], "metrics": [], "stoi": []}
    marks: dict = {}
    train_steps = {"events": [], "adam_step_devices": set()}
    train_step, eval_step, eval_metrics, stoi, test = (
        EBENTask.train_step, EBENTask.eval_step, EBENTask.eval_metrics, se_metrics.stoi, Trainer.test)
    fit = Trainer.fit

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
        t0 = time.perf_counter()
        metrics = run.main([*CLI_ARGS, f"++run_dir={run_dir}", f"++trainer.max_epochs={epochs}"])
        counts = read_counts()
        fit = marks["fit_counts"]
        steps = {"train_step_ms": [a.elapsed_time(b) for a, b in train_steps["events"]],
                 "data_wait_ms": [1e3 * w for w in marks["trainer"].data_wait_seconds],
                 "adam_step_devices": sorted(train_steps["adam_step_devices"])}
        return metrics, {"fit": fit, "test": {k: counts[k] - fit[k] for k in counts}}, \
            marks["fit_end"] - t0, marks["test_end"] - marks["fit_end"], steps

    def want(steps, val_batches, test_batches):
        fit = {"K1": 6 * (steps + val_batches), "K2": 6 * steps, "K3": 6 * (steps + val_batches),
               "K4": 6 * steps}
        return {"fit": fit, "test": {"K1": 6 * test_batches, "K2": 0, "K3": 6 * test_batches, "K4": 0}}

    EBENTask.train_step, EBENTask.eval_step = timed_train_step, timed_eval_step
    EBENTask.eval_metrics = timed(eval_metrics, "metrics")
    se_metrics.stoi, Trainer.test, Trainer.fit = timed(stoi, "stoi"), marked_test, kept_fit
    try:
        with tempfile.TemporaryDirectory(prefix="vibravox_cli_") as run_dir:
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
        se_metrics.stoi, Trainer.test, Trainer.fit = stoi, test, fit

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
    if counts != {"K1": 6, "K2": 6, "K3": 6, "K4": 3}:
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


NOISY_CLI_ARGS = ("lightning_datamodule=noisybwe", "lightning_module=eben", "callbacks=bwe_checkpoint",
                  "logging=csv", "lightning_datamodule.dataset_name=synthetic",
                  "++lightning_datamodule.synthetic_size=64",
                  "++trainer.limit_val_batches=4", "++trainer.limit_test_batches=4", "++trainer.max_epochs=2")


def phase_cli_noisybwe() -> dict:
    """``run.main`` with NOISY_CLI_ARGS in a temporary run_dir: noisybwe.yaml
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
        with tempfile.TemporaryDirectory(prefix="vibravox_noisy_cli_") as run_dir:
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
                    "K3": 6 * (2 * CLI_STEPS_PER_EPOCH + 2 * val), "K4": 6 * 2 * CLI_STEPS_PER_EPOCH},
            "test": {"K1": 6 * 2 * tests, "K2": 0, "K3": 6 * tests, "K4": 0}}
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


def stp_step_flops(config, batch: int, samples: int) -> float:
    """Model FLOPs of one train step, counted from the config (2 per
    multiply-add): the frozen conv stack forward once, everything after it
    forward and backward (3x its forward: the backward computes the
    gradients of both the activations and the weights)."""
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
    return conv + 3 * rest


def stp_kind(name: str) -> str:
    low = name.lower()
    if "ctc" in low:
        return "CTC"
    if any(s in low for s in ("flash", "fmha", "attention", "efficient")):
        return "attention"
    if "multi_tensor_apply" in low or "adam" in low:
        return "Adam"
    if any(s in low for s in ("dgrad", "wgrad")) or ("conv" in low and "bwd" in low):
        return "conv backward (the grouped positional conv; the conv stack is frozen)"
    if any(s in low for s in ("conv", "fprop", "implicit", "cudnn")):
        return "conv forward (the conv stack and the positional conv)"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "xmma", "cublas", "sm90_")):
        return "GEMMs"
    return "norms and elementwise"


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
    from torch.autograd import DeviceType

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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STP_PROFILE_STEPS):
        task.train_step(state, batch)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / STP_PROFILE_STEPS

    def steps():
        for _ in range(STP_PROFILE_STEPS):
            task.train_step(state, batch)

    def whole(events):
        kinds = [stp_kind(e.name) for e in events]
        return kinds.count("Adam") >= STP_PROFILE_STEPS and kinds.count("CTC") >= 2 * STP_PROFILE_STEPS

    prof, _ = cuda_trace(steps, whole, "the STP train steps")
    groups, top, launches = {}, [], 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        launches += e.count
        us = e.self_device_time_total / STP_PROFILE_STEPS
        groups[stp_kind(e.key)] = groups.get(stp_kind(e.key), 0.0) + us
        top.append((us, e.count / STP_PROFILE_STEPS, e.key[:90]))
    device_us = sum(groups.values())
    top.sort(reverse=True)
    if not device_us:
        raise AssertionError("the CUDA-only trace of the STP steps recorded no device time")
    t = int(batch["audio"].shape[1])
    frames = config.feat_extract_output_length(t)
    prof_out = {"phase": "stp_profile", "B": STP_B, "T": t, "frames": frames, "steps": STP_PROFILE_STEPS,
                "step_wall_us_untraced": wall_us, "device_us_per_step": device_us,
                "device_idle_share": 1.0 - device_us / wall_us, "device_kernels_per_step": launches / STP_PROFILE_STEPS,
                "by_kind_us": groups, "model_flops": stp_step_flops(config, STP_B, t),
                "model_flops_share_of_bf16_peak_untraced": stp_step_flops(config, STP_B, t) / (wall_us / 1e6)
                / PEAK_FLOPS[torch.bfloat16],
                "pos_conv_alone": pos_conv_ms(task, frames),
                "top_kernels": [{"us": us, "per_step": n, "name": nm} for us, n, nm in top[:15]]}
    emit(prof_out)
    return {"train": out, "profile": prof_out}


def phase_cli_stp(weights: str) -> dict:
    """``run.main`` with ``lightning_datamodule=stp lightning_module=wav2vec2_for_stp
    callbacks=stp_checkpoint logging=csv`` on the synthetic source (16
    utterances: two steps an epoch at batch 8) and the base model through
    the published from_pretrained config reading ``weights``: fit two epochs
    (float32, as the published trainer runs) validating two batches an
    epoch, then test("last") on four batch-1 utterances; then again with
    max_epochs 3, which resumes at epoch 2.  The fit is timed; each test
    batch is split into the eval step (synchronised) and the host decode +
    CER.  The hand-written kernels' counts are read around each run."""
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
        with tempfile.TemporaryDirectory(prefix="vibravox_stp_cli_") as run_dir:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

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
    pad_short = phase_pad_short()
    phase_train_parity()
    train = phase_train()
    train_profile = phase_train_profile()
    evals = phase_eval_parity()
    phase_augment()
    phase_loader(train["step_ms_median"])
    phase_npz()
    cli = phase_cli()
    noisy = phase_cli_noisybwe()
    phase_stp_parity()
    with tempfile.TemporaryDirectory(prefix="vibravox_stp_weights_") as weights:
        stp_weights(weights)
        stp = phase_stp_train(weights)
        cli_stp = phase_cli_stp(weights)
    emit(kernels_line(smi, k1_rows, k2_rows, dft_rows, serve_launches, train, train_profile,
                      evals, cli, noisy, pad_short, stp, cli_stp))
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


def kernels_line(smi, k1_rows, k2_rows, dft_rows, serve_launches, train, train_profile,
                 evals, cli, noisy, pad_short, stp, cli_stp) -> dict:
    """All four kernels.  ``ms``, ``plain_ms``, ``library_ms`` and
    ``bound_ms`` are per train step (batch 32, 2.5 s, bfloat16 networks,
    float32 STFT): each kernel's launches of one step at their shapes,
    measured one by one with CUDA events.  ``launches`` is the count over
    this slice's main path, the CLI's first run (fit and test);
    ``launches_by_path`` has it per path, the timed fit of the train phase
    included, and the STP paths, which run none of the four kernels.  K1's serving numbers (per forward, float32 and bfloat16, 1 s
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
                "cli_stp_resumed": cli_stp["resumed"]["launches"][key]}

    main_path = {k: cli["fit"]["launches"][k] + cli["test"]["launches"][k] for k in ("K1", "K2", "K3", "K4")}
    eval_rows = evals["k1"] + evals["k1_whole_utterance"]

    def k1_eval(rows, what):
        # each stack shape runs twice in a generator forward
        out = summed(rows, (("kernel_ms", "kernel_ms"), ("plain_ms", "plain_ms")), "ops_ms", "bytes_ms", 2)
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
         "max_abs_err": max(r["k3_err_over_scale"] for r in dft_rows + evals["k3"]),
         "max_err_over_tol": max(r["k3_err_over_scale"] / r["k3_tol"] for r in dft_rows + evals["k3"]),
         "ms": k3["kernel_ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "per": "per train step: 3 resolutions x 2 signals, B 32, T 39904, float32",
         "traced_us_per_step": kinds.get("K3 framed_dft_magnitude"), "card": smi, "detail": k3,
         "eval": k3_eval,
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
    ]}


if __name__ == "__main__":
    sys.exit(main())
