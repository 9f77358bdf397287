#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check every kernel on its path.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
The kernels build from ``vibravox_tpu_torch/ops/csrc`` at first use.  Phases
(one JSON line each; any failure raises and exits non-zero):

1. device: the card's name and power limit as nvidia-smi reports them;
2. build: every kernel source (K1; K2; K3 and K4), one nvcc each, all
   started together, with the nvcc time and the ptxas resource report of
   each kernel;
3. k1_parity: the fused residual stack (K1) against its plain PyTorch version
   at the serving shapes in float32 (atol 2e-5 of scale, TF32 off for the
   plain convolutions) and bfloat16 (2e-2 of scale), plus ragged T = 1001 and
   the short T = 40, with kernel and plain times by CUDA events;
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
   at the same shapes; K1 and K2 times;
8. k3_k4_parity: the framed-DFT magnitude (K3) and its backward (K4)
   against ``torch.stft`` and its autograd at B = 32, T = 39904, the three
   loss resolutions, and at a ragged T, B = 1, T just above fft / 2 and
   hops below 32; K4 bit-equal over two runs; kernel, plain, library and
   bound times of whole wrapper calls, in turns;
9. train_parity: one seeded float32 train step at small sizes on the card
   (K1-K4) against the same step on the CPU (the plain versions);
10. train: the training path.  ``Trainer.fit`` of the full ``eben.yaml``
    task at batch 32 on 2.5 s synthetic crops, bfloat16; the counts are
    reset after a warm-up fit and must equal 6 launches per step for each
    of K1-K4 over the timed fit;
11. train_profile: the untraced train-step wall, its device time by kernel
    kind from a CUDA-only trace, and the idle share;
12. the ``kernels`` line (all four kernels), then the result line.

Phases 3 and 7 change PyTorch's precision settings, and only around the
comparison; the other phases run the port as a user calls it.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from vibravox_tpu_torch.core.loop import Trainer
from vibravox_tpu_torch.core.optim import adam, sgd
from vibravox_tpu_torch.data.bwe import BWEDataModule
from vibravox_tpu_torch.device import strict_float32
from vibravox_tpu_torch.losses.gan import FeatureMatchingLoss, HingeLoss
from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
from vibravox_tpu_torch.models.eben_generator import EBENGenerator
from vibravox_tpu_torch.ops import _build
from vibravox_tpu_torch.ops.fused_residual import (
    plain_residual_stack,
    plain_residual_stack_backward,
    residual_stack,
    residual_stack_backward,
)
from vibravox_tpu_torch.ops.pallas_stft import (
    framed_dft_backward,
    framed_dft_magnitude,
    hann_window,
    plain_framed_dft_backward,
    plain_framed_dft_magnitude,
)
from vibravox_tpu_torch.ops.stft import MultiResolutionSTFTLoss
from vibravox_tpu_torch.serving import EnhanceServer
from vibravox_tpu_torch.tasks.eben import EBENTask

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12

BATCH = 8  # serving max_batch
# (stacks, C, T) of the 1 s serving bucket: T = 15840 samples -> 3968 PQMF frames
SERVING_SHAPES = (("enc_0,dec_2", 32, 3968), ("enc_1,dec_1", 64, 1984), ("enc_2,dec_0", 128, 496))
EXTRA_SHAPES = ((3, 64, 1001), (2, 32, 40), (2, 128, 40))  # (B, C, T)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
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


def phase_build() -> None:
    """Every kernel source, one nvcc each, all started together."""
    t0 = time.perf_counter()
    infos = _build.build_all(_build.SOURCES)
    wall = time.perf_counter() - t0
    for name, info in infos.items():
        emit({"phase": "build", "source": name, "wall_seconds_all_sources": wall,
              "nvcc_seconds": info["seconds"],
              "ptxas": [ln.strip() for ln in info["ptxas"].splitlines()
                        if any(w in ln for w in ("Compiling entry", "Used", "spill"))]})


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
                       "max_abs_err": err, "scale": scale, "tol": TOL[dtype] * scale}
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
    from torch.profiler import ProfilerActivity, profile

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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n_fwd):
                model(x)
            torch.cuda.synchronize()
    groups: dict = {}
    top = []
    launches = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        launches += e.count
        us = e.self_device_time_total / n_fwd
        name = e.key
        kind = ("K1 fused_residual" if "residual_stack_kernel" in name
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


def phase_k2_parity() -> list:
    """K2 against autograd of the plain stack at the training shapes (B = 32)
    and short and ragged T, float32 (the plain side's convolutions in IEEE
    float32) and bfloat16 (against the plain version in float32 on the same
    bf16 values); dW bit-equal across two runs; K1 against its plain version
    at the same shapes and tolerances as in phase_k1_parity; K1 and K2 times
    at the training shapes beside the plain versions'."""
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
                row.update(k1_max_abs_err=err1, k1_scale=scale1, k1_tol=TOL[dtype] * scale1)
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
                    row.update(kernel_ms=float(np.median(k2)), plain_ms=float(np.median(p2)),
                               ops_ms=ops_ms, bytes_ms=bytes_ms,
                               k1_kernel_ms=float(np.median(k1)), k1_plain_ms=float(np.median(p1)),
                               k1_ops_ms=ops1, k1_bytes_ms=bytes1)
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
# and near silence (x scaled by 1e-7) over `silence` samples from T / 3,
# longer than the window, so whole frames clamp at eps and K4's gom is 0 there
K3_K4_EXTRA = ((3, 4001, 512, 50, 240, 0), (1, 7777, 1024, 120, 600, 0), (2, 1025, 2048, 240, 1200, 0),
               (2, 3000, 512, 16, 240, 0), (1, 700, 256, 1, 200, 0), (2, 12000, 512, 50, 240, 2048),
               (2, 12000, 2048, 240, 1200, 4800), (2, 6000, 256, 16, 200, 1024))


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
                      sync_every_step=True)
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


def phase_train_profile() -> dict:
    """Where a train step's time goes (full task, batch 32, bf16): the wall
    of PROFILE_STEPS steps run back to back with no tracing on one device
    batch, the device time of as many more by kernel kind from a CUDA-only
    torch.profiler trace, and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            task.train_step(state, batch)
        torch.cuda.synchronize()
    groups: dict = {}
    top = []
    launches = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        launches += e.count
        us = e.self_device_time_total / PROFILE_STEPS
        name = e.key
        low = name.lower()
        kind = ("K1 fused_residual" if "residual_stack_kernel" in name
                else "K2 fused_residual_bwd" if any(s in name for s in (
                    "unit_forward_kernel", "unit_backward_kernel", "reduce_partials_kernel"))
                else "K3 framed_dft_magnitude" if "framed_dft_magnitude_kernel" in name
                else "K4 framed_dft_backward" if "framed_dft_backward" in name  # both passes
                else "cuDNN conv / GEMM" if any(s in low for s in ("conv", "gemm", "xmma", "cudnn", "sm90"))
                else "other")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    k1_rows = phase_k1_parity()
    phase_generator_parity()
    serve_launches = phase_serve(None) + phase_serve("bfloat16")
    phase_profile()
    k2_rows = phase_k2_parity()
    dft_rows = phase_k3_k4_parity()
    phase_train_parity()
    train = phase_train()
    train_profile = phase_train_profile()
    emit(kernels_line(smi, k1_rows, k2_rows, dft_rows, serve_launches, train, train_profile))
    emit({"phase": "done", "wall_seconds": time.perf_counter() - t_start})
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _per_step(rows, dtype, kernel_key, plain_key, ops_key, bytes_key, launches_per_shape=2):
    """Sum over the train step's shapes of one launch each, times the
    launches of each shape per step (each residual shape runs twice)."""
    rows = [r for r in rows if kernel_key in r and r["dtype"] == dtype]
    out = {k: launches_per_shape * sum(r[src] for r in rows) for k, src in
           (("kernel_ms", kernel_key), ("plain_ms", plain_key), ("ops_ms", ops_key),
            ("bytes_ms", bytes_key))}
    out["bound_ms"], out["bound_by"] = bound(out["ops_ms"], out["bytes_ms"])
    return out


def kernels_line(smi, k1_rows, k2_rows, dft_rows, serve_launches, train, train_profile) -> dict:
    """All four kernels.  ``ms``, ``plain_ms``, ``library_ms`` and
    ``bound_ms`` are per train step of the main path (batch 32, 2.5 s,
    bfloat16 networks, float32 STFT): each kernel's launches of one step at
    their shapes, measured one by one with CUDA events; ``launches`` is the
    count over the timed fit's steps.  K1's serving numbers (per forward,
    float32, 1 s bucket, batch 8) stay beside them."""
    per_step = train["launches_per_step"]
    kinds = train_profile["by_kind_us"]
    rows = [r for r in k1_rows if "kernel_ms" in r and r["dtype"] == "float32"]
    k1_serve = {k: 2 * sum(r[k] for r in rows) for k in ("kernel_ms", "plain_ms", "ops_ms", "bytes_ms")}
    k1_serve["bound_ms"], k1_serve["bound_by"] = bound(k1_serve["ops_ms"], k1_serve["bytes_ms"])
    k1_serve["launches"] = serve_launches
    k1 = {dt: _per_step(k2_rows, dt, "k1_kernel_ms", "k1_plain_ms", "k1_ops_ms", "k1_bytes_ms")
          for dt in ("bfloat16", "float32")}
    k2 = {dt: _per_step(k2_rows, dt, "kernel_ms", "plain_ms", "ops_ms", "bytes_ms")
          for dt in ("bfloat16", "float32")}

    def dft(prefix, signals):
        out = {k: signals * sum(r[f"{prefix}_{src}"] for r in dft_rows) for k, src in
               (("kernel_ms", "ms"), ("plain_ms", "plain_ms"), ("library_ms", "library_ms"),
                ("ops_ms", "ops_ms"), ("bytes_ms", "bytes_ms"))}
        out["bound_ms"], out["bound_by"] = bound(out["ops_ms"], out["bytes_ms"])
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
         "launches": train["launches"]["K1"], "launches_per_step": per_step["K1"],
         "max_abs_err": max([r["max_abs_err"] for r in k1_rows if r["dtype"] == "float32"]
                            + [r["k1_max_abs_err"] for r in k2_rows if r["dtype"] == "float32"]),
         "max_err_over_tol": max([r["max_abs_err"] / r["tol"] for r in k1_rows]
                                 + [r["k1_max_abs_err"] / r["k1_tol"] for r in k2_rows]),
         "ms": k1["bfloat16"]["kernel_ms"], "plain_ms": k1["bfloat16"]["plain_ms"],
         "bound_ms": k1["bfloat16"]["bound_ms"], "bound_by": k1["bfloat16"]["bound_by"],
         "library_ms": None, "per": step, "traced_us_per_step": kinds.get("K1 fused_residual"),
         "card": smi, "train": k1, "serve_per_forward_float32": k1_serve},
        {"name": "fused_residual_stack_backward", "route": "cuda",
         "source": "vibravox_tpu_torch/ops/csrc/fused_residual_bwd.cu",
         "replaces": "vibravox_tpu/ops/fused_residual.py:193",
         "launches": train["launches"]["K2"], "launches_per_step": per_step["K2"],
         "max_abs_err": max(r["dx_err_over_scale"] for r in k2_rows if r["dtype"] == "float32"),
         "max_err_over_tol": max(k2_errs),
         "ms": k2["bfloat16"]["kernel_ms"], "plain_ms": k2["bfloat16"]["plain_ms"],
         "bound_ms": k2["bfloat16"]["bound_ms"], "bound_by": k2["bfloat16"]["bound_by"],
         "library_ms": None, "per": step, "traced_us_per_step": kinds.get("K2 fused_residual_bwd"),
         "card": smi, "train": k2,
         "errors": "max_abs_err is dx's error over the largest |dx| (float32)"},
        {"name": "framed_dft_magnitude", "route": "cuda",
         "source": "vibravox_tpu_torch/ops/csrc/framed_dft.cu",
         "replaces": "vibravox_tpu/ops/pallas_stft.py:101",
         "launches": train["launches"]["K3"], "launches_per_step": per_step["K3"],
         "max_abs_err": max(r["k3_err_over_scale"] for r in dft_rows),
         "max_err_over_tol": max(r["k3_err_over_scale"] / r["k3_tol"] for r in dft_rows),
         "ms": k3["kernel_ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "per": "per train step: 3 resolutions x 2 signals, B 32, T 39904, float32",
         "traced_us_per_step": kinds.get("K3 framed_dft_magnitude"), "card": smi, "detail": k3,
         "errors": "max_abs_err is the error over the largest magnitude"},
        {"name": "framed_dft_magnitude_backward", "route": "cuda",
         "source": "vibravox_tpu_torch/ops/csrc/framed_dft.cu",
         "replaces": "vibravox_tpu/ops/pallas_stft.py:178",
         "launches": train["launches"]["K4"], "launches_per_step": per_step["K4"],
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
