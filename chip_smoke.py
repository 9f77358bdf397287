#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check every kernel on its path.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
The kernels build from ``vibravox_tpu_torch/ops/csrc`` at first use.  Phases
(one JSON line each; any failure raises and exits non-zero):

1. device: the card's name and power limit as nvidia-smi reports them;
2. build: nvcc time and the ptxas resource report of each kernel;
3. k1_parity: the fused residual stack (K1) against its plain PyTorch version
   at the serving shapes in float32 (atol 2e-5 of scale, TF32 off for the
   plain convolutions) and bfloat16 (2e-2 of scale), plus ragged T = 1001 and
   the short T = 40, with kernel and plain times by CUDA events;
4. generator_parity: the full-width EBEN generator on the card against the
   same weights on the CPU, float32, atol 1e-4, at PyTorch's default TF32
   settings: the generator itself keeps its convolutions in IEEE float32;
5. serve: the main path.  ``EnhanceServer`` with the full-width generator,
   a 1 s bucket and max_batch 8 answers 64 requests, in float32 and in
   bfloat16; the K1 launch count is reset just before the requests and must
   equal 6 per batched forward; one served request must equal the direct
   forward of the same padded batch;
6. profile: the wall time of a batched float32 forward without any tracing,
   its device time by kernel kind from a CUDA-only torch.profiler trace, and
   the device's idle share from the two;
7. the ``kernels`` line, then the result line.

Only phase 3 changes PyTorch's precision settings, and only around the
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

from vibravox_tpu_torch.device import strict_float32
from vibravox_tpu_torch.models.eben_generator import EBENGenerator
from vibravox_tpu_torch.ops import _build
from vibravox_tpu_torch.ops.fused_residual import plain_residual_stack, residual_stack
from vibravox_tpu_torch.serving import EnhanceServer

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
    t0 = time.perf_counter()
    info = _build.build("fused_residual")
    emit({"phase": "build", "source": "fused_residual", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info["seconds"],
          "ptxas": [ln.strip() for ln in info["ptxas"].splitlines()
                    if "Used" in ln or "spill" in ln]})


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    smi = phase_device()
    phase_build()
    k1_rows = phase_k1_parity()
    phase_generator_parity()
    launches = phase_serve(None) + phase_serve("bfloat16")
    phase_profile()

    # one generator forward at the serving bucket runs each serving shape twice
    per_fwd = {}
    for dtype in ("float32", "bfloat16"):
        rows = [r for r in k1_rows if "kernel_ms" in r and r["dtype"] == dtype]
        per_fwd[dtype] = {k: 2 * sum(r[k] for r in rows)
                          for k in ("kernel_ms", "plain_ms", "ops_ms", "bytes_ms")}
        per_fwd[dtype]["bound_ms"], per_fwd[dtype]["bound_by"] = bound(
            per_fwd[dtype]["ops_ms"], per_fwd[dtype]["bytes_ms"])
        per_fwd[dtype]["shapes"] = [
            {k: r[k] for k in ("stacks", "B", "C", "T", "kernel_ms", "plain_ms", "bound_ms",
                               "bound_by", "max_abs_err", "tol")} for r in rows]
    f32 = per_fwd["float32"]
    emit({"kernels": [{
        "name": "fused_residual_stack",
        "route": "cuda",
        "source": "vibravox_tpu_torch/ops/csrc/fused_residual.cu",
        "replaces": "vibravox_tpu/ops/fused_residual.py:140",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in f32["shapes"]),
        "max_err_over_tol": max(r["max_abs_err"] / r["tol"] for r in f32["shapes"]),
        "ms": f32["kernel_ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": None,
        "per_forward": "6 launches, 1 s bucket, batch 8, float32",
        "card": smi,
        "detail": per_fwd,
    }]})
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
