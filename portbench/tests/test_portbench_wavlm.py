"""The WavLM cell on the CPU: added as files alone, its adapter loads no JAX
in a fresh process, each of its faults turns ``correct`` false and so does
its control, the attention's bound is no more than the plain reference's
work, and the new readers read nothing where their spans or kernels are
absent."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, SEED, cell_named, run_cpu, tiny
from portbench import harness, phases, spans, trace as tracing, traffic, wavlm_faults
from portbench.count import attention, flops
from portbench.reference import wavlm as ref

CELL = "wavlm_large_stp_train_b8_long"
NEW_METRICS = ("attention_ms_per_step.train", "gated_bias_ms_per_step.train", "attention_roofline.train")


def tiny_wavlm() -> harness.Cell:
    """The cell at the port's tiny wav2vec2 widths (``conftest.tiny``), 3
    layers, and a bucket reach short enough that 0.5-1 s (24-49 frames)
    passes its clamp."""
    cell = tiny(cell_named(CELL))
    cell.config["model"].update(num_hidden_layers=3, num_buckets=32, max_bucket_distance=20)
    return cell


def test_the_cell_is_files_and_entries_alone():
    spec = harness.load_spec(ROOT)
    cell = cell_named(CELL)
    assert cell.config["adapter"] == "wavlm_large_ctc" and cell.config["reduced"] == []
    assert cell.mix["kind"] == "train_pool" and cell.workload["chips"] == 1
    assert {m["name"] for m in cell.end_to_end} == {"train_audio_s_per_s", "setup_s"}
    layer = {m["name"] for m in cell.per_layer}
    assert set(NEW_METRICS) | {"train_mfu", "conv_ms_per_step.train", "device_idle.train",
                               "forward_ms_per_step.train", "backward_ms_per_step.train",
                               "optimizer_ms_per_step.train"} == layer
    for name in NEW_METRICS:
        assert (ROOT / "portbench" / "metrics" / f"{name}.py").is_file()
    # every batch pads to 20 s: 999 frames, past the 800-frame bucket clamp
    plan = traffic.train_plan(cell.mix, SEED, cell.config["sample_rate"])
    assert set(plan.widths) == {320000} and set(plan.label_width) == {256}
    assert ref.WavLMRefConfig.of(cell.config["model"]).frames(320000) == 999
    assert spec["workloads"][-1]["name"] == CELL


def test_the_adapter_loads_no_jax_in_a_fresh_process():
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})\n"
            "from conftest import cell_named\n"
            f"cell_named({CELL!r})\n"
            "from portbench import harness\n"
            "print(json.dumps({'forbidden': harness.forbidden_modules(),"
            " 'program': 'vibravox_tpu_torch.models.wavlm' in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == {"forbidden": [], "program": True}


def test_a_sound_run_is_correct():
    result = run_cpu(tiny_wavlm(), seconds=0.3)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", wavlm_faults.FAULTS)
def test_a_fault_makes_the_run_incorrect(fault):
    with wavlm_faults.planted(fault):
        result = run_cpu(tiny_wavlm(), seconds=0.3)
    assert not result["correct"], result["checks"]


def test_the_control_fails_a_limit():
    cell = tiny_wavlm()
    plan = traffic.train_plan(cell.mix, SEED, cell.config["sample_rate"])
    readings = cell.adapter.control_readings(cell.config, plan, SEED, "cpu")
    assert any(readings[n] > limit for n, limit in cell.limits.items()), readings


@pytest.mark.parametrize("b,h,t,d", [(8, 16, 999, 64), (2, 2, 49, 16), (1, 4, 300, 32)])
def test_the_attention_bound_is_at_most_the_plain_work(b, h, t, d):
    """The bound counts 6 products of 2 B H T^2 d; the plain attention's
    forward and backward, counted on the meta device, has them and more
    (the gate's product, the bias); its bytes are no fewer."""
    q, k, v = (torch.empty(b, h, t, d, device=flops.META, requires_grad=True) for _ in range(3))
    table = torch.empty(h, t, t, device=flops.META, requires_grad=True)
    gate = torch.empty(b, h, t, 1, device=flops.META, requires_grad=True)

    def plain():
        scores = torch.matmul(q, k.transpose(-1, -2)) / d ** 0.5 + gate * table
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        torch.autograd.grad(out.sum(), [q, k, v, table, gate])

    ops, nbytes = attention.work(b, h, t, d, torch.float32)
    assert ops == flops.counted(plain)
    assert nbytes <= 4 * (b * h * t * t + 8 * b * h * t * d + 2 * h * t * t + 2 * b * h * t)
    assert attention.bound_s(b, h, t, d, torch.float32) == max(ops / 495e12, nbytes / 3.35e12)


def _kernel(name: str, start: float, end: float) -> tracing.Kernel:
    return tracing.Kernel(name, tracing.kernel_kind(name), start, end)


def test_the_readers_read_their_kernels_and_spans():
    """Two launches under ``wavlm.gate``, one under ``stp.forward`` alone;
    the device trace holds one attention kernel and the copy of a span."""
    host = [(0.0, 100.0, "stp.forward"), (10.0, 20.0, "wavlm.gate"), (30.0, 40.0, "wavlm.relpos"),
            (12.0, 13.0, "cudaLaunchKernel"), (32.0, 33.0, "cudaLaunchKernel"), (50.0, 51.0, "cudaLaunchKernel")]
    kernels = [_kernel("elementwise_kernel", 200.0, 203.0), _kernel("gemm_kernel", 210.0, 215.0),
               _kernel("fmha_cutlassF_f32_aligned_64x64_rf_sm80", 220.0, 260.0), _kernel("wavlm.gate", 200, 215)]
    host_trace = tracing.Trace(kernels, 1.0, 1, 1, host)
    device_trace = tracing.Trace(kernels, 1.0, 1, 1)
    assert spans.launched_s(host_trace, spans.GATED_BIAS) == pytest.approx(8e-6)
    assert phases.ms_per_step(harness.Run(host_trace=host_trace), "forward") == pytest.approx(48e-3)
    run = harness.Run(trace=device_trace, host_trace=host_trace, bounds_s={"attention": 4e-6})
    cell = dataclasses.replace(cell_named(CELL))
    got = {n: v["value"] for n, v in harness.read_metrics(cell, run, per_layer=True).items()}
    assert got["attention_ms_per_step.train"] == pytest.approx(40e-3)
    assert got["gated_bias_ms_per_step.train"] == pytest.approx(8e-3)
    assert got["attention_roofline.train"] == pytest.approx(10.0)


def test_the_readers_read_nothing_where_their_spans_or_kernels_are_absent():
    """The parent's program (no WavLM spans) or a cell with no attention
    kernel: the metrics are left out, and nothing raises."""
    host = [(0.0, 100.0, "stp.forward"), (12.0, 13.0, "cudaLaunchKernel")]
    kernels = [_kernel("gemm_kernel", 200.0, 205.0)]
    run = harness.Run(trace=tracing.Trace(kernels, 1.0, 1, 1), host_trace=tracing.Trace(kernels, 1.0, 1, 1, host))
    for name in NEW_METRICS:
        assert harness.reader(ROOT, name).read(run) is None
        assert harness.reader(ROOT, name).read(harness.Run()) is None
