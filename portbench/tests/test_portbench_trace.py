"""Kernels put down to the phase spans that launched them
(``portbench/phases.py``), on synthetic traces: the launch's time decides,
not the kernel's interval on the device nor the launching thread; a launch
outside every phase is unattributed; the readers report nothing on a trace
without the port's spans."""

from __future__ import annotations

import pytest

from conftest import ROOT
from portbench import harness, phases
from portbench.trace import Kernel, Trace

READERS = ["forward_ms_per_step.train", "backward_ms_per_step.train", "optimizer_ms_per_step.train",
           "balancing_ms_per_step.train"]


def _trace(host, kernels, units=1):
    return Trace([Kernel(n, "k", s, e) for n, s, e in kernels], 1.0, units, 1, host)


def _lead(host, kernels):
    """The trace's lead: launch calls before the steps', and no kernel of
    theirs (``trace.py`` drops the lead's kernels)."""
    return [(0.0, 1.0, "cudaLaunchKernel"), (1.0, 2.0, "cudaLaunchKernel")] + host, kernels


def test_a_kernel_is_put_down_to_the_phase_that_launched_it():
    """The device runs behind: the forward's kernel runs while the host is in
    the backward, and is still the forward's."""
    host, kernels = _lead([
        (10, 100, "portbench.train_step"), (11, 99, "eben.train_step"),
        (12, 40, "eben.generator.forward"), (20, 21, "cudaLaunchKernel"),
        (40, 90, "eben.generator.backward"), (50, 51, "cudaLaunchKernel"),
    ], [("fwd", 45, 60), ("bwd", 60, 62)])
    spans = phases.by_span_s(_trace(host, kernels))
    assert spans == pytest.approx({"eben.generator.forward": 15e-6, "eben.generator.backward": 2e-6})


def test_a_launch_from_the_autograd_thread_goes_to_the_callers_backward():
    """The engine's thread launches while the caller waits in ``backward()``:
    its operator overlaps the caller's span on another thread."""
    host, kernels = _lead([
        (10, 100, "portbench.train_step"), (11, 30, "stp.forward"), (15, 16, "cudaLaunchKernel"),
        (30, 80, "stp.backward"), (31, 79, "aten::to"),
        (40, 60, "autograd::engine::evaluate_function: ConvolutionBackward0"),
        (41, 59, "aten::convolution_backward"), (45, 46, "cudaLaunchKernel"), (50, 51, "cudaMemsetAsync"),
        (80, 95, "stp.optimizer"), (85, 86, "cuLaunchKernelEx"),
    ], [("f", 20, 25), ("dgrad", 47, 57), ("memset", 57, 58), ("adam", 90, 91)])
    spans = phases.by_span_s(_trace(host, kernels))
    assert spans == pytest.approx({"stp.forward": 5e-6, "stp.backward": 11e-6, "stp.optimizer": 1e-6})


def test_a_launch_outside_every_phase_is_unattributed_and_the_parts_sum_to_the_whole():
    host, kernels = _lead([
        (10, 100, "portbench.train_step"), (11, 12, "cudaMemcpyAsync"), (12, 99, "eben.train_step"),
        (13, 40, "eben.generator.forward"), (14, 15, "cudaLaunchKernel"),
        (41, 42, "cudaLaunchKernel"),  # between two phases
        (42, 60, "eben.generator.balancing"), (43, 44, "cudaLaunchKernel"),
    ], [("copy", 12, 13), ("a", 16, 20), ("b", 43, 50), ("c", 50, 52)])
    trace = _trace(host, kernels)
    spans = phases.by_span_s(trace)
    assert spans == pytest.approx({phases.UNATTRIBUTED: 8e-6, "eben.generator.forward": 4e-6,
                                   "eben.generator.balancing": 2e-6})
    assert sum(spans.values()) == pytest.approx(sum(k.end_us - k.start_us for k in trace.kernels) / 1e6)


def test_the_profilers_copies_of_host_ranges_are_no_kernels():
    """The profiler copies each innermost range onto the device's timeline
    under the range's name; a trace that lost its first kernel keeps the
    calls it has matched from the end."""
    host, kernels = _lead([
        (10, 100, "portbench.train_step"), (11, 40, "eben.generator.forward"), (12, 13, "cudaLaunchKernel"),
        (14, 15, "cudaLaunchKernel"), (40, 90, "eben.generator.backward"), (41, 42, "cudaLaunchKernel"),
    ], [("eben.generator.forward", 20, 31), ("b", 30, 31), ("c", 50, 53), ("eben.generator.backward", 50, 53)])
    trace = _trace(host, kernels)
    assert [k.name for k in phases.kernels(trace)] == ["b", "c"]
    assert phases.by_span_s(trace) == pytest.approx({"eben.generator.forward": 1e-6,
                                                     "eben.generator.backward": 3e-6})


def _run(host, kernels, units):
    return harness.Run(host_trace=_trace(host, kernels, units))


@pytest.mark.parametrize("metric", READERS)
def test_each_reader_reports_nothing_without_the_ports_spans(metric):
    """The parent's program opens no phase span: its traced runs leave the
    metrics out."""
    host = [(10, 100, "portbench.train_step"), (11, 99, "aten::conv1d"), (20, 21, "cudaLaunchKernel")]
    read = harness.reader(ROOT, metric).read
    assert read(_run(host, [("k", 30, 40)], 1)) is None
    assert read(harness.Run()) is None


def test_the_readers_sum_their_phases_a_step():
    host = [(10, 200, "portbench.train_step")]
    kernels = []
    for i, name in enumerate(["eben.generator.forward", "eben.generator.balancing", "eben.generator.backward",
                              "eben.generator.optimizer", "eben.discriminator.forward",
                              "eben.discriminator.backward", "eben.discriminator.optimizer"]):
        start = 20 + 20 * i
        host += [(start, start + 20, name), (start + 1, start + 2, "cudaLaunchKernel")]
        kernels.append((f"k{i}", 300 + 10 * i, 300 + 10 * i + (i + 1)))  # i + 1 us each
    run = _run(host, kernels, 2)
    got = {m.split("_ms")[0]: harness.reader(ROOT, m).read(run) for m in READERS}
    assert got == pytest.approx({"forward": (1 + 5) / 2e3, "balancing": 2 / 2e3, "backward": (3 + 6) / 2e3,
                                 "optimizer": (4 + 7) / 2e3})


def test_the_phase_times_tool_splits_a_step_by_phase_network_and_kind():
    tool = harness._load(ROOT / "portbench" / "tools" / "phase_times.py", "portbench_tool_phase_times")
    host, kernels = _lead([
        (10, 100, "portbench.train_step"), (11, 30, "eben.generator.forward"), (12, 13, "cudaLaunchKernel"),
        (30, 60, "eben.generator.backward"), (31, 32, "cudaLaunchKernel"),
        (60, 90, "eben.discriminator.backward"), (61, 62, "cudaLaunchKernel"), (95, 96, "cudaLaunchKernel"),
    ], [("a", 20, 24), ("b", 40, 42), ("c", 65, 71), ("d", 97, 98)])
    got = tool.readings(_trace(host, kernels, units=2))
    assert got["total_ms"] == pytest.approx(13 / 2e3)
    assert got["unattributed_share"] == pytest.approx(1 / 13)
    assert got["phases_ms"] == pytest.approx({"forward": 2e-3, "backward": 4e-3})
    assert got["networks_ms"] == pytest.approx({"eben.generator": 3e-3, "eben.discriminator": 3e-3,
                                                phases.UNATTRIBUTED: 0.5e-3})
    assert got["kinds_ms"]["eben.discriminator.backward"] == pytest.approx({"k": 3e-3})
    # gaps 24-40 and 42-65 (the host in the generator's backward at their middles), 71-97 (the discriminator's)
    assert got["idle_ms"] == pytest.approx({"eben.generator.backward": 19.5e-3, "eben.discriminator.backward": 13e-3})
