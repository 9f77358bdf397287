"""The harness on the CPU: a cell added as files alone runs with no edit of
the harness; each fault a cell can have, planted under a run, turns
``correct`` false; each cell's control fails one of its limits; a fault in
one network shows whatever the size of the other."""

from __future__ import annotations

import json
import shutil
import time

import pytest
import torch

from conftest import ROOT, SEED, cell_named, run_cpu, tiny
from portbench import faults, harness, traffic
from portbench.reference.common import train_numbers

TRAIN = ["eben_train_b32", "w2v2_stp_train_b8"]
# each fault a cell can have: both steps take batches and keep optimizer
# state; only EBEN has two networks and the residual stacks' backward (K2)
CELL_FAULTS = [(name, f) for name in TRAIN for f in ("half_batch", "state_unchanged")] + [
    ("eben_train_b32", "generator_unchanged"), ("eben_train_b32", "k2_dx")]


def test_a_cell_added_as_files_runs_without_editing_the_harness(tmp_path):
    """A throwaway configuration, traffic mix, limits and end-to-end metric,
    each a new file, and their entries in a copy of BENCHMARK.json."""
    for part in ("configs", "traffic", "limits", "metrics", "adapters"):
        shutil.copytree(ROOT / "portbench" / part, tmp_path / "portbench" / part)
    spec = harness.load_spec(ROOT)
    cfg = tiny(harness.resolve(spec, "eben_train_b32", ROOT)).config
    (tmp_path / "portbench/configs/eben_tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench/traffic/tiny_pool.json").write_text(json.dumps(
        {"kind": "train_pool", "batch": 2, "pool_batches": 3, "min_s": 0.25, "max_s": 0.35, "trace_steps": 2}))
    (tmp_path / "portbench/limits/eben_tiny_train.json").write_text(
        (ROOT / "portbench/limits/eben_train_b32.json").read_text())
    (tmp_path / "portbench/metrics/steps_per_s.py").write_text(
        "def read(run):\n    return run.units / run.window_s\n")
    spec["configs"].append({"name": "eben_tiny", "source": "https://example.org/tiny",
                            "file": "portbench/configs/eben_tiny.json", "reduced": ["discriminator"], "why": "t"})
    spec["workloads"].append({"name": "eben_tiny_train", "config": "eben_tiny", "traffic": "tiny_pool",
                              "chips": 1, "why": "t"})
    next(m for m in spec["end_to_end"] if m["name"] == "train_audio_s_per_s")["workloads"].append("eben_tiny_train")
    spec["end_to_end"].append({"name": "steps_per_s", "unit": "steps/s", "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": ["eben_tiny_train"]})
    (tmp_path / "portbench/metrics/steps_done.py").write_text(
        "def read(run):\n    return run.units\n")
    spec["per_layer"].append({"name": "steps_done", "unit": "steps", "better": "higher", "source": "host_clock",
                              "layer": "task step", "moves": "steps_per_s", "workloads": ["eben_tiny_train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.resolve(harness.load_spec(tmp_path), "eben_tiny_train", tmp_path)
    result = harness.run(cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert set(result["metrics"]) == {"steps_per_s", "train_audio_s_per_s", "setup_s"}
    assert result["correct"] and list(result)[-1] == "checks"
    # per-layer readers are read in traced runs, which need the card; the lookup is the same
    assert [m["name"] for m in cell.per_layer][-1] == "steps_done"
    run = harness.Run(units=result["attempted"])
    assert harness.read_metrics(cell, run, per_layer=True)["steps_done"]["value"] == result["attempted"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_sound_train_run_is_correct(name):
    result = run_cpu(tiny(cell_named(name)), seconds=0.5)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name,fault", CELL_FAULTS)
def test_a_train_fault_makes_the_run_incorrect(name, fault):
    with faults.planted(fault):
        result = run_cpu(tiny(cell_named(name)), seconds=0.5)
    assert not result["correct"], result["checks"]


def test_each_network_is_compared_by_its_own_median_leaf():
    """90 generator leaves that never moved beside 93 sound discriminator
    leaves: the median over all leaves would read the sound ones."""
    ref = {**{f"generator.{i}": 1.0 for i in range(90)}, **{f"discriminator.{i}": 1.0 for i in range(93)}}
    got = {n: v for n, v in ref.items() if n.startswith("discriminator.")}
    change = {**got, **{f"generator.{i}": 0.0 for i in range(90)}}
    logs = [{"loss": 1.0}]
    out = train_numbers(logs, logs, got, ref, change, ref, lambda n: n.split(".", 1)[0])
    assert out["grad_norm_gap"] == out["change_norm_gap"] == 1.0
    assert out["grad_norm_gap.discriminator"] == out["change_norm_gap.discriminator"] == 0.0


@pytest.mark.parametrize("name", TRAIN)
def test_the_train_control_fails_a_limit(name):
    """The control, the configuration's precision one step down, at a tiny
    size: EBEN with the program's int8 discriminators, wav2vec2's reference
    with TF32 products."""
    cell = tiny(cell_named(name), float32=False) if name == "eben_train_b32" else tiny(cell_named(name))
    plan = traffic.train_plan(cell.mix, SEED, cell.config["sample_rate"])
    readings = cell.adapter.control_readings(cell.config, plan, SEED, "cpu")
    assert any(readings[n] > limit for n, limit in cell.limits.items()), readings
