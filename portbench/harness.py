"""The harness: finds a cell's files by name, runs its window, reads its metrics.

Everything that belongs to one cell is data or a file of its own, found by
the names in ``BENCHMARK.json``:

* ``configs/<config>.json`` (the path the config's ``file`` gives): sizes,
  dtypes, and ``adapter``, the module ``adapters/<adapter>.py`` that builds
  the program's step or server for it and checks them against the plain
  reference;
* ``traffic/<mix>.json``: the mix's parameters, read by ``traffic.py``;
  its ``kind`` picks the window, and ``train_pool`` (train steps back to
  back) is the one there is;
* ``limits/<workload>.json``: each compared number's limit;
* ``metrics/<metric>.py``: one reader per metric, end-to-end or per layer,
  ``read(run) -> float | None`` over the ``Run`` below.  A reader that finds
  nothing to read returns None and the metric is left out.

A train window drives the session's step until ``seconds`` have passed on
the host clock, then synchronises: the rate is all the audio of the steps
done over all that time.  A traced run then profiles a fixed number of
steps with the device's activity alone, and a few more with the host's.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

import torch

from portbench import traffic, trace as tracing
from portbench.count.bounds import peak_flops

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vibravox_tpu")
HOST_TRACE_UNITS = 2


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, float]
    adapter: ModuleType
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    root: Path


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0  # steps done
    audio_s: float = 0.0  # audio consumed by the steps done
    unit_flops: Optional[float] = None  # model FLOP of a train step
    peak_flops: float = 0.0
    trace: Optional[tracing.Trace] = None  # device activity alone
    host_trace: Optional[tracing.Trace] = None  # with the host's activity
    bounds_s: Dict[str, float] = dataclasses.field(default_factory=dict)  # per kernel kind, over the trace


def load_spec(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _module_name(kind: str, name: str) -> str:
    return f"portbench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)


def resolve(spec: Dict[str, Any], workload: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[workload]
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "portbench" / "limits" / f"{workload}.json").read_text())
    adapter = _load(root / "portbench" / "adapters" / f"{config['adapter']}.py",
                    _module_name("adapter", config["adapter"]))

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    e2e = [m for m in spec["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if mine(m) and m["moves"] in reported]
    return Cell(workload, w, config, mix, limits, adapter, e2e, layer, root)


@functools.lru_cache(maxsize=None)
def reader(root: Path, metric: str) -> ModuleType:
    return _load(root / "portbench" / "metrics" / f"{metric}.py", _module_name("metric", metric))


def read_metrics(cell: Cell, run: Run, per_layer: bool) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in (cell.per_layer if per_layer else cell.end_to_end):
        value = reader(cell.root, m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({n for n in list(sys.modules) if n.split(".", 1)[0] in FORBIDDEN})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _settle() -> None:
    """The end of set-up: what set-up made moves out of the collector's
    reach (``gc.freeze``), so that a collection in the window scans only
    the window's own objects and does not stall it for the whole heap."""
    gc.collect()
    gc.freeze()


def _stage(name: str, since: float) -> float:
    """Reports a set-up stage's seconds on standard error; returns now."""
    now = time.perf_counter()
    print(f"setup {name} {now - since:.3f} s", file=sys.stderr, flush=True)
    return now


def run_train(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device, t_start: float):
    t = _stage("imports", t_start)
    plan = traffic.train_plan(cell.mix, seed, cell.config["sample_rate"])
    session = cell.adapter.TrainSession(cell.config, plan, seed, device)
    _sync(device)
    t = _stage("weights, program and pool", t)
    done = session.start()  # the checked steps: the first of the set-up's work on the window's call
    _sync(device)
    _settle()
    _stage("checked steps", t)
    run = Run(peak_flops=peak_flops(session.dtype))
    run.setup_s = time.perf_counter() - t_start
    pool = len(session.batches)
    i, audio = done, 0.0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        session.step(i % pool)
        audio += session.audio_s[i % pool]
        i += 1
    _sync(device)
    run.window_s = time.perf_counter() - t0
    run.units, run.audio_s = i - done, audio
    memory = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if traced:
        run.unit_flops = session.step_flops()
        steps = int(cell.mix["trace_steps"])
        state = {"i": i}

        def one():
            with torch.profiler.record_function("portbench.train_step"):
                session.step(state["i"] % pool)
            state["i"] += 1

        run.trace = tracing.trace_calls(one, steps, device)
        run.host_trace = tracing.trace_calls(one, HOST_TRACE_UNITS, device, host=True)
        run.bounds_s = {k: v * steps for k, v in session.kernel_bounds_s().items()}
    session.free()
    checks = session.check()
    return run, checks, memory, run.units


# --------------------------------------------------------------------------- #
# A run
# --------------------------------------------------------------------------- #


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device, t_start: float) -> Dict[str, Any]:
    """One run of ``cell``: the result line's object, ``checks`` last."""
    kind = cell.mix["kind"]
    if kind != "train_pool":
        raise ValueError(f"unknown traffic kind {kind!r}")
    r, checks, memory, attempted = run_train(cell, seed, seconds, traced, device, t_start)
    # each number with a limit is compared; the others are kept as readings
    compared = {n: {"value": float(checks.get(n, float("inf"))), "limit": float(limit)}
                for n, limit in cell.limits.items()}
    readings = {n: float(v) for n, v in checks.items() if n not in cell.limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    result: Dict[str, Any] = {
        "correct": bool(correct), "attempted": int(attempted), "failed": 0,
        "metrics": read_metrics(cell, r, per_layer=traced),
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory)},
    }
    if traced and r.trace is not None:
        result["device"]["busy_s"] = r.trace.busy_s()
        result["device"]["window_s"] = r.trace.wall_s
        result["breakdown"] = {"device_ops": [[k, v] for k, v in tracing.top_kinds(r.trace)],
                               "idle_gaps": [[k, v] for k, v in tracing.idle_gaps(r.host_trace)]
                               if r.host_trace is not None else []}
    result["readings"] = readings
    result["checks"] = compared
    return result
