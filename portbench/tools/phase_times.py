"""Device and idle milliseconds a train step by phase of the port's step.

    python3 portbench/tools/phase_times.py --workload <name> --seeds 1,2 [--traces 3]

For each seed: the cell's set-up as a run makes it (weights, pool, the
checked steps) and a few steps more, then ``--traces`` traces of two steps
with the host's activity, as a ``--trace 1`` run takes its host trace.  For
each trace, one JSON line on standard output (``portbench/phases.py``):

* ``device_ms``: the kernels' device ms a step by the phase span that
  launched them (``unattributed``: outside every phase), ``total_ms`` their
  sum, ``phases_ms`` by metric (``forward``, ``balancing``, ``backward``,
  ``optimizer``) and ``networks_ms`` by network (the span's first two words);
* ``kinds_ms``: each phase span's kernels by kind (``trace.py``);
* ``idle_ms``: the device's idle gaps a step by the phase span open on the
  host at each gap's middle; the host's profiling stretches them.

Benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

WARM_STEPS = 5


def _per_step(seconds: dict, units: int) -> dict:
    return {k: 1e3 * v / units for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])}


def readings(trace) -> dict:
    from portbench import phases

    pairs = phases.attributed(trace)
    if pairs is None:
        raise RuntimeError("the trace holds no phase span: the program's steps open none")
    kinds = {}
    for k, name in pairs:
        by_kind = kinds.setdefault(name, {})
        by_kind[k.kind] = by_kind.get(k.kind, 0.0) + (k.end_us - k.start_us) / 1e6
    spans = {name: sum(by_kind.values()) for name, by_kind in kinds.items()}
    networks = {}
    for name, s in spans.items():
        net = ".".join(name.split(".")[:2]) if name != phases.UNATTRIBUTED else name
        networks[net] = networks.get(net, 0.0) + s
    total = sum(spans.values())
    return {
        "device_ms": _per_step(spans, trace.units),
        "total_ms": 1e3 * total / trace.units,
        "unattributed_share": spans.get(phases.UNATTRIBUTED, 0.0) / total if total else None,
        "phases_ms": {p: 1e3 * sum(spans.get(n, 0.0) for n in names) / trace.units
                      for p, names in phases.PHASES.items() if any(n in spans for n in names)},
        "networks_ms": _per_step(networks, trace.units),
        "kinds_ms": {name: _per_step(by_kind, trace.units) for name, by_kind in kinds.items()},
        "idle_ms": _per_step(phases.idle_by_span_s(trace), trace.units),
        "wall_ms": 1e3 * trace.wall_s / trace.units,
    }


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--traces", type=int, default=3)
    args = parser.parse_args()
    import torch

    from portbench import harness, trace as tracing, traffic

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.resolve(harness.load_spec(ROOT), args.workload, ROOT)
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        plan = traffic.train_plan(cell.mix, seed, cell.config["sample_rate"])
        session = cell.adapter.TrainSession(cell.config, plan, seed, device)
        state = {"i": session.start()}
        pool = len(session.batches)

        def one():
            with torch.profiler.record_function("portbench.train_step"):
                session.step(state["i"] % pool)
            state["i"] += 1

        for _ in range(WARM_STEPS):
            one()
        for n in range(args.traces):
            t0 = time.perf_counter()
            trace = tracing.trace_calls(one, harness.HOST_TRACE_UNITS, device, host=True)
            print(json.dumps({"workload": args.workload, "seed": seed, "trace": n,
                              "device": torch.cuda.get_device_name(device), **readings(trace),
                              "s": round(time.perf_counter() - t0, 2)}), flush=True)
        session.free()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
