"""The readings that a cell's limits are set from, on the chip.

    python3 portbench/tools/readings.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--faults half_batch,k2_dx]

For each seed, one JSON line on standard output and in
``chiprun_out/readings_<workload>.jsonl``:

* ``program``: the numbers the cell compares, and the readings beside them,
  from the program's checked steps (no window);
* ``control``: the same numbers from the control (the configuration's
  precision one step down: the adapter's ``control_readings``);
* ``fault:<name>``: the program with a fault of ``portbench/faults.py``
  planted (default: ``half_batch``).

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


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--faults", default="half_batch")
    args = parser.parse_args()
    import torch

    from portbench import faults, harness, traffic

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.resolve(harness.load_spec(ROOT), args.workload, ROOT)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sink = open(out_dir / f"readings_{args.workload}.jsonl", "a")

    def emit(kind, seed, readings, t0):
        line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed, "readings": readings,
                           "s": round(time.perf_counter() - t0, 2), "device": torch.cuda.get_device_name(device)})
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    def program(seed):
        session = cell.adapter.TrainSession(cell.config, plan, seed, device)
        session.start()
        session.free()
        return session.check()

    runs = [("program", s, None) for s in _seeds(args.seeds)]
    runs += [("control", s, None) for s in _seeds(args.control_seeds)]
    runs += [(f"fault:{f}", s, f) for f in args.faults.split(",") if f for s in _seeds(args.fault_seeds)]
    for kind, seed, fault in runs:
        t0 = time.perf_counter()
        plan = traffic.train_plan(cell.mix, seed, cell.config["sample_rate"])
        if kind == "control":
            readings = cell.adapter.control_readings(cell.config, plan, seed, device)
        elif fault is None:
            readings = program(seed)
        else:
            with faults.planted(fault):
                readings = program(seed)
        torch.cuda.empty_cache()
        emit(kind, seed, readings, t0)
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
