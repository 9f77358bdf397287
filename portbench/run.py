"""The benchmark of the PyTorch and CUDA port, one cell per run.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with an NVIDIA GPU.  Prints,
as its last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit;
the checks are also the last lines of standard error.  Exits non-zero and
prints no result without a CUDA device, when the program is not the
checkout's own, or when a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _fail(message: str, code: int) -> int:
    print(f"portbench: {message}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.trace:
        os.environ.setdefault("TEARDOWN_CUPTI", "0")  # a torn-down CUPTI loses a trace's first kernels
    import torch

    from portbench import harness

    spec = harness.load_spec(ROOT)
    cell = harness.resolve(spec, args.workload, ROOT)
    if not torch.cuda.is_available():
        return _fail("no CUDA device: the benchmark measures the port on an NVIDIA GPU", 2)
    if torch.cuda.device_count() < int(cell.workload["chips"]):
        return _fail(f"{args.workload} needs {cell.workload['chips']} GPUs, found {torch.cuda.device_count()}", 2)
    try:
        import vibravox_tpu_torch
    except ImportError as exc:
        return _fail(f"the program is not in this checkout: {exc}", 2)
    if Path(vibravox_tpu_torch.__file__).resolve().parents[1] != ROOT:
        return _fail(f"the program was loaded from {vibravox_tpu_torch.__file__}, not this checkout", 2)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        return _fail(f"forbidden modules were loaded: {', '.join(found)}", 3)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
