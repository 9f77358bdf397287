"""The end-to-end paths K1 float32 serves, timed for an A/B of two checkouts.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 /path/to/scripts/torch_e2e_times.py LABEL

It imports ``chip_smoke`` and the port from the working directory, so the
same script times another checkout too (parent, change, change, parent on
one card, as ``torch_kernel_times.py``).  It prints a line naming LABEL and
the card's name and power limit, then runs ``chip_smoke.py``'s phases
``build``, ``serve`` in float32 (the 1 s bucket, batch 8: latency p50 /
p95), ``profile`` (the float32 serving forward's device time and idle
share, from a trace) and ``cli`` (the EBEN CLI: fit, then ``test("last")``
at batch 1 in float32, its seconds a batch split into the eval step and
the host metrics), each printing its own JSON lines.
"""

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(label: str) -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_e2e_times: no CUDA device is available")
    os.environ.setdefault("TEARDOWN_CUPTI", "0")  # as chip_smoke.main
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": label, "card": smi}), flush=True)
    cs.phase_build()
    cs.phase_serve(None)
    cs.phase_profile()
    with tempfile.TemporaryDirectory() as run_dir:
        cs.phase_cli(run_dir)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
