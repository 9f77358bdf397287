"""``tools/readings.py`` with WavLM's faults too (``wavlm_faults.py``:
``gate_off``, ``relpos_off``, and ``faults.py``'s ``half_batch`` and
``state_unchanged``), on the chip:

    python3 portbench/tools/wavlm_readings.py --workload wavlm_large_stp_train_b8_long \
        --seeds 1,2,3 [--control-seeds 4,5] [--fault-seeds 6,7] [--faults gate_off,relpos_off]

Same arguments and output as ``readings.py``, which plants a fault through
``faults.planted``: this tool hands it ``wavlm_faults.planted`` instead.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import faults, wavlm_faults  # noqa: E402
from portbench.tools import readings  # noqa: E402

if __name__ == "__main__":
    faults.planted = wavlm_faults.planted
    sys.exit(readings.main())
