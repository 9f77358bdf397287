"""Sweep runner: one run of the port's CLI per line of a sweep table.

The port's counterpart of ``vibravox_tpu/scripts/sweep.py`` (the
reference's SLURM array launchers, ``scripts/run_*_slurm_array_JZ.sh`` over
``configs/slurm_array/*.txt``): each line of a table
(``configs/sweeps/{bwe,spkv,stp}.txt``) holds the overrides of one job,
run as ``python -m vibravox_tpu_torch.run <overrides>``.  Locally the lines
run one after the other; ``--line N`` or ``SLURM_ARRAY_TASK_ID`` picks one;
``--dry-run`` prints the commands only.  Blank lines and ``#`` comments are
skipped.

Usage::

    python -m vibravox_tpu_torch.scripts.sweep configs/sweeps/bwe.txt [--line N] [--dry-run]
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
from pathlib import Path


def commands(table: str, line=None) -> list:
    """The command of each selected line of ``table``."""
    lines = [ln.strip() for ln in Path(table).read_text().splitlines()
             if ln.strip() and not ln.strip().startswith("#")]
    selected = [lines[line]] if line is not None else lines
    return [[sys.executable, "-m", "vibravox_tpu_torch.run"] + shlex.split(o) for o in selected]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("table", help="sweep table: one overrides-line per job")
    parser.add_argument("--line", type=int, default=None,
                        help="run only this line (defaults to SLURM_ARRAY_TASK_ID or all)")
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)

    line = args.line
    if line is None and "SLURM_ARRAY_TASK_ID" in os.environ:
        line = int(os.environ["SLURM_ARRAY_TASK_ID"])
    for cmd in commands(args.table, line):
        print("+", " ".join(cmd), flush=True)
        if not args.dry_run:
            subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
