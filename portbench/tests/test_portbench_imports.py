"""Nothing the benchmark loads may be JAX or the JAX package: every import
under portbench/ by its top-level name, compared whole, and every module a
run's tiny CPU build of each adapter loads.  The references import nothing
of the program either."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "vibravox_tpu"}
PROGRAM = "vibravox_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "portbench").rglob("*.py"))
    assert files
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_the_references_import_nothing_of_the_program():
    files = sorted((ROOT / "portbench" / "reference").rglob("*.py"))
    assert len(files) >= 3
    bad = [(f.name, m) for f in files for m in _imports(f) if m.split(".")[0] in (FORBIDDEN | {PROGRAM})]
    assert not bad, bad


def test_the_top_level_comparison_is_whole():
    assert PROGRAM.split(".")[0] not in FORBIDDEN and PROGRAM.startswith("vibravox_tpu")


BUILD = r"""
import json, sys, time
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
from conftest import cell_named, run_cpu, tiny
for name in ("eben_train_b32", "w2v2_stp_train_b8"):
    run_cpu(tiny(cell_named(name)), seconds=0.2)
from portbench import harness
print(json.dumps({{"forbidden": harness.forbidden_modules(),
                  "program": "vibravox_tpu_torch" in sys.modules}}))
"""


def test_a_run_of_each_adapter_loads_no_jax():
    code = BUILD.format(tests=str(ROOT / "portbench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert found["program"] and found["forbidden"] == []
