"""Time K1's float32 forward under other tile plans, at the main path's shapes.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 scripts/torch_k1_plans.py C=128,V=0,TILE=64,KC=8,MW=3,NW=4,BLOCKS=1 C=64,V=1,TILE=16

Each plan names a channel count, a plan variant V (0: the first tile, 1:
the smaller tile the launcher takes where the first gives fewer blocks than
the card has SMs) and the ``MmaPlan<float, C, V>`` values it changes (TILE,
KC, MW, NW, BLOCKS) in ``vibravox_tpu_torch/ops/csrc/fused_residual.cu``.
The source's own plans come first.  Every plan's source is written to
``build/k1_plans/<n>/`` and built with the port's nvcc flags, all builds at
once; then, in turns (each plan twice), the port's wrapper runs over each
build: K1 float32 at that C's serving (B 8), training (B 32) and batch-1
eval shapes, held to the plain version at K1's float32 bar, its ms per call
by CUDA events, with the launch configuration the launcher picked.  Prints
one JSON line per plan, run and shape, with the card's name and power limit.
"""

import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vibravox_tpu_torch.device import strict_float32  # noqa: E402
from vibravox_tpu_torch.ops import _build  # noqa: E402
from vibravox_tpu_torch.ops import fused_residual as fr  # noqa: E402

SOURCE = Path("vibravox_tpu_torch/ops/csrc/fused_residual.cu")
KEYS = {"TILE": "kTile", "KC": "kKc", "MW": "kMw", "NW": "kNw", "BLOCKS": "kBlocks"}


def plan_source(text: str, c: int, v: int, values: dict) -> str:
    """The source with MmaPlan<float, c, v>'s values replaced."""
    pat = re.compile(r"(struct MmaPlan<float, %d, %d> \{\n  static constexpr int )([^;]*)(;)" % (c, v))
    m = pat.search(text)
    if m is None:
        raise ValueError(f"no MmaPlan<float, {c}, {v}> in {SOURCE}")
    fields = dict(f.strip().split(" = ") for f in m.group(2).split(","))
    for k, val in values.items():
        fields[KEYS[k]] = str(val)
    return text[: m.start(2)] + ", ".join(f"{k} = {val}" for k, val in fields.items()) + text[m.end(2):]


def build(directory: Path) -> str:
    lib = directory / "libfused_residual.so"
    proc = subprocess.run([_build._nvcc(), *_build._FLAGS, "-o", str(lib), str(directory / SOURCE.name)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {directory}:\n{proc.stdout}\n{proc.stderr}")
    return str(lib)


def use(lib_path: str) -> None:
    """Point the port's K1 wrapper at another build of the library."""
    fr._library.cache_clear()
    _build._libs["fused_residual"] = ctypes.CDLL(lib_path)


def shapes_of(c: int):
    """(label, B, T) of K1's float32 calls at channel count c."""
    serve = {cc: t for _, cc, t in cs.SERVING_SHAPES}[c]
    train = {cc: t for _, cc, t in cs.TRAIN_SHAPES}[c]
    return (("serve", cs.BATCH, serve), ("train", cs.TRAIN_B, train), ("eval", 1, train))


def main(specs) -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_k1_plans: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    text = SOURCE.read_text()
    plans = [("source", None, text)]
    for spec in specs:
        fields = dict(f.split("=") for f in spec.split(","))
        c, v = int(fields.pop("C")), int(fields.pop("V"))
        plans.append((spec, c, plan_source(text, c, v, {k: int(val) for k, val in fields.items()})))
    root = Path("build/k1_plans")
    shutil.rmtree(root, ignore_errors=True)
    dirs = []
    for n, (_, _, src) in enumerate(plans):
        d = root / str(n)
        d.mkdir(parents=True)
        shutil.copy(SOURCE.with_name("common.cuh"), d)
        (d / SOURCE.name).write_text(src)
        dirs.append(d)
    with ThreadPoolExecutor(max_workers=len(dirs)) as pool:
        libs = list(pool.map(build, dirs))
    for run in range(2):
        for (name, c, _), lib in zip(plans, libs):
            use(lib)
            for cc in ([c] if c is not None else [32, 64, 128]):
                for label, b, t in shapes_of(cc):
                    x, ks = cs.stack_inputs(b, cc, t, torch.float32, seed=cc)
                    with torch.inference_mode(), strict_float32():
                        out = fr.residual_stack(x, ks)
                        ref = fr.plain_residual_stack(x, ks)
                        err = cs.rel_err(out, ref)
                        ms = cs.cuda_ms(lambda: fr.residual_stack(x, ks), iters=30)
                    ops_ms, _ = cs.stack_bound_ms(b, cc, t, torch.float32)
                    print(json.dumps({"plan": name, "run": run, "card": smi, "C": cc, "T": t, "B": b,
                                      "shape": label, "ms": ms, "bound_ms": ops_ms, "err_over_scale": err,
                                      "ok": math.isfinite(err) and err <= cs.TOL[torch.float32],
                                      "config": fr.residual_stack_config(b, cc, t, torch.float32)}),
                          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
