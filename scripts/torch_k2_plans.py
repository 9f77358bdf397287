"""Time K2 under other tile plans, at the training shapes.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 scripts/torch_k2_plans.py C=128,TILE=128 C=64,WARPS=8 DTYPE=f32,C=128,TILE=80,KC=32

Each plan names a channel count and the values it changes in
``vibravox_tpu_torch/ops/csrc/fused_residual_bwd.cu``: for bfloat16 (the
default) ``MmaPlan<C>``'s TILE, KC, STAGES, WARPS, BLOCKS; with DTYPE=f32
``F32Plan<C>``'s TILE, FWD_TILE, KI, KC, MT, BLOCKS.  The
source's own plans come first, in both types.  Every plan's source is
written to ``build/k2_plans/<n>/`` and built with the port's nvcc flags, all
builds at once; then, in turns (each plan twice), the port's wrapper runs
over each build: K2 at that C's training shape (B = 32) in the plan's
type, held to the plain backward at K2's bars for the type (float32's
plain side in IEEE float32), its ms per call by CUDA events and its
passes' µs from a trace (float32's unit_backward passes split into
recompute and products), with the launch configuration.  Prints one JSON
line per plan, type and run, with the card's name and power limit.
"""

import ctypes
import json
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

SOURCE = Path("vibravox_tpu_torch/ops/csrc/fused_residual_bwd.cu")
PLANS = {  # per type: the plan struct and the names of its values
    torch.bfloat16: ("MmaPlan", {"TILE": "kTile", "KC": "kKc", "STAGES": "kStages", "WARPS": "kWarps",
                                 "BLOCKS": "kBlocks"}),
    torch.float32: ("F32Plan", {"TILE": "kTile", "FWD_TILE": "kFwdTile", "KI": "kKi", "KC": "kKc", "MT": "kMt",
                                "BLOCKS": "kBlocks"}),
}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def plan_source(text: str, dtype: torch.dtype, c: int, values: dict) -> str:
    """The source with the type's plan for c given ``values``."""
    struct, keys = PLANS[dtype]
    pat = re.compile(r"(struct %s<%d> \{\n  static constexpr int )([^;]*)(;)" % (struct, c))
    m = pat.search(text)
    if m is None:
        raise ValueError(f"no {struct}<{c}> in {SOURCE}")
    fields = dict(f.strip().split(" = ") for f in m.group(2).split(","))
    for k, v in values.items():
        fields[keys[k]] = str(v)
    return text[: m.start(2)] + ", ".join(f"{k} = {v}" for k, v in fields.items()) + text[m.end(2):]


def build(directory: Path) -> str:
    lib = directory / "libfused_residual_bwd.so"
    proc = subprocess.run([_build._nvcc(), *_build._FLAGS, "-o", str(lib), str(directory / SOURCE.name)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {directory}:\n{proc.stdout}\n{proc.stderr}")
    return str(lib)


def use(lib_path: str) -> None:
    """Point the port's K2 wrapper at another build of the library."""
    fr._backward_library.cache_clear()
    fr._backward_config.cache_clear()
    _build._libs["fused_residual_bwd"] = ctypes.CDLL(lib_path)


def main(specs) -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_k2_plans: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    text = SOURCE.read_text()
    plans = [("source", None, None, {})]
    for spec in specs:
        fields = dict(f.split("=") for f in spec.split(","))
        dtype = DTYPES[fields.pop("DTYPE", "bf16")]
        plans.append((spec, dtype, int(fields.pop("C")), {k: int(v) for k, v in fields.items()}))
    root = Path("build/k2_plans")
    shutil.rmtree(root, ignore_errors=True)
    dirs = []
    for n, (_, dtype, c, values) in enumerate(plans):
        d = root / str(n)
        d.mkdir(parents=True)
        shutil.copy(SOURCE.with_name("common.cuh"), d)
        (d / SOURCE.name).write_text(text if c is None else plan_source(text, dtype, c, values))
        dirs.append(d)
    with ThreadPoolExecutor(max_workers=len(dirs)) as pool:
        libs = list(pool.map(build, dirs))
    shapes = {c: t for _, c, t in cs.TRAIN_SHAPES}
    for run in range(2):
        for (name, dtype, c, _), lib in zip(plans, libs):
            use(lib)
            cases = [(dtype, c)] if c is not None else [(dt, cc) for dt in PLANS for cc in sorted(shapes)]
            for dt, cc in cases:
                t = shapes[cc]
                x, ks = cs.stack_inputs(cs.TRAIN_B, cc, t, dt, seed=cc)
                g = (torch.randn(x.shape, generator=torch.Generator().manual_seed(cc)) * 0.1).to("cuda", x.dtype)
                with strict_float32():
                    dx, dws = fr.residual_stack_backward(x, ks, g)
                    ref_dx, ref_dws = fr.plain_residual_stack_backward(
                        x.float(), tuple((a.float(), w.float()) for a, w in ks), g.float())
                err_dx = cs.rel_err(dx, ref_dx)
                err_dw = max(cs.rel_err(a, r) for a, r in zip([w for p in dws for w in p],
                                                              [w for p in ref_dws for w in p]))
                tol_dx, tol_dw = cs.K2_TOL[dt]
                passes = cs.k2_passes_us(x, ks, g)
                print(json.dumps({"plan": name, "dtype": str(dt)[6:], "run": run, "card": smi, "C": cc, "T": t,
                                  "B": cs.TRAIN_B,
                                  "ms": cs.cuda_ms(lambda: fr.residual_stack_backward(x, ks, g), iters=10),
                                  "dx_err": err_dx, "dw_err": err_dw, "ok": err_dx <= tol_dx and err_dw <= tol_dw,
                                  "passes_us": passes,
                                  "config": fr.residual_stack_backward_config(cs.TRAIN_B, cc, t, dt)}),
                      flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
