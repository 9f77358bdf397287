"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<digest>.so``
at the repository root; the digest covers the source, the shared headers
``csrc/*.cuh`` and the flags, so an edited source rebuilds and an unchanged
one is reused.  The library is
loaded with ``ctypes``: the wrappers pass every pointer and the stream as
``c_void_p``.  Nothing here runs at import time, so the CPU-only tests can
import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

__all__ = ["build", "build_all", "load", "SOURCES"]

SOURCES = ("fused_residual", "fused_residual_bwd", "framed_dft")  # K1, K2, K3 and K4

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless it is built already.  Returns the
    library path, the seconds the build took (0.0 when reused) and the ptxas
    report.  Raises if ``nvcc`` is missing or the build fails."""
    src = _CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(_FLAGS).encode()).hexdigest()[:12]
    target = _BUILD_DIR / f"lib{name}-{digest}.so"
    log = target.with_suffix(".log")
    if target.is_file():
        return {"path": str(target), "seconds": 0.0,
                "ptxas": log.read_text() if log.is_file() else ""}
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *_FLAGS, "-o", tmp, str(src)], check=False,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)  # atomic: a concurrent loader never sees a partial file
    log.write_text(proc.stdout)
    return {"path": str(target), "seconds": seconds, "ptxas": proc.stdout}


def build_all(names) -> Dict[str, dict]:
    """``build`` for several sources at once, one ``nvcc`` each, all started
    together.  Raises the first build failure."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name)["path"])
        _libs[name] = lib
    return lib
