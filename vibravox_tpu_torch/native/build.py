"""Build the native host kernels (``native/*.cpp``) with ``g++``.

The library goes to ``build/native/libvibravox_torch_native-<digest>.so`` at
the repository root, the digest covering the sources and the flags, so an
edited source rebuilds and an unchanged one is reused.  It is written under
a temporary name and renamed into place, so processes that build at once
(loader workers, test workers) never load a partial file.  Raises if ``g++``
is missing or fails: there is no fallback.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["build"]

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parents[1] / "build" / "native"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def build() -> Path:
    """The built library's path; builds it unless it is built already."""
    sources = sorted(NATIVE_DIR.glob("*.cpp"))
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in sources) + " ".join(FLAGS).encode()).hexdigest()[:12]
    target = BUILD_DIR / f"libvibravox_torch_native-{digest}.so"
    if target.is_file():
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native data pipeline needs a C++ compiler to build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *FLAGS, "-o", tmp, *map(str, sources)], check=False,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for the native pipeline (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)
    return target


if __name__ == "__main__":
    print(build())
