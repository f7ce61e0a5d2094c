"""Builds the port's hand-written CUDA sources (``csrc/*.cu``) at first use.

Each source has a plain C interface: ``nvcc`` compiles it alone into a
shared library under ``build/kernels/`` at the repository root, and the
caller loads it with ``ctypes``.  The library's name carries a hash of the
source and the flags, so an edited source rebuilds, and a build is written
to a temporary name and renamed, so concurrent processes never load a
half-written file.  Two sources build in parallel when two threads call
``build`` at once (``nvcc`` runs in a subprocess).
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
from typing import Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built with the CUDA toolkit at first use")
    return found


def build(source: str, flags: Sequence[str] = NVCC_FLAGS
          ) -> Tuple[ctypes.CDLL, float, str]:
    """Build (if needed) and load ``csrc/<source>``; returns the ctypes
    handle, the seconds it took and the compiler's messages (empty when
    the library was already built)."""
    src_path = CSRC / source
    src = src_path.read_bytes()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f"lib{src_path.stem}_{key}.so"
    log = ""
    t0 = time.perf_counter()
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([nvcc(), *flags, "-o", tmp, str(src_path)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {src_path}:\n{proc.stderr}")
            log = proc.stderr
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so_path))
    return lib, time.perf_counter() - t0, log
