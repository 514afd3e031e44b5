"""Builds the port's CUDA source with nvcc and loads it with ctypes.

``csrc/flash_attention.cu`` becomes one shared library with a plain C
interface, compiled for ``sm_90a`` at first CUDA use into
``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``), keyed by a hash of every file under ``csrc/`` and the
flags, so an edited source is rebuilt and an unchanged one is not.
Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: compiler output of the build this process ran ("" if it ran none)
build_log = ""


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")


def _target() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{SOURCE.stem}-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compiles the source unless it is built already.  Returns the seconds
    spent; raises with the compiler's output if the build fails."""
    global build_log
    t0 = time.perf_counter()
    target = _target()
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCE.name} "
                               f"(exit {res.returncode}):\n{build_log}")
        os.replace(tmp, target)       # atomic: a reader sees all or nothing
    return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    build()
    return ctypes.CDLL(str(_target()))
