"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Every ``csrc/*.cu`` becomes one shared library with a plain C interface,
compiled for ``sm_90a`` at first CUDA use into ``build/repro_torch_kernels/``
at the repository root (listed in ``.gitignore``), keyed by a hash of every
file under ``csrc/`` and the flags, so an edited source is rebuilt and an
unchanged one is not.  One :func:`build` starts an nvcc for each source that
is not built yet, all at once, and waits for them all.  Another directory of
sources (an older commit's ``csrc/``, to time its kernels beside these) is
built and loaded the same way.  Nothing here runs at import: the CPU tests
import every module.
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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: compiler output of the builds this process ran, by source name
#: (``"flash_attention.cu"``); a source built by an earlier process has none
build_log: dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def _target(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(source.parent.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(csrc: Path = CSRC) -> float:
    """Compiles every source of ``csrc`` not built already, in parallel.
    Returns the seconds spent; raises with the compiler's output if a build
    fails (after every started nvcc has ended)."""
    t0 = time.perf_counter()
    jobs = []
    for src in sources(csrc):
        target = _target(src)
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((src, target, tmp, proc))
    failed = []
    for src, target, tmp, proc in jobs:
        out, _ = proc.communicate()
        build_log[src.name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src.name} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, target)   # atomic: a reader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def library(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The loaded library of ``<csrc>/<name>.cu``, built first if needed."""
    source = csrc / f"{name}.cu"
    if not source.exists():
        raise FileNotFoundError(source)
    build(csrc)
    return ctypes.CDLL(str(_target(source)))
