"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel's source is ``kernels/<name>/csrc/<name>.cu`` and exposes a
plain C entry point.  ``load(name)`` compiles it on first use into
``build/repro_torch_kernels/<name>-<hash>.so`` at the repository root (the
hash covers the source and the flags, so an edited source is rebuilt) and
opens the library.  ``build(names)`` starts one nvcc per source, all at
once, and waits for them; a run that needs several kernels calls it first.
nvcc's output, ptxas' register and shared-memory report included, is kept
beside each library as ``.log``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NAMES = ("flash_attention", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def source(name: str) -> Path:
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def library(name: str) -> Path:
    h = hashlib.sha256(source(name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=NAMES) -> float:
    """Compile every named kernel whose library is missing, one nvcc each,
    in parallel.  Returns the wall-clock seconds spent."""
    t0 = time.perf_counter()
    todo = [name for name in names if not library(name).exists()]
    if not todo:
        return time.perf_counter() - t0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    with contextlib.ExitStack() as logs:
        for name in todo:
            lib = library(name)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            log = logs.enter_context(open(lib.with_suffix(".log"), "w"))
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
                stdout=log, stderr=subprocess.STDOUT)
            jobs.append((name, lib, tmp, proc))
        for *_, proc in jobs:
            proc.wait()
    failed = []
    for name, lib, tmp, proc in jobs:
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{name}:\n{build_log(name)}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output from the build of ``name``'s current library."""
    log = library(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The kernel library of ``name``, built first if need be."""
    if name not in _LIBS:
        build((name,))
        _LIBS[name] = ctypes.CDLL(str(library(name)))
    return _LIBS[name]
