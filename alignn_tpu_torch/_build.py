"""Kernel build: ``csrc/*.cu`` -> shared libraries loaded with ctypes.

At first use each CUDA source of the package is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface,
under ``build/alignn_tpu_torch/`` at the root of the checkout.  All
sources are compiled in parallel, one ``nvcc`` process each.  A library's
file name carries a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is reused.  Nothing is built on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "alignn_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}   # stem -> nvcc/ptxas output, this process


def _raise_on(rc: int, name: str):
    """Raise on the cudaError code a C entry point returned."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def _stream(x: torch.Tensor) -> int:
    """The current CUDA stream of x's device, as a C pointer."""
    return torch.cuda.current_stream(x.device).cuda_stream


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "alignn_tpu_torch are built on a CUDA host")
    return path


def _target(src: Path) -> Path:
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that is not built yet; {stem: library}."""
    targets = {src.stem: _target(src) for src in sorted(CSRC_DIR.glob("*.cu"))}
    todo = [(stem, lib) for stem, lib in targets.items() if not lib.exists()]
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for stem, lib in todo:
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{stem}.cu")]
        procs.append((stem, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for stem, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG[stem] = out.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{stem}.cu:\n{BUILD_LOG[stem]}")
            continue
        lib.with_name(f"{lib.name}.log").write_text(BUILD_LOG[stem])
        os.replace(tmp, lib)   # atomic publish for concurrent builds
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    return targets


def build_log(stem: str) -> str:
    """nvcc's and ptxas's output (``-Xptxas -v``: registers, spills and
    shared memory of every kernel) from the build of ``csrc/<stem>.cu``,
    kept beside its library."""
    lib = build_all()[stem]
    return lib.with_name(f"{lib.name}.log").read_text()


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if needed)."""
    with _LOCK:
        if stem not in _LIBS:
            _LIBS[stem] = ctypes.CDLL(str(build_all()[stem]))
        return _LIBS[stem]
