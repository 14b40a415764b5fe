"""Kernel build: ``csrc/*.cu`` -> shared libraries loaded with ctypes.

At first use each CUDA source of the package is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface,
under ``build/alignn_tpu_torch/`` at the root of the checkout.  All
sources are compiled in parallel, one ``nvcc`` process each.  A library's
file name carries a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is reused.  The C++ host code of
``native/`` is built by the same :func:`compile_libraries`, with ``g++``.
Nothing is built on import.
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


def _stream(x: "torch.Tensor") -> int:
    """The current CUDA stream of x's device, as a C pointer."""
    import torch   # here, so that the host code's builds import no torch

    return torch.cuda.current_stream(x.device).cuda_stream


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "alignn_tpu_torch are built on a CUDA host")
    return path


def library_path(src: Path, flags) -> Path:
    """Where `src` is built with `flags`: the name carries a hash of the
    source and the flags, so an edited source is rebuilt."""
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def compile_libraries(compiler: str, flags, sources) -> Dict[str, Path]:
    """Compile every source in `sources` that is not built yet, one
    `compiler` process each, all started together; {stem: library}.

    Each build is written under a temporary name of its own and published
    with ``os.replace``, so processes that build at once each load a whole
    library; the compiler's output is kept beside it (``<library>.log``).
    """
    targets = {src.stem: library_path(src, flags) for src in sources}
    todo = [src for src in sources if not targets[src.stem].exists()]
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        lib = targets[src.stem]
        tmp = lib.with_name(
            f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        procs.append((src.stem, lib, tmp, subprocess.Popen(
            [compiler, *flags, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for stem, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG[stem] = out.decode(errors="replace")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{stem}:\n{BUILD_LOG[stem]}")
            continue
        lib.with_name(f"{lib.name}.log").write_text(BUILD_LOG[stem])
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError(f"{os.path.basename(compiler)} failed on "
                           + "\n".join(failed))
    return targets


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that is not built yet; {stem: library}."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if all(library_path(src, NVCC_FLAGS).exists() for src in sources):
        return {src.stem: library_path(src, NVCC_FLAGS) for src in sources}
    return compile_libraries(_nvcc(), NVCC_FLAGS, sources)


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
