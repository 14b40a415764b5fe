"""Native (C++) host code of the port, loaded with ctypes.

``neighbors.cpp`` is a copy of the JAX package's cell-list periodic
neighbour search (``alignn_tpu/native/neighbors.cpp``): every ordered pair
(i, j + image) with 0 < |r_j + R - r_i| <= cutoff, in O(N) cell binning
instead of the numpy path's O(N^2 * images) distance tables.

At first use it is compiled with ``g++ -O3 -shared -fPIC -std=c++17``
into ``build/alignn_tpu_torch/`` at the root of the checkout (never next to
the source) by :func:`alignn_tpu_torch._build.compile_libraries`, which
builds the CUDA kernels too: the file name carries a hash of the source
and the flags, and a build is published with ``os.replace``, so processes
that build at once each load a whole library.  On a host without ``g++``
:func:`neighbors_lib` returns None and ``build_graph`` takes its numpy
path, as the JAX package does; a compiler that fails on the source
raises.  Nothing is built on import.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from alignn_tpu_torch import _build

SRC_DIR = Path(__file__).resolve().parent
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}


def library_path(name: str) -> Path:
    """Where ``<name>.cpp`` is built (a hash of source and flags in its
    name)."""
    return _build.library_path(SRC_DIR / f"{name}.cpp", CXX_FLAGS)


def load(name: str) -> Optional[ctypes.CDLL]:
    """Build on demand and dlopen ``<name>.cpp``; None without ``g++``."""
    with _LOCK:
        if name not in _LIBS:
            cxx = shutil.which("g++")
            path = None if cxx is None else _build.compile_libraries(
                cxx, CXX_FLAGS, [SRC_DIR / f"{name}.cpp"])[name]
            _LIBS[name] = ctypes.CDLL(str(path)) if path else None
        return _LIBS[name]


def neighbors_lib() -> Optional[ctypes.CDLL]:
    """The neighbour-list library, its entry point typed; None without
    ``g++``."""
    lib = load("neighbors")
    if lib is None:
        return None
    if not getattr(lib, "_configured", False):
        from numpy.ctypeslib import ndpointer

        f64 = ndpointer(np.float64, flags="C_CONTIGUOUS")
        i32 = ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.periodic_pairs.restype = ctypes.c_int64
        lib.periodic_pairs.argtypes = [
            f64, f64, ctypes.c_int64,          # lattice [9], frac [n*3], n
            ctypes.c_double, ctypes.c_double,  # cutoff, atol
            ctypes.c_int64,                    # cap
            i32, i32, f64, f64, f64]           # src, dst, images, disp, dist
        lib._configured = True
    return lib


def periodic_pairs_native(lattice, frac, cutoff: float,
                          atol: float = 1e-5):
    """All (src, dst, image, disp, dist) pairs within cutoff, or None
    (no ``g++``, or a singular lattice).

    Retries with a grown buffer when the first capacity guess overflows.
    """
    lib = neighbors_lib()
    if lib is None:
        return None
    lattice = np.ascontiguousarray(lattice, dtype=np.float64).reshape(9)
    frac = np.ascontiguousarray(frac, dtype=np.float64)
    n = frac.shape[0]
    cap = max(1024, n * 64)
    for _ in range(4):
        src = np.empty(cap, dtype=np.int32)
        dst = np.empty(cap, dtype=np.int32)
        images = np.empty(cap * 3, dtype=np.float64)
        disp = np.empty(cap * 3, dtype=np.float64)
        dist = np.empty(cap, dtype=np.float64)
        total = lib.periodic_pairs(lattice, frac.reshape(-1), n,
                                   float(cutoff), float(atol), cap,
                                   src, dst, images, disp, dist)
        if total < 0:
            return None  # singular lattice
        if total <= cap:
            t = int(total)
            return (src[:t].astype(np.int64), dst[:t].astype(np.int64),
                    images[:3 * t].reshape(t, 3),
                    disp[:3 * t].reshape(t, 3), dist[:t])
        cap = int(total) + 16
    return None
