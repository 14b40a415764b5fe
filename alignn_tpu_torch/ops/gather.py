"""Windowed gather (K8) for graph-local indices, and its static windows.

Counterpart of ``alignn_tpu/ops/pallas_gather.py``.  In a padded batch of
many small graphs each graph's nodes, edges and L-edges take contiguous
rows, so in any supertile of consecutive index rows the real (non-trash)
indices span a bounded window of the source table.  ``batch_graphs``
measures that span per index array (:func:`window_for`, numpy, once per
batch); the model then gathers through :func:`windowed_gather`.

Semantics, exactly those of the JAX package:

- the window path runs only when ``0 < window <= 2048``, ``window % 256 ==
  0``, x is f32 or bf16 with ``x.shape[-1] % 128 == 0``, and
  ``supertile_for(len(idx)) != 0``; otherwise the result is ``x[idx]``,
  trash rows included (a static rule decided from shapes; so an f16
  model gathers with ``x[idx]``, as JAX's does);
- per supertile of ``T = supertile_for(m)`` rows, with ``trash =
  x.shape[0] - 1``, ``base`` is the minimum of the tile's real indices
  aligned down to 128 (0 for an all-trash tile), and row r gets ``x[idx]``
  iff ``idx != trash`` and ``idx - base < window``, else 0.

Padded rows are masked at every loss and readout, so reading 0 there
instead of ``x[trash]`` changes no gradient at any order.

K8 ``windowed_gather_cuda`` is the hand-written kernel in
``csrc/gather.cu`` (replaces ``_gather_kernel``, ``pallas_gather.py:119``,
launched at ``:229``).  Dispatch rule: a CPU tensor takes the plain
version ``windowed_gather_plain``; a CUDA tensor launches K8 or raises.
The switch :func:`windows_enabled` (``ALIGNN_TPU_ENABLE_WGATHER``, the JAX
package's own) routes the model's gathers here; the batch's ``win_*``
fields give the windows.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from alignn_tpu_torch import _build
from alignn_tpu_torch._build import _raise_on, _stream

TLS = 512          # preferred index rows per supertile
_ALIGN = 128       # window base alignment
_W_QUANTUM = 256
_MAX_WINDOW = 2048
# the kernel copies 4- or 2-byte elements bit for bit (f16 as bf16); the
# window rule takes JAX's two dtypes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_WINDOW_DTYPES = (torch.float32, torch.bfloat16)


def windows_enabled() -> bool:
    """``ALIGNN_TPU_ENABLE_WGATHER`` set: the model gathers through
    :func:`windowed_gather` with the batch's windows.  Read per forward."""
    return bool(os.environ.get("ALIGNN_TPU_ENABLE_WGATHER"))


def supertile_for(m: int) -> int:
    """Largest supertile in (512, 256, 128) dividing the index length, or
    0 when none does."""
    for t in (TLS, 256, 128):
        if m % t == 0:
            return t
    return 0


def max_tile_span(idx, trash: int, tile: int = TLS) -> int:
    """Max over supertiles of (max real idx - min real idx + 1); rows equal
    to `trash` are left out, an all-trash tile spans 0."""
    idx = np.asarray(idx)
    pad = (-len(idx)) % tile
    if pad:
        idx = np.concatenate([idx, np.full(pad, trash, idx.dtype)])
    t = idx.reshape(-1, tile)
    real = t != trash
    lo = np.where(real, t, np.iinfo(np.int32).max).min(axis=1)
    hi = np.where(real, t, -1).max(axis=1)
    spans = np.where(hi >= 0, hi - lo + 1, 0)
    return int(spans.max()) if len(spans) else 0


def window_for(idx, trash: int, tile: int | None = None) -> int:
    """The static window of `idx`: a multiple of 256 that covers the span
    plus the base's alignment slack, or 0 (plain gather) when there is no
    supertile or it would exceed 2048."""
    if tile is None:
        tile = supertile_for(len(idx))
        if tile == 0:
            return 0
    w = max_tile_span(idx, trash, tile) + _ALIGN
    w = ((w + _W_QUANTUM - 1) // _W_QUANTUM) * _W_QUANTUM
    return w if w <= _MAX_WINDOW else 0


def eligible(x: torch.Tensor, idx: torch.Tensor, window: int) -> bool:
    """Whether ``windowed_gather`` takes the window path (JAX's static
    rule); otherwise it is ``x[idx]``."""
    return (0 < window <= _MAX_WINDOW and window % _W_QUANTUM == 0
            and x.dtype in _WINDOW_DTYPES and x.shape[-1] % 128 == 0
            and supertile_for(idx.shape[0]) != 0)


# ---------------------------------------------------------------------------
# plain version (CPU path, and the reference the kernel is held against)
# ---------------------------------------------------------------------------


def windowed_gather_plain(x: torch.Tensor, idx: torch.Tensor,
                          window: int) -> torch.Tensor:
    """x[idx] with trash and out-of-window rows 0, per supertile."""
    rows = x.shape[0]
    t = idx.reshape(-1, supertile_for(idx.shape[0]))
    real = t != rows - 1
    lo = torch.where(real, t, rows).amin(dim=1, keepdim=True)
    base = torch.where(lo >= rows, 0, lo // _ALIGN * _ALIGN)
    keep = (real & (t - base < window)).reshape(-1, 1)
    return torch.where(keep, x.index_select(0, idx), x.new_zeros(()))


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.library("gather")
    if not getattr(lib, "_alignn_configured", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.alignn_windowed_gather.argtypes = [p, ll, ll, p, ll, i, i, p, i,
                                               i, p]
        lib.alignn_windowed_gather.restype = i
        lib._alignn_configured = True
    return lib


def windowed_gather_cuda(x: torch.Tensor, idx: torch.Tensor,
                         window: int) -> torch.Tensor:
    """K8 on the card: out [m, F] in x's dtype, an exact row copy.

    The caller decides the window rule (:func:`windowed_gather`); the C
    entry point refuses a length that is not whole supertiles and a window
    that is not positive.  Checked here is what it cannot see."""
    if not (x.is_cuda and x.dim() == 2 and x.stride(1) == 1
            and x.dtype in _DTYPE_CODE and idx.device == x.device
            and idx.dtype == torch.int64 and idx.is_contiguous()):
        raise ValueError(
            f"windowed_gather: the kernel takes a CUDA [rows, F] f32/bf16/f16 "
            f"table with a unit-stride feature axis and a contiguous int64 "
            f"index vector on its device; got x {tuple(x.shape)} {x.dtype} "
            f"on {x.device}, strides {x.stride()}, idx {idx.dtype} on "
            f"{idx.device}")
    m, f = idx.shape[0], x.shape[1]
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    if out.numel():
        with torch.cuda.device(x.device):
            rc = _lib().alignn_windowed_gather(
                x.data_ptr(), x.stride(0), x.shape[0], idx.data_ptr(), m,
                supertile_for(m), window, out.data_ptr(), f,
                x.element_size(), _stream(x))
        _raise_on(rc, "windowed_gather")
        windowed_gather_cuda.launches += 1
    return out


windowed_gather_cuda.launches = 0


def windowed_gather(x: torch.Tensor, idx: torch.Tensor,
                    window: int) -> torch.Tensor:
    """x[idx] through the window (trash rows 0) where :func:`eligible`,
    else plain ``x[idx]``.  Not differentiable by itself: the model reaches
    it through the Functions of :mod:`alignn_tpu_torch.ops.eggc`."""
    if not eligible(x, idx, window):
        return x.index_select(0, idx)
    if x.device.type == "cpu":
        return windowed_gather_plain(x, idx, window)
    if x.device.type == "cuda":
        x = x if x.stride(1) == 1 else x.contiguous()
        return windowed_gather_cuda(x, idx, window)
    raise ValueError(f"no kernel for device {x.device}")
