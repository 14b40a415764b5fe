"""Gated aggregations of the dense-neighbourhood layout, with gradients.

Counterpart of ``alignn_tpu/ops/pallas_dense.py``.  In the dense layout
(:mod:`alignn_tpu_torch.graph.dense`) node j owns the edge rows
``[j*D, (j+1)*D)`` and the local pairs ``(j, t, s)`` at rows
``j*D*D + t*D + s``, so both aggregations are regular block reductions.
The slot mask is folded into the gate logits (:func:`fold_mask`):
sigmoid(m - 1e9) is exactly 0, which removes a masked slot from the
numerator, the denominator and every gradient.

- K3 ``dense_gated_aggregate``: h[j] = sum_s sig(m[jD+s]) bh[jD+s] /
  (sum_s sig + 1e-6), [M*D, F] -> [M, F].  Replaces the Pallas ``_kernel``
  (``pallas_dense.py:72``, launched at ``:84``).  Its backward is the JAX
  ``_bwd`` (``:131-151``) in plain torch ops: den recomputed in f32, then
  elementwise and broadcast algebra that stays differentiable.
- K4 ``dense_pair_aggregate``: h[j,t] = sum_s sig(m2[j,t,s]) bh[j,s] /
  (sum_s sig + 1e-6), m2 [N*D*D, F], bh [N*D, F] -> [N*D, F].  Replaces
  ``_pair_kernel`` (``:266``, launched at ``:291``).  Its backward is
  :func:`pair_aggregate_bwd`.
- K5a ``pair_aggregate_bwd``: (dm2, dbh), the first-order VJP of K4.
  Replaces ``_pair_bwd_kernel`` (``:395``, launched at ``:433``) and the
  dbh reduction that JAX leaves to XLA (``:453-457``).  JAX makes the
  kernel opt-in (``ALIGNN_TPU_PAIR_BWD_KERNEL``) because XLA fuses its
  plain rule into the matmul VJPs; PyTorch fuses nothing, so here the
  kernel is the default.
- K5b ``pair_aggregate_bwd2``: (c_m2, c_bh, c_g), the VJP of K5a with
  cotangents (u, v) on (dm2, dbh), i.e. the second order of K4 that the
  E/F/S training step runs (its loss holds the forces, -dE/dr).  Replaces
  ``_pair_bwd2_kernel`` (``:533``, launched at ``:593``) and the c_bh
  reduction left to XLA (``:619-625``); its plain version is
  ``_xla_pair_bwd2`` (``:485-530``).  On the default path for the same
  reason as K5a.  A third derivative raises: nothing needs one.

K3's second order is autograd through its plain backward, as in JAX.
With ``ALIGNN_TPU_GATED_BWD_OP`` set (JAX's opt-in switch, read at each
backward) K3's backward is instead :func:`gated_aggregate_bwd`, whose
own VJP is the hand-derived :func:`gated_aggregate_bwd2_plain` (JAX's
``_xla_gated_bwd``/``_xla_gated_bwd2``): both are torch ops, as JAX's are
XLA ops with no Pallas kernel.

All four kernels are in ``csrc/dense.cu``.  K3 runs one thread per
(node, 16-byte feature lane), which walks the node's D rows in order.
K4 runs persistent blocks whose threads each stream the (row, s) words
of their rows two words ahead of the sigmoids, with the exact sigmoid's
reciprocal taken on its fast path a word at a time (bit-identical).
K5a and K5b stage a node's pair rows in shared
memory once (the slab path) and keep their first, two-pass design for D
too large for a slab (:func:`pair_bwd_occupancy` reads which path and
how many blocks per SM a shape gets).  Bound on an H100 SXM at the
512-atom dense shape (N 768, D 18, F 256, f32), all by bytes at
3.35 TB/s: K3 29 MB (0.009 ms), K4 283 MB (0.085 ms), K5a 552 MB
(0.165 ms), K5b 835 MB (0.249 ms).

Dispatch rule of every wrapper (as in :mod:`alignn_tpu_torch.ops.eggc`):
a tensor on the CPU takes the plain PyTorch version (``*_plain``); a
CUDA tensor launches the kernel or raises.  The kernel wrappers count
their launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import os

import torch

from alignn_tpu_torch import _build
from alignn_tpu_torch._build import _raise_on, _stream
from alignn_tpu_torch.ops.eggc import _DTYPE_CODE, _dispatch, _unit_stride
from alignn_tpu_torch.ops.fp8 import fp8_ltables_enabled, fp8_round_trip

EPS = 1e-6
MASK_SHIFT = 1e9   # additive logit shift of a masked slot
# the shift of a float16 table: -1e9 is -inf there (its largest finite
# value is 65504), which turns a LayerNorm over a masked row into NaN
MASK_SHIFT_F16 = 2.0 ** 12


def fold_mask(m: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """m + (mask - 1) * 1e9 per row: sigmoid then gives exactly 0 (with a
    zero gradient) on the rows whose {0, 1} mask is 0.  The shift is cast
    to m's dtype first, as the JAX ``fold_mask`` does.

    In float16 the shift is 2^12: JAX's -1e9 overflows to -inf, the edge
    tail's LayerNorm of a masked pair row is then NaN, and the next layer
    reads that row (JAX's f16 dense step is NaN).  A logit 2^12 below a
    real one still gives a sigmoid of exactly 0 in f32, at every order;
    a larger shift (2^14) rounds a masked row's values onto a few f16
    steps, and the second order of its LayerNorm then overflows f16 on
    bench.py's 64-cell batch."""
    shift = MASK_SHIFT_F16 if m.dtype == torch.float16 else MASK_SHIFT
    return m + ((mask - 1.0) * shift).to(m.dtype)[:, None]


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held against)
# ---------------------------------------------------------------------------


def dense_gated_aggregate_plain(m: torch.Tensor, bh: torch.Tensor,
                                D: int) -> torch.Tensor:
    """Block sums over D rows in f32 (JAX ``_xla_dense_aggregate``)."""
    f = m.shape[-1]
    sig = torch.sigmoid(m.float())
    num = (sig * bh.float()).reshape(-1, D, f).sum(dim=1)
    den = sig.reshape(-1, D, f).sum(dim=1)
    return (num / (den + EPS)).to(bh.dtype)


def dense_pair_aggregate_plain(m2: torch.Tensor, bh: torch.Tensor,
                               D: int) -> torch.Tensor:
    """Sums over s in f32 (JAX ``_xla_pair_aggregate``)."""
    f = m2.shape[-1]
    n = bh.shape[0] // D
    sig = torch.sigmoid(m2.float()).reshape(n, D, D, f)
    bh4 = bh.float().reshape(n, 1, D, f)
    num = (sig * bh4).sum(dim=2)
    den = sig.sum(dim=2)
    return (num / (den + EPS)).reshape(n * D, f).to(bh.dtype)


def pair_aggregate_bwd_plain(m2: torch.Tensor, bh: torch.Tensor,
                             g: torch.Tensor, D: int):
    """(dm2, dbh) of K4 at (m2, bh) with cotangent g (JAX
    ``_xla_pair_bwd``): den and h recomputed in f32."""
    f = m2.shape[-1]
    n = bh.shape[0] // D
    sig = torch.sigmoid(m2.float()).reshape(n, D, D, f)
    bh4 = bh.float().reshape(n, 1, D, f)
    den = sig.sum(dim=2) + EPS                       # [n, t, F]
    h = (sig * bh4).sum(dim=2) / den
    g32 = g.float().reshape(n, D, f)
    ginv = (g32 / den)[:, :, None, :]                # [n, t, 1, F]
    gh = (-g32 * h / den)[:, :, None, :]
    dm2 = (sig * (1.0 - sig) * (bh4 * ginv + gh)).reshape(-1, f)
    dbh = (sig * ginv).sum(dim=1).reshape(-1, f)
    return dm2.to(m2.dtype), dbh.to(bh.dtype)


def pair_aggregate_bwd2_plain(m2: torch.Tensor, bh: torch.Tensor,
                              g: torch.Tensor, u: torch.Tensor,
                              v: torch.Tensor, D: int):
    """(c_m2, c_bh, c_g): VJP of K5a at (m2, bh, g) with cotangents u on
    dm2 and v on dbh (JAX ``_xla_pair_bwd2``), all in f32.

    With sig' = sig (1 - sig), sig'' = sig' (1 - 2 sig), den_t = sum_s sig
    + 1e-6, h_t = num_t / den_t, ginv_t = g_t / den_t, gh_t = -g_t h_t /
    den_t, k_t = -g_t / den_t^2 and the row sums A_t = sum_s u sig',
    Bq_t = sum_s u sig' bh_s, C_t = sum_s v_s sig:

      c_g_t   = (Bq_t - h_t A_t + C_t) / den_t
      c_bh_s  = sum_t [u sig' ginv_t + sig k_t A_t]
      c_m2_ts = u sig'' (bh_s ginv_t + gh_t)
                + sig' [k_t (Bq_t - 2 h_t A_t + bh_s A_t + C_t) + v_s ginv_t]
    """
    f = m2.shape[-1]
    n = bh.shape[0] // D
    sig = torch.sigmoid(m2.float()).reshape(n, D, D, f)
    sigp = sig * (1.0 - sig)
    sigpp = sigp * (1.0 - 2.0 * sig)
    bh4 = bh.float().reshape(n, 1, D, f)
    u4 = u.float().reshape(n, D, D, f)
    v4 = v.float().reshape(n, 1, D, f)
    den = sig.sum(dim=2) + EPS                       # [n, t, F]
    h = (sig * bh4).sum(dim=2) / den
    g32 = g.float().reshape(n, D, f)
    ginv = g32 / den
    gh = -g32 * h / den
    a = (u4 * sigp).sum(dim=2)
    bq = (u4 * sigp * bh4).sum(dim=2)
    cc = (v4 * sig).sum(dim=2)
    c_g = ((bq - h * a + cc) / den).reshape(-1, f)
    k = -g32 / (den * den)
    c_bh = (u4 * sigp * ginv[:, :, None, :]
            + sig * (k * a)[:, :, None, :]).sum(dim=1).reshape(-1, f)
    c_m2 = (u4 * sigpp * (bh4 * ginv[:, :, None, :] + gh[:, :, None, :])
            + sigp * (k[:, :, None, :]
                      * ((bq - 2.0 * h * a + cc)[:, :, None, :]
                         + bh4 * a[:, :, None, :])
                      + v4 * ginv[:, :, None, :])).reshape(-1, f)
    return c_m2.to(m2.dtype), c_bh.to(bh.dtype), c_g.to(g.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.library("dense")
    if not getattr(lib, "_alignn_configured", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.alignn_dense_gated_aggregate,
                   lib.alignn_dense_pair_aggregate):
            fn.argtypes = [p, ll, p, ll, p, i, i, i, i, p]
            fn.restype = i
        lib.alignn_pair_aggregate_bwd.argtypes = [p, ll, p, ll, p, ll, p, p,
                                                  i, i, i, i, p]
        lib.alignn_pair_aggregate_bwd.restype = i
        lib.alignn_pair_aggregate_bwd2.argtypes = [p, ll] * 5 + [
            p, p, p, i, i, i, i, p]
        lib.alignn_pair_aggregate_bwd2.restype = i
        lib.alignn_pair_bwd_occupancy.argtypes = [i, i, i, i,
                                                  ctypes.POINTER(i)]
        lib.alignn_pair_bwd_occupancy.restype = i
        lib.alignn_dense_sigmoid_mismatches.argtypes = [
            ctypes.c_ulonglong, ctypes.c_ulonglong, p, p]
        lib.alignn_dense_sigmoid_mismatches.restype = i
        lib._alignn_configured = True
    return lib


ERR_SMEM = -1   # kErrSmem in dense.cu: D too large for a block


def _raise_on_pair(rc: int, name: str, D: int):
    """_raise_on, with a clear error where dense.cu found D too large for
    the shared memory of one K4/K5a/K5b block (K4 takes the D of one
    [D, 128] f32 plane, though it stages none; K5a/K5b a [D*D, W] slab
    or, past it, 3 and 6 [D, 128] planes)."""
    if rc == ERR_SMEM:
        raise ValueError(f"{name}: D = {D} needs more shared memory per "
                         f"block than the card allows")
    _raise_on(rc, name)


def _check(name: str, x: torch.Tensor, rows: int, like: torch.Tensor):
    """x must be a CUDA [rows, F] table of like's F, dtype and device with
    a unit-stride feature axis (any row stride)."""
    if not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported by the "
                        f"kernel (float32, bfloat16, float16)")
    if (x.dim() != 2 or x.stride(1) != 1 or x.shape[0] != rows
            or x.shape[1] != like.shape[-1] or x.dtype != like.dtype
            or x.device != like.device):
        raise ValueError(f"{name}: expects a [{rows}, {like.shape[-1]}] "
                         f"{like.dtype} table on {like.device} with a "
                         f"unit-stride feature axis, got shape "
                         f"{tuple(x.shape)} {x.dtype} strides {x.stride()}")


def _blocks(name: str, x: torch.Tensor, D: int) -> int:
    """The number of D-row blocks of x's rows."""
    if D <= 0 or x.dim() != 2 or x.shape[0] % D:
        raise ValueError(f"{name}: rows of {tuple(x.shape)} must be a "
                         f"multiple of D = {D}")
    return x.shape[0] // D


def dense_gated_aggregate_cuda(m: torch.Tensor, bh: torch.Tensor,
                               D: int) -> torch.Tensor:
    """K3 on the card: [M*D, F] -> [M, F] in m's dtype, f32 sums."""
    n = _blocks("dense_gated_aggregate", m, D)
    _check("dense_gated_aggregate", m, n * D, m)
    _check("dense_gated_aggregate", bh, n * D, m)
    f = m.shape[1]
    out = torch.empty((n, f), dtype=m.dtype, device=m.device)
    if out.numel():
        with torch.cuda.device(m.device):
            rc = _lib().alignn_dense_gated_aggregate(
                m.data_ptr(), m.stride(0), bh.data_ptr(), bh.stride(0),
                out.data_ptr(), n, D, f, _DTYPE_CODE[m.dtype], _stream(m))
        _raise_on(rc, "dense_gated_aggregate")
        dense_gated_aggregate_cuda.launches += 1
    return out


dense_gated_aggregate_cuda.launches = 0


def dense_pair_aggregate_cuda(m2: torch.Tensor, bh: torch.Tensor,
                              D: int) -> torch.Tensor:
    """K4 on the card: m2 [N*D*D, F], bh [N*D, F] -> [N*D, F]."""
    n = _blocks("dense_pair_aggregate", bh, D)
    _check("dense_pair_aggregate", m2, n * D * D, bh)
    _check("dense_pair_aggregate", bh, n * D, bh)
    f = bh.shape[1]
    out = torch.empty((n * D, f), dtype=bh.dtype, device=bh.device)
    if out.numel():
        with torch.cuda.device(bh.device):
            rc = _lib().alignn_dense_pair_aggregate(
                m2.data_ptr(), m2.stride(0), bh.data_ptr(), bh.stride(0),
                out.data_ptr(), n, D, f, _DTYPE_CODE[bh.dtype], _stream(bh))
        _raise_on_pair(rc, "dense_pair_aggregate", D)
        dense_pair_aggregate_cuda.launches += 1
    return out


dense_pair_aggregate_cuda.launches = 0


def pair_aggregate_bwd_cuda(m2: torch.Tensor, bh: torch.Tensor,
                            g: torch.Tensor, D: int):
    """K5a on the card: (dm2 [N*D*D, F], dbh [N*D, F]) in the input dtype."""
    n = _blocks("pair_aggregate_bwd", bh, D)
    _check("pair_aggregate_bwd", m2, n * D * D, bh)
    _check("pair_aggregate_bwd", bh, n * D, bh)
    _check("pair_aggregate_bwd", g, n * D, bh)
    f = bh.shape[1]
    dm2 = torch.empty((n * D * D, f), dtype=bh.dtype, device=bh.device)
    dbh = torch.empty((n * D, f), dtype=bh.dtype, device=bh.device)
    if dbh.numel():
        with torch.cuda.device(bh.device):
            rc = _lib().alignn_pair_aggregate_bwd(
                m2.data_ptr(), m2.stride(0), bh.data_ptr(), bh.stride(0),
                g.data_ptr(), g.stride(0), dm2.data_ptr(), dbh.data_ptr(), n,
                D, f, _DTYPE_CODE[bh.dtype], _stream(bh))
        _raise_on_pair(rc, "pair_aggregate_bwd", D)
        pair_aggregate_bwd_cuda.launches += 1
    return dm2, dbh


pair_aggregate_bwd_cuda.launches = 0


def pair_aggregate_bwd2_cuda(m2: torch.Tensor, bh: torch.Tensor,
                             g: torch.Tensor, u: torch.Tensor,
                             v: torch.Tensor, D: int):
    """K5b on the card: (c_m2 [N*D*D, F], c_bh [N*D, F], c_g [N*D, F]) in
    the input dtype, f32 arithmetic."""
    name = "pair_aggregate_bwd2"
    n = _blocks(name, bh, D)
    for x, rows in ((m2, n * D * D), (bh, n * D), (g, n * D),
                    (u, n * D * D), (v, n * D)):
        _check(name, x, rows, bh)
    f = bh.shape[1]
    c_m2 = torch.empty((n * D * D, f), dtype=bh.dtype, device=bh.device)
    c_bh = torch.empty((n * D, f), dtype=bh.dtype, device=bh.device)
    c_g = torch.empty((n * D, f), dtype=bh.dtype, device=bh.device)
    if c_bh.numel():
        with torch.cuda.device(bh.device):
            rc = _lib().alignn_pair_aggregate_bwd2(
                m2.data_ptr(), m2.stride(0), bh.data_ptr(), bh.stride(0),
                g.data_ptr(), g.stride(0), u.data_ptr(), u.stride(0),
                v.data_ptr(), v.stride(0), c_m2.data_ptr(), c_bh.data_ptr(),
                c_g.data_ptr(), n, D, f, _DTYPE_CODE[bh.dtype], _stream(bh))
        _raise_on_pair(rc, name, D)
        pair_aggregate_bwd2_cuda.launches += 1
    return c_m2, c_bh, c_g


pair_aggregate_bwd2_cuda.launches = 0


def pair_bwd_occupancy(kernel: str, D: int, f: int,
                       dtype: torch.dtype = torch.float32) -> dict:
    """The launch that K5a (``kernel="K5a"``) or K5b (``"K5b"``) makes at
    (D, f, dtype) for 16-byte-aligned inputs, read on the current card:
    ``blocks_per_sm`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    ``smem_bytes`` (dynamic shared memory a block), ``width`` (W, the
    features a block owns; 0 on the two-pass path) and ``threads``."""
    out = (ctypes.c_int * 4)()
    rc = _lib().alignn_pair_bwd_occupancy(
        {"K5a": 0, "K5b": 1}[kernel], D, f, _DTYPE_CODE[dtype], out)
    _raise_on_pair(rc, f"{kernel} occupancy", D)
    return {"blocks_per_sm": out[0], "smem_bytes": out[1],
            "width": out[2], "threads": out[3],
            "path": "slab" if out[2] else "two-pass"}


def sigmoid_mismatches(first: int = 0, count: int = 1 << 32) -> int:
    """On the current card: how many of the f32 bit patterns first ..
    first + count - 1 give a different bit pattern from dense.cu's
    sigmoid (the select below -88.75), or from K4's word-at-a-time
    sigmoid (the reciprocal's fast path where no element needs the slow
    one), than from the exact 1 / (1 + exp(-x)).  The default range is
    every f32."""
    hits = torch.zeros(1, dtype=torch.int64, device="cuda")
    rc = _lib().alignn_dense_sigmoid_mismatches(first, count,
                                                hits.data_ptr(),
                                                _stream(hits))
    _raise_on(rc, "sigmoid_mismatches")
    return int(hits.item())


# ---------------------------------------------------------------------------
# differentiable entry points
# ---------------------------------------------------------------------------


# Inputs may have any stride: each forward hands its kernel unit-stride
# copies and saves the inputs as they came (see ops/eggc.py).


class _DenseGatedAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, bh, D):
        h = _dispatch(m, dense_gated_aggregate_plain,
                      dense_gated_aggregate_cuda, _unit_stride(m),
                      _unit_stride(bh), D)
        ctx.D = D
        ctx.save_for_backward(m, bh, h)
        ctx.save_for_forward(m, bh)
        return h

    @staticmethod
    def backward(ctx, g):
        m, bh, h = ctx.saved_tensors
        D, f = ctx.D, m.shape[-1]
        if gated_bwd_op_enabled():
            return (*gated_aggregate_bwd(m, bh, g, D), None)
        sig = torch.sigmoid(m.float()).reshape(-1, D, f)
        den = (sig.sum(dim=1) + EPS)[:, None, :]       # [M, 1, F]
        g32 = g.float()[:, None, :]
        ginv = g32 / den
        gh = -g32 * h.float()[:, None, :] / den        # dL/dden
        bh3 = bh.float().reshape(-1, D, f)
        dbh = (sig * ginv).reshape(-1, f).to(bh.dtype)
        dm = (sig * (1.0 - sig) * (bh3 * ginv + gh)).reshape(-1, f)
        return dm.to(m.dtype), dbh, None

    @staticmethod
    def jvp(ctx, tm, tbh, _D):
        m, bh = ctx.saved_tensors
        D, f = ctx.D, m.shape[-1]
        return _block_jvp(m.reshape(-1, D, f), bh.reshape(-1, D, f),
                          None if tm is None else tm.reshape(-1, D, f),
                          None if tbh is None else tbh.reshape(-1, D, f),
                          1).to(bh.dtype)


def gated_bwd_op_enabled() -> bool:
    """JAX's ``ALIGNN_TPU_GATED_BWD_OP``: K3's backward through the
    first-class :func:`gated_aggregate_bwd` (opt-in; JAX measured it 0.9 %
    slower on its TPU step)."""
    return os.environ.get("ALIGNN_TPU_GATED_BWD_OP", "") not in ("", "0")


def _expand(x: torch.Tensor, D: int) -> torch.Tensor:
    """[M, F] -> [M*D, F] row broadcast (D-block layout)."""
    return x[:, None, :].expand(x.shape[0], D, x.shape[1]).reshape(
        -1, x.shape[1])


def gated_aggregate_bwd_plain(m: torch.Tensor, bh: torch.Tensor,
                              g: torch.Tensor, D: int):
    """(dm, dbh), the VJP of K3 at (m, bh) with cotangent g (JAX
    ``_xla_gated_bwd``): den and h recomputed in f32 from the primals, so
    that they stay differentiable functions of them."""
    f = m.shape[-1]
    sig = torch.sigmoid(m.float())
    bh32 = bh.float()
    den = sig.reshape(-1, D, f).sum(dim=1) + EPS
    h = (sig * bh32).reshape(-1, D, f).sum(dim=1) / den
    g32 = g.float()
    ginv_e = _expand(g32 / den, D)
    gh_e = _expand(-g32 * h / den, D)
    dbh = (sig * ginv_e).to(bh.dtype)
    dm = (sig * (1.0 - sig) * (bh32 * ginv_e + gh_e)).to(m.dtype)
    return dm, dbh


def gated_aggregate_bwd2_plain(m: torch.Tensor, bh: torch.Tensor,
                               g: torch.Tensor, u: torch.Tensor,
                               v: torch.Tensor, D: int):
    """(c_m, c_bh, c_g), the VJP of (m, bh, g) -> (dm, dbh) with
    cotangents (u, v) (JAX ``_xla_gated_bwd2``).  With sig' = sig(1-sig),
    sig'' = sig'(1-2 sig), den = sum_s sig + eps, h = num/den,
    ginv = g/den, gh = -g h/den, k = -g/den^2 and the row sums
    A = sum_s u sig', Bq = sum_s u sig' bh, C = sum_s v sig:

      c_g    = (Bq - h A + C) / den
      c_bh_s = u sig' ginv + sig k A
      c_m_s  = u sig'' (bh ginv + gh)
               + sig' [ k (Bq - 2 h A + bh A + C) + v ginv ]
    """
    f = m.shape[-1]
    sig = torch.sigmoid(m.float())
    sigp = sig * (1.0 - sig)
    sigpp = sigp * (1.0 - 2.0 * sig)
    bh32, u32, v32 = bh.float(), u.float(), v.float()

    def rows(x):
        return x.reshape(-1, D, f).sum(dim=1)

    den = rows(sig) + EPS
    h = rows(sig * bh32) / den
    g32 = g.float()
    ginv, gh, k = g32 / den, -g32 * h / den, -g32 / (den * den)
    a, bq, cc = rows(u32 * sigp), rows(u32 * sigp * bh32), rows(v32 * sig)
    c_g = ((bq - h * a + cc) / den).to(g.dtype)
    ginv_e = _expand(ginv, D)
    c_bh = (u32 * sigp * ginv_e + sig * _expand(k * a, D)).to(bh.dtype)
    c_m = (u32 * sigpp * (bh32 * ginv_e + _expand(gh, D))
           + sigp * (_expand(k, D) * (_expand(bq - 2.0 * h * a + cc, D)
                                      + bh32 * _expand(a, D))
                     + v32 * ginv_e)).to(m.dtype)
    return c_m, c_bh, c_g


class _GatedAggregateBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, bh, g, D):
        ctx.D = D
        ctx.save_for_backward(m, bh, g)
        return gated_aggregate_bwd_plain(m, bh, g, D)

    @staticmethod
    def backward(ctx, u, v):
        m, bh, g = ctx.saved_tensors
        return (*gated_aggregate_bwd2_plain(m, bh, g, u, v, ctx.D), None)


def gated_aggregate_bwd(m: torch.Tensor, bh: torch.Tensor, g: torch.Tensor,
                        D: int):
    """(dm, dbh) = VJP of :func:`dense_gated_aggregate` at (m, bh) with
    cotangent g; its own VJP is the hand-derived
    :func:`gated_aggregate_bwd2_plain` (differentiable once more through
    autograd)."""
    return _GatedAggregateBwd.apply(m, bh, g, D)


def dense_gated_aggregate(m: torch.Tensor, bh: torch.Tensor,
                          D: int) -> torch.Tensor:
    """Blockwise normalised sigmoid(m) * bh (K3); mask pre-folded.

    m, bh: [M*D, F] in D-row blocks; returns [M, F].
    """
    return _DenseGatedAggregate.apply(m, bh, D)


class _DensePairAggregate(torch.autograd.Function):
    """h from m2; the backward reads `m2_res`, the residual saved in m2's
    place (m2 itself, or its fp8 round trip), an input so that the
    second order reaches m2 through it."""

    @staticmethod
    def forward(ctx, m2, m2_res, bh, D):
        h = _dispatch(bh, dense_pair_aggregate_plain,
                      dense_pair_aggregate_cuda, _unit_stride(m2),
                      _unit_stride(bh), D)
        ctx.D = D
        ctx.save_for_backward(m2_res, bh)
        ctx.save_for_forward(m2, bh)
        return h

    @staticmethod
    def backward(ctx, g):
        m2_res, bh = ctx.saved_tensors
        dm2, dbh = pair_aggregate_bwd(m2_res, bh, g, ctx.D)
        return dm2, None, dbh, None

    @staticmethod
    def jvp(ctx, tm2, _tres, tbh, _D):
        m2, bh = ctx.saved_tensors
        D, f = ctx.D, m2.shape[-1]
        n = bh.shape[0] // D
        return _block_jvp(
            m2.reshape(n, D, D, f), bh.reshape(n, 1, D, f),
            None if tm2 is None else tm2.reshape(n, D, D, f),
            None if tbh is None else tbh.reshape(n, 1, D, f),
            2).reshape(n * D, f).to(bh.dtype)


def _block_jvp(m, bh, tm, tbh, dim: int) -> torch.Tensor:
    """Tangent of sum sig(m) bh / (sum sig(m) + eps) over `dim`:
    (sum(sig' tm bh + sig tbh) - h sum(sig' tm)) / den, in f32 (the
    forward-mode rule of K3 and K4, in differentiable torch ops)."""
    sig = torch.sigmoid(m.float())
    bh = bh.float()
    dsig = sig * (1.0 - sig) * tm.float() if tm is not None else \
        torch.zeros_like(sig)
    dbh = tbh.float() if tbh is not None else torch.zeros_like(bh)
    den = sig.sum(dim=dim) + EPS
    h = (sig * bh).sum(dim=dim) / den
    return ((dsig * bh + sig * dbh).sum(dim=dim)
            - h * dsig.sum(dim=dim)) / den


def dense_pair_aggregate(m2: torch.Tensor, bh: torch.Tensor,
                         D: int) -> torch.Tensor:
    """h[j,t] = sum_s sig(m2[j,t,s]) bh[j,s] / (sum_s sig + 1e-6) (K4).

    m2: [N*D*D, F] rows (j, t, s), s fastest, mask pre-folded; bh:
    [N*D, F] rows (j, s).  Returns [N*D, F] rows (j, t); the caller maps
    row (j, t) to the edge rev[j*D+t].  With ``ALIGNN_TPU_FP8_LTABLES``
    set the backward reads m2 through the e4m3 round trip (JAX
    ``_pair_fwd``'s residual), the forward the exact m2.
    """
    res = fp8_round_trip(m2) if fp8_ltables_enabled() else m2
    return _DensePairAggregate.apply(m2, res, bh, D)


class _PairAggregateBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m2, bh, g, D):
        ctx.D = D
        ctx.save_for_backward(m2, bh, g)
        return _dispatch(bh, pair_aggregate_bwd_plain,
                         pair_aggregate_bwd_cuda, _unit_stride(m2),
                         _unit_stride(bh), _unit_stride(g), D)

    @staticmethod
    def backward(ctx, u, v):
        m2, bh, g = ctx.saved_tensors
        return (*pair_aggregate_bwd2(m2, bh, g, u, v, ctx.D), None)


class _PairAggregateBwd2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m2, bh, g, u, v, D):
        return _dispatch(bh, pair_aggregate_bwd2_plain,
                         pair_aggregate_bwd2_cuda,
                         *(_unit_stride(x) for x in (m2, bh, g, u, v)), D)

    @staticmethod
    def backward(ctx, *cotangents):
        raise NotImplementedError(
            "the third derivative of the dense pair aggregation (the VJP "
            "of K5b) is not implemented: no training objective needs it")


def pair_aggregate_bwd(m2: torch.Tensor, bh: torch.Tensor, g: torch.Tensor,
                       D: int):
    """(dm2, dbh) = VJP of :func:`dense_pair_aggregate` at (m2, bh) with
    cotangent g (K5a).  Its own VJP is K5b (:func:`pair_aggregate_bwd2`);
    a third derivative raises."""
    return _PairAggregateBwd.apply(m2, bh, g, D)


def pair_aggregate_bwd2(m2: torch.Tensor, bh: torch.Tensor, g: torch.Tensor,
                        u: torch.Tensor, v: torch.Tensor, D: int):
    """(c_m2, c_bh, c_g) = VJP of :func:`pair_aggregate_bwd` at (m2, bh, g)
    with cotangents (u, v) on (dm2, dbh) (K5b).  Not differentiable."""
    return _PairAggregateBwd2.apply(m2, bh, g, u, v, D)
