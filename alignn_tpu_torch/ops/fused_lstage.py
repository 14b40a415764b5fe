"""The fused dense L-stage, forward (K6) and backward (K7), with gradients.

Counterpart of ``alignn_tpu/ops/pallas_fused_lstage.py``.  In the dense
layout (:mod:`alignn_tpu_torch.graph.dense`) the L-stage of an ALIGNN
layer is, per node j with in-edges s, t < D:

    eg        = z @ W + b                  # [N*D*D, F] x [F, F]
    m2[j,t,s] = sg_f[j,s] + dg_f[j,t] + eg[j,t,s]
    h[j,t]    = sum_s sig(m2) bh[j,s] / (sum_s sig(m2) + 1e-6)
    e_new     = z + silu(layernorm(m2))    # the next layer's z

The edge mask is folded into both sg_f and dg_f as (em - 1) * 1e9, so a
pair is masked iff either side is.  Masked rows of e_new are finite
garbage, as in JAX; the model never reads them.

- K6 ``fused_pair_lstage``: the whole chain in one kernel, the z W product
  included, m2 kept out of device memory.  Replaces ``_kernel``
  (``pallas_fused_lstage.py:103``, launched at ``:141``); its plain version
  is ``_xla_fused`` (``:79-100``).
- K7 ``fused_lstage_bwd``: the first-order VJP, all eight cotangents
  (dz, dW, db, dsg, ddg, dbh, dscale, dbias).  Replaces ``_bwd_kernel``
  (``:294``, launched at ``:385``); its plain version is ``_bwd_body``
  (``:215-275``), dm2 rounded to z's dtype before the two products.
- The second order is autograd of the plain backward recomputed from the
  saved inputs, as JAX's ``_bwd_op_bwd`` is ``jax.vjp`` of ``_bwd_body``.
  A third derivative raises: nothing needs one.

Both kernels are in ``csrc/fused_lstage.cu``, for F 128 or 256, with their
products on the tensor cores: bf16 natively, f32 by the 3xTF32 split.
Bound on an H100 SXM at the dense training batch (86,528 pair rows, F 256,
f32): by operations at 165 TFLOP/s of f32-grade products (three TF32
products each), K6 0.069 ms (one product, 11.3 GFLOP), K7 0.206 ms (three).

Dispatch rule of every wrapper (as in :mod:`alignn_tpu_torch.ops.eggc`):
a tensor on the CPU takes the plain PyTorch version (``*_plain``); a CUDA
tensor launches the kernel or raises.  The kernel wrappers count their
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from alignn_tpu_torch import _build
from alignn_tpu_torch.ops.dense import _blocks, _check, _raise_on_pair, _stream
from alignn_tpu_torch.ops.eggc import _DTYPE_CODE, _dispatch, _unit_stride

EPS = 1e-6       # aggregation denominator
LN_EPS = 1e-5    # the LayerNorm of norm_edges
FEATURES = (128, 256)   # the feature widths the kernels are built for
ERR_TILE = -2   # kErrTile in fused_lstage.cu: a t-group exceeds the row tile


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held against)
# ---------------------------------------------------------------------------


def _forward_terms(z, w, b, sg_f, dg_f, bh, D):
    """(m2 [n, t, s, F], sig, bh4, den) in f32; den includes the 1e-6."""
    f = z.shape[-1]
    n = sg_f.shape[0] // D
    eg = z.float() @ w.to(z.dtype).float() + b.float()
    m2 = (eg.reshape(n, D, D, f) + sg_f.float().reshape(n, 1, D, f)
          + dg_f.float().reshape(n, D, 1, f))
    sig = torch.sigmoid(m2)
    bh4 = bh.float().reshape(n, 1, D, f)
    return m2, sig, bh4, sig.sum(dim=2) + EPS


def _layer_norm(m2r, scale, bias):
    """(xhat, rstd, ln) of the rows of m2r, two-pass variance."""
    mean = m2r.mean(dim=-1, keepdim=True)
    var = ((m2r - mean) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    xhat = (m2r - mean) * rstd
    return xhat, rstd, xhat * scale.float() + bias.float()


def fused_pair_lstage_plain(z, w, b, sg_f, dg_f, bh, scale, bias, D: int):
    """(e_new, h) in f32 arithmetic (JAX ``_xla_fused``)."""
    f = z.shape[-1]
    m2, sig, bh4, den = _forward_terms(z, w, b, sg_f, dg_f, bh, D)
    h = ((sig * bh4).sum(dim=2) / den).reshape(-1, f).to(bh.dtype)
    _xhat, _rstd, ln = _layer_norm(m2.reshape(-1, f), scale, bias)
    return (z.float() + F.silu(ln)).to(z.dtype), h


def fused_lstage_bwd_plain(z, w, b, sg_f, dg_f, bh, scale, bias, de, dh,
                           D: int):
    """(dz, dW, db, dsg, ddg, dbh, dscale, dbias) of
    :func:`fused_pair_lstage_plain` with cotangents de on e_new and dh on h
    (JAX ``_bwd_body``): m2 recomputed from the inputs, f32 arithmetic, dm2
    rounded to z's dtype before dz = de + dm2 W^T and dW = z^T dm2."""
    f = z.shape[-1]
    n = sg_f.shape[0] // D
    m2, sig, bh4, den = _forward_terms(z, w, b, sg_f, dg_f, bh, D)
    h = (sig * bh4).sum(dim=2) / den
    # aggregation cotangents
    dh32 = dh.float().reshape(n, D, f)
    ginv = (dh32 / den)[:, :, None, :]                # [n, t, 1, F]
    gh = (-dh32 * h / den)[:, :, None, :]
    dm2_agg = sig * (1.0 - sig) * (bh4 * ginv + gh)   # [n, t, s, F]
    dbh = (sig * ginv).sum(dim=1).reshape(-1, f).to(bh.dtype)
    # norm + silu + residual cotangents
    xhat, rstd, ln = _layer_norm(m2.reshape(-1, f), scale, bias)
    sig_ln = torch.sigmoid(ln)
    dln = de.float() * (sig_ln * (1.0 + ln * (1.0 - sig_ln)))
    dscale = (dln * xhat).sum(dim=0).to(scale.dtype)
    dbias = dln.sum(dim=0).to(bias.dtype)
    dxhat = dln * scale.float()
    dm2_norm = rstd / f * (f * dxhat - dxhat.sum(dim=-1, keepdim=True)
                           - xhat * (dxhat * xhat).sum(dim=-1, keepdim=True))
    dm2 = dm2_agg.reshape(-1, f) + dm2_norm           # [N*D*D, F] f32
    dm2_c = dm2.to(z.dtype).float()
    wz = w.to(z.dtype).float()
    dz = (de.float() + dm2_c @ wz.t()).to(z.dtype)
    dw = (z.float().t() @ dm2_c).to(w.dtype)
    db = dm2.sum(dim=0).to(b.dtype)
    dm4 = dm2.reshape(n, D, D, f)
    dsg = dm4.sum(dim=1).reshape(-1, f).to(sg_f.dtype)
    ddg = dm4.sum(dim=2).reshape(-1, f).to(dg_f.dtype)
    return dz, dw, db, dsg, ddg, dbh, dscale, dbias


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.library("fused_lstage")
    if not getattr(lib, "_alignn_configured", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.alignn_fused_lstage_fwd.argtypes = [
            p, ll, p, p, p, p, ll, p, ll, p, ll, p, p, p, p, i, i, i, i, p]
        lib.alignn_fused_lstage_fwd.restype = i
        lib.alignn_fused_lstage_bwd.argtypes = [
            p, ll, p, p, p, p, ll, p, ll, p, ll, p, p, p, ll, p, ll,
            p, p, p, p, p, p, p, p, i, i, i, i, p]
        lib.alignn_fused_lstage_bwd.restype = i
        lib.alignn_fused_lstage_bwd_scratch.argtypes = [i, i, i]
        lib.alignn_fused_lstage_bwd_scratch.restype = ll
        lib._alignn_configured = True
    return lib


def _raise_on_fused(rc: int, name: str, D: int):
    """The error mapping of ``ops/dense.py``, with K6/K7's own limit: a
    t-group of D pair rows must fit the kernels' 64-row tile."""
    if rc == ERR_TILE:
        raise ValueError(f"{name}: D = {D} is over the kernel's limit: a "
                         f"t-group of D pair rows must fit its 64-row tile")
    _raise_on_pair(rc, name, D)


def _operands(name, z, w, b, sg_f, dg_f, bh, scale, bias, D):
    """Checks the operands; (n, F, z with 16-byte rows, W and W^T in z's
    dtype, f32 b, scale, bias)."""
    n = _blocks(name, sg_f, D)
    _check(name, z, n * D * D, z)
    for x in (sg_f, dg_f, bh):
        _check(name, x, n * D, z)
    f = z.shape[1]
    if f not in FEATURES:
        raise ValueError(f"{name}: the kernel is built for F in {FEATURES}, "
                         f"got F = {f}")
    if w.shape != (f, f) or w.device != z.device:
        raise ValueError(f"{name}: w must be [{f}, {f}] on {z.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    vecs = []
    for v in (b, scale, bias):
        if v.shape != (f,) or v.device != z.device:
            raise ValueError(f"{name}: vectors must be [{f}] on {z.device}, "
                             f"got {tuple(v.shape)} on {v.device}")
        vecs.append(v.float().contiguous())
    if z.data_ptr() % 16 or z.stride(0) * z.element_size() % 16:
        z = z.contiguous()   # the kernels stage z with 16-byte copies
    wz = w.to(z.dtype).contiguous()
    return n, f, z, wz, wz.t().contiguous(), vecs


def fused_pair_lstage_cuda(z, w, b, sg_f, dg_f, bh, scale, bias, D: int):
    """K6 on the card: (e_new [N*D*D, F], h [N*D, F]) in z's dtype."""
    name = "fused_pair_lstage"
    n, f, z, wz, wt, (b32, sc32, bi32) = _operands(
        name, z, w, b, sg_f, dg_f, bh, scale, bias, D)
    e_new = torch.empty((n * D * D, f), dtype=z.dtype, device=z.device)
    h = torch.empty((n * D, f), dtype=z.dtype, device=z.device)
    if h.numel():
        with torch.cuda.device(z.device):
            rc = _lib().alignn_fused_lstage_fwd(
                z.data_ptr(), z.stride(0), wz.data_ptr(), wt.data_ptr(),
                b32.data_ptr(),
                sg_f.data_ptr(), sg_f.stride(0), dg_f.data_ptr(),
                dg_f.stride(0), bh.data_ptr(), bh.stride(0), sc32.data_ptr(),
                bi32.data_ptr(), e_new.data_ptr(), h.data_ptr(), n, D, f,
                _DTYPE_CODE[z.dtype], _stream(z))
        _raise_on_fused(rc, name, D)
        fused_pair_lstage_cuda.launches += 1
    return e_new, h


fused_pair_lstage_cuda.launches = 0


def fused_lstage_bwd_cuda(z, w, b, sg_f, dg_f, bh, scale, bias, de, dh,
                          D: int):
    """K7 on the card: (dz, dW, db, dsg, ddg, dbh, dscale, dbias); the
    tables in z's dtype, dW and the vectors in the dtypes of w, b, scale
    and bias, f32 arithmetic.  dW, the vectors, dsg and dbh are summed from
    per-chunk and per-tile partials in a fixed order (no atomics)."""
    name = "fused_lstage_bwd"
    n, f, z, wz, wt, (b32, sc32, bi32) = _operands(
        name, z, w, b, sg_f, dg_f, bh, scale, bias, D)
    _check(name, de, n * D * D, z)
    _check(name, dh, n * D, z)
    rows, dev = n * D * D, z.device

    def table(r):
        return torch.empty((r, f), dtype=z.dtype, device=dev)

    dz, dm2c = table(rows), table(rows)
    dsg, ddg, dbh = table(n * D), table(n * D), table(n * D)
    floats = _lib().alignn_fused_lstage_bwd_scratch(n, D, f)
    if floats < 0:
        _raise_on_fused(floats, name, D)
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    dw = torch.zeros((f, f), dtype=torch.float32, device=dev)
    vec = torch.zeros((3, f), dtype=torch.float32, device=dev)
    if rows:
        with torch.cuda.device(dev):
            rc = _lib().alignn_fused_lstage_bwd(
                z.data_ptr(), z.stride(0), wz.data_ptr(), wt.data_ptr(),
                b32.data_ptr(), sg_f.data_ptr(), sg_f.stride(0),
                dg_f.data_ptr(), dg_f.stride(0), bh.data_ptr(), bh.stride(0),
                sc32.data_ptr(), bi32.data_ptr(), de.data_ptr(), de.stride(0),
                dh.data_ptr(), dh.stride(0), dz.data_ptr(), dsg.data_ptr(),
                ddg.data_ptr(), dbh.data_ptr(), dm2c.data_ptr(),
                scratch.data_ptr(), dw.data_ptr(), vec.data_ptr(), n, D, f,
                _DTYPE_CODE[z.dtype], _stream(z))
        _raise_on_fused(rc, name, D)
        fused_lstage_bwd_cuda.launches += 1
    return (dz, dw.to(w.dtype), vec[0].to(b.dtype), dsg, ddg, dbh,
            vec[1].to(scale.dtype), vec[2].to(bias.dtype))


fused_lstage_bwd_cuda.launches = 0


# ---------------------------------------------------------------------------
# differentiable entry point
#
# Both Functions save their inputs as they came and hand the kernels
# unit-stride copies (see ops/eggc.py).
# ---------------------------------------------------------------------------


class _FusedPairLStage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, w, b, sg_f, dg_f, bh, scale, bias, D):
        ctx.D = D
        ctx.save_for_backward(z, w, b, sg_f, dg_f, bh, scale, bias)
        return _dispatch(z, fused_pair_lstage_plain, fused_pair_lstage_cuda,
                         _unit_stride(z), w, b, _unit_stride(sg_f),
                         _unit_stride(dg_f), _unit_stride(bh), scale, bias, D)

    @staticmethod
    def backward(ctx, de, dh):
        return (*_FusedLStageBwd.apply(*ctx.saved_tensors, de, dh, ctx.D),
                None)


class _FusedLStageBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, w, b, sg_f, dg_f, bh, scale, bias, de, dh, D):
        ctx.D = D
        ctx.save_for_backward(z, w, b, sg_f, dg_f, bh, scale, bias, de, dh)
        return _dispatch(z, fused_lstage_bwd_plain, fused_lstage_bwd_cuda,
                         _unit_stride(z), w, b, _unit_stride(sg_f),
                         _unit_stride(dg_f), _unit_stride(bh), scale, bias,
                         _unit_stride(de), _unit_stride(dh), D)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cotangents):
        """Autograd of the plain backward, recomputed from the saved
        inputs; a further derivative raises (``once_differentiable``)."""
        saved = ctx.saved_tensors
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(True) for x in saved]
            outs = fused_lstage_bwd_plain(*xs, ctx.D)
            grads = torch.autograd.grad(outs, xs, cotangents,
                                        allow_unused=True)
        return (*grads, None)


def fused_pair_lstage(z, w, b, sg_f, dg_f, bh, scale, bias, D: int):
    """(e_new, h_jt) of the dense L-stage (module docstring math).

    z: [N*D*D, F] pair rows (j, t, s), s fastest; w [F, F] (in x out, the
    flax kernel, i.e. ``nn.Linear.weight.t()``) and b: the edge_gate
    Dense; sg_f, dg_f, bh: [N*D, F] gate tables with the edge mask folded
    into sg_f and dg_f; scale, bias: the LayerNorm's.  Returns e_new
    [N*D*D, F] and h_jt [N*D, F] rows (j, t): the caller maps row (j, t)
    to the edge rev[j*D+t].
    """
    return _FusedPairLStage.apply(z, w, b, sg_f, dg_f, bh, scale, bias, D)
