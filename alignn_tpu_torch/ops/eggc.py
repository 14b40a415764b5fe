"""Edge-gated aggregation (K1) and sorted segment sum (K2) with gradients.

Counterpart of ``alignn_tpu/ops/pallas_eggc.py``.  Both reductions run
over dst-sorted edges, so a segment is the contiguous row range
``[row_ptr[n], row_ptr[n+1])`` of a CSR pointer built once per batch
(:class:`Segments`).

- K1 ``gated_aggregate``: h[n] = sum sigma(m_e) bh_e / (sum sigma(m_e) + 1e-6),
  hand-written CUDA kernel ``csrc/eggc.cu`` (replaces the Pallas
  ``_kernel``).  Its backward is the JAX ``_bwd``: den recomputed in f32
  through K2, then one gather of ``[g/den | -g h/den]`` to the edges.
- K2 ``sorted_segment_sum``: out[n] = sum x_e, same file (replaces
  ``_ssum_kernel``).  Its backward is ``sorted_gather`` (a row index),
  whose backward is K2 again, so every derivative order of a
  dst-side gather transposes into K2.  ``gather_nodes`` sends the
  transpose of the unsorted src / lg_src gathers through K2 by the
  precomputed argsort permutation (``permute_rows``).
- ``weighted_aggregate``: the same normalised sum for gates that carry
  soft edge weights (the envelope-weighted models); its packed sums run
  through K2, so K1 is bypassed.
- Each gather and segment sum takes the static gather window of its
  index array (``window``, 0 = none), carried into every VJP as JAX
  carries it: with a usable window the forward gathers run the windowed
  gather K8 (:mod:`alignn_tpu_torch.ops.gather`), trash rows reading 0.

Dispatch rule of every wrapper: a tensor on the CPU takes the plain
PyTorch version (``*_plain``); a CUDA tensor launches the kernel or
raises.  The kernel wrappers count their launches in ``.launches``.

Every Function also has a forward-mode rule (``jvp``, for
``torch.autograd.forward_ad``: the forward-over-reverse step of
``train/fjvp.py``).  The linear ones apply themselves to the tangent (a
gather's tangent is the same gather, a segment sum's the same sum), so
the tangent runs the same kernels; K1's tangent is its closed form over
one K2 call.  Each rule is built of differentiable ops and Functions, so
a reverse pass can sweep the tangent.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import torch

from alignn_tpu_torch import _build
from alignn_tpu_torch._build import _raise_on, _stream
from alignn_tpu_torch.ops.gather import windowed_gather
from alignn_tpu_torch.ops.segment import edge_gated_aggregate, segment_sum

EPS = 1e-6
CHUNK_ROWS = 32    # rows per kernel work item (one warp each)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@dataclass(frozen=True)
class Segments:
    """Ascending segment ids with their CSR pointer and kernel work items.

    The kernels cut every segment into items of at most ``CHUNK_ROWS``
    rows (item i covers rows ``[item_rows[i], item_rows[i+1])``, segment n
    owns items ``[item_ptr[n], item_ptr[n+1])``, ``owner[i]`` is the
    segment of item i), so that a long segment, such as the trash slot of
    a padded batch, spreads over many warps.  The items of a segment of
    several combine their sums through ``counters``, arrival counts that
    are 0 between launches.  Built once per batch.

    A Segments is used by one kernel launch at a time, on one stream: two
    launches in flight at once would share its counters.
    """

    ids: torch.Tensor        # [E] int64, ascending, in [0, num)
    row_ptr: torch.Tensor    # [num + 1] int32
    item_rows: torch.Tensor  # [num_items + 1] int32
    item_ptr: torch.Tensor   # [num + 1] int32
    owner: torch.Tensor      # [num_items] int32 (num: a padding item)
    counters: torch.Tensor   # [2 * num_items] int32, zeros
    num: int
    num_items: int

    @staticmethod
    def from_sorted(ids: torch.Tensor, num: int) -> "Segments":
        """CSR pointer and work items of ascending ids in [0, num)."""
        dev = ids.device
        row_ptr = torch.searchsorted(
            ids, torch.arange(num + 1, device=dev, dtype=ids.dtype))
        chunks = (row_ptr[1:] - row_ptr[:-1] + CHUNK_ROWS - 1) // CHUNK_ROWS
        item_ptr = torch.zeros(num + 1, device=dev, dtype=torch.int64)
        torch.cumsum(chunks, 0, out=item_ptr[1:])
        # one host sync per batch: the item count sizes the launch
        num_items, first, last = torch.stack(
            [item_ptr[-1], row_ptr[0], row_ptr[-1]]).tolist()
        if first != 0 or last != ids.shape[0]:
            raise ValueError(f"segment ids must lie in [0, {num})")
        owner = torch.repeat_interleave(
            torch.arange(num, device=dev), chunks, output_size=num_items)
        k = torch.arange(num_items, device=dev) - item_ptr[owner]
        item_rows = torch.cat([row_ptr[owner] + k * CHUNK_ROWS,
                               row_ptr[-1:]])
        i32 = torch.int32
        return Segments(ids=ids, row_ptr=row_ptr.to(i32),
                        item_rows=item_rows.to(i32),
                        item_ptr=item_ptr.to(i32), owner=owner.to(i32),
                        counters=torch.zeros(2 * num_items, device=dev,
                                             dtype=i32),
                        num=int(num), num_items=int(num_items))

    def max_items(self) -> int:
        """The most work items any ids of this length over ``num``
        segments can need: one per non-empty segment plus one per
        ``CHUNK_ROWS`` rows."""
        rows = int(self.ids.shape[0])
        return rows // CHUNK_ROWS + min(self.num, rows) + 1

    def with_capacity(self, capacity: int) -> "Segments":
        """The same segments launched as `capacity` work items.

        The items past ``num_items`` cover the empty row range at the end
        and belong to no segment (owner ``num``): the kernels skip them,
        and the sums are unchanged.  A CUDA graph captured on such
        segments keeps its launch sizes and buffers for any ids of the
        same length (ff/step_loop.py)."""
        extra = capacity - self.num_items
        if extra < 0:
            raise ValueError(f"capacity {capacity} < {self.num_items} "
                             "work items")
        if extra == 0:
            return self
        rows = torch.cat([self.item_rows, self.item_rows[-1:].expand(extra)])
        owner = torch.cat([self.owner, self.owner.new_full((extra,),
                                                           self.num)])
        return dataclasses.replace(
            self, item_rows=rows, owner=owner,
            counters=self.counters.new_zeros(2 * capacity),
            num_items=capacity)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held against)
# ---------------------------------------------------------------------------


def sorted_segment_sum_plain(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """index_add over the segment ids, accumulated in (at least) f32."""
    return segment_sum(x.to(_acc_dtype(x.dtype)), seg.ids,
                       seg.num).to(x.dtype)


def gated_aggregate_plain(m: torch.Tensor, bh: torch.Tensor,
                          seg: Segments) -> torch.Tensor:
    """sigmoid gate + index_add sums, accumulated in (at least) f32."""
    acc = _acc_dtype(m.dtype)
    sigma = torch.sigmoid(m.to(acc))
    return edge_gated_aggregate(bh.to(acc), sigma, seg.ids, seg.num,
                                eps=EPS).to(m.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.library("eggc")
    if not getattr(lib, "_alignn_configured", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.alignn_eggc_gated_aggregate.argtypes = [p, ll, p, ll, p, i, p, p,
                                                    p, p, p, p, i, i, i, p]
        lib.alignn_eggc_gated_aggregate.restype = i
        lib.alignn_sorted_segment_sum.argtypes = [p, ll, p, i, p, p, p, p, p,
                                                  p, i, i, i, p]
        lib.alignn_sorted_segment_sum.restype = i
        lib._alignn_configured = True
    return lib


def _check_rows(name: str, x: torch.Tensor, seg: Segments):
    if not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported by the "
                        f"kernel (float32, bfloat16, float16)")
    if x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"{name}: expects a [rows, F] tensor with a "
                         f"unit-stride feature axis, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.shape[0] != seg.ids.shape[0]:
        raise ValueError(f"{name}: {x.shape[0]} rows for "
                         f"{seg.ids.shape[0]} segment ids")
    for idx, size in ((seg.item_rows, seg.num_items + 1),
                      (seg.item_ptr, seg.num + 1),
                      (seg.owner, seg.num_items), (seg.row_ptr, seg.num + 1),
                      (seg.counters, 2 * seg.num_items)):
        if (idx.device != x.device or idx.dtype != torch.int32
                or not idx.is_contiguous() or idx.numel() != size):
            raise ValueError(f"{name}: segment work items must be "
                             f"contiguous int32 tensors on {x.device}")


def gated_aggregate_cuda(m: torch.Tensor, bh: torch.Tensor,
                         seg: Segments) -> torch.Tensor:
    """K1 on the card: out [num, F] in m's dtype, f32 accumulation."""
    _check_rows("gated_aggregate", m, seg)
    if bh.shape != m.shape or bh.dtype != m.dtype or \
            bh.device != m.device or bh.stride(1) != 1:
        raise ValueError("gated_aggregate: bh must match m in shape, dtype "
                         "and device, with a unit-stride feature axis")
    f = m.shape[1]
    out = torch.empty((seg.num, f), dtype=m.dtype, device=m.device)
    if out.numel():
        partial = torch.empty((2, seg.num_items, f), dtype=torch.float32,
                              device=m.device)
        with torch.cuda.device(m.device):
            rc = _lib().alignn_eggc_gated_aggregate(
                m.data_ptr(), m.stride(0), bh.data_ptr(), bh.stride(0),
                seg.item_rows.data_ptr(), seg.num_items,
                seg.item_ptr.data_ptr(), seg.owner.data_ptr(),
                seg.row_ptr.data_ptr(), seg.counters.data_ptr(),
                partial.data_ptr(), out.data_ptr(), seg.num, f,
                _DTYPE_CODE[m.dtype], _stream(m))
        _raise_on(rc, "gated_aggregate")
        gated_aggregate_cuda.launches += 1
    return out


gated_aggregate_cuda.launches = 0


def sorted_segment_sum_cuda(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """K2 on the card: out [num, F] in x's dtype, f32 accumulation."""
    _check_rows("sorted_segment_sum", x, seg)
    f = x.shape[1]
    out = torch.empty((seg.num, f), dtype=x.dtype, device=x.device)
    if out.numel():
        partial = torch.empty((seg.num_items, f), dtype=torch.float32,
                              device=x.device)
        with torch.cuda.device(x.device):
            rc = _lib().alignn_sorted_segment_sum(
                x.data_ptr(), x.stride(0), seg.item_rows.data_ptr(),
                seg.num_items, seg.item_ptr.data_ptr(), seg.owner.data_ptr(),
                seg.row_ptr.data_ptr(), seg.counters.data_ptr(),
                partial.data_ptr(), out.data_ptr(), seg.num, f,
                _DTYPE_CODE[x.dtype], _stream(x))
        _raise_on(rc, "sorted_segment_sum")
        sorted_segment_sum_cuda.launches += 1
    return out


sorted_segment_sum_cuda.launches = 0


def _dispatch(x: torch.Tensor, plain, kernel, *args):
    if x.device.type == "cpu":
        return plain(*args)
    if x.device.type == "cuda":
        return kernel(*args)
    raise ValueError(f"no kernel for device {x.device}")


def _unit_stride(x: torch.Tensor) -> torch.Tensor:
    """The kernels take any row stride but need a unit-stride feature axis.

    The copy feeds the kernel only.  An autograd Function saves its own
    inputs and outputs, never this copy: a saved tensor that is neither
    has no graph, so a double backward would treat it as a constant.
    """
    return x if x.dim() == 2 and x.stride(1) == 1 else x.contiguous()


# ---------------------------------------------------------------------------
# differentiable entry points
#
# Every Function below takes inputs of any stride.  Its forward hands the
# kernel unit-stride copies (_unit_stride) and saves the inputs as they
# came; its backward works on those saved inputs with differentiable ops
# or Functions, which make their own copies where a kernel needs one.
# ---------------------------------------------------------------------------


class _SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg, window):
        ctx.seg, ctx.window = seg, window
        x = _unit_stride(x)
        return _dispatch(x, sorted_segment_sum_plain,
                         sorted_segment_sum_cuda, x, seg)

    @staticmethod
    def backward(ctx, g):
        return sorted_gather(g, ctx.seg, ctx.window), None, None

    @staticmethod
    def jvp(ctx, t, _seg, _window):
        return sorted_segment_sum(t, ctx.seg, ctx.window)


class _SortedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg, window):
        ctx.seg, ctx.window = seg, window
        return windowed_gather(x, seg.ids, window)

    @staticmethod
    def backward(ctx, g):
        return sorted_segment_sum(g, ctx.seg, ctx.window), None, None

    @staticmethod
    def jvp(ctx, t, _seg, _window):
        return sorted_gather(t, ctx.seg, ctx.window)


def sorted_segment_sum(x: torch.Tensor, seg: Segments,
                       window: int = 0) -> torch.Tensor:
    """Segment sum over sorted ids (K2); VJP = :func:`sorted_gather` with
    the same `window` (the static span of ``seg.ids``)."""
    return _SortedSegmentSum.apply(x, seg, window)


def sorted_gather(x: torch.Tensor, seg: Segments,
                  window: int = 0) -> torch.Tensor:
    """x[seg.ids], through the windowed gather (K8, trash rows 0) when
    `window` is usable; VJP = :func:`sorted_segment_sum` (K2)."""
    return _SortedGather.apply(x, seg, window)


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.perm, ctx.inv_perm = perm, inv_perm
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, g):
        return permute_rows(g, ctx.inv_perm, ctx.perm), None, None

    @staticmethod
    def jvp(ctx, t, _perm, _inv_perm):
        return permute_rows(t, ctx.perm, ctx.inv_perm)


def permute_rows(x: torch.Tensor, perm: torch.Tensor,
                 inv_perm: torch.Tensor) -> torch.Tensor:
    """x[perm] whose transpose is the inverse-permutation gather."""
    return _PermuteRows.apply(x, perm, inv_perm)


class _GatherNodes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, perm, inv_perm, seg_sorted, window,
                window_sorted):
        ctx.perm, ctx.inv_perm, ctx.seg_sorted = perm, inv_perm, seg_sorted
        ctx.idx, ctx.window, ctx.window_sorted = idx, window, window_sorted
        return windowed_gather(x, idx, window)

    @staticmethod
    def backward(ctx, g):
        g_sorted = permute_rows(g, ctx.perm, ctx.inv_perm)
        return (sorted_segment_sum(g_sorted, ctx.seg_sorted,
                                   ctx.window_sorted),
                None, None, None, None, None, None)

    @staticmethod
    def jvp(ctx, t, *_):
        return gather_nodes(t, ctx.idx, ctx.perm, ctx.inv_perm,
                            ctx.seg_sorted, ctx.window, ctx.window_sorted)


def gather_nodes(x: torch.Tensor, idx: torch.Tensor, perm: torch.Tensor,
                 inv_perm: torch.Tensor, seg_sorted: Segments,
                 window: int = 0, window_sorted: int = 0) -> torch.Tensor:
    """x[idx] for unsorted idx whose transpose is a sorted segment sum.

    `perm` is the stable argsort of `idx` and `seg_sorted` the segments of
    ``idx[perm]`` (both built once per batch); the VJP permutes the
    cotangent into idx-sorted order and reduces it with K2.  `window`
    routes the forward through K8; `window_sorted`, the span of
    ``idx[perm]``, is the window of that segment sum's own VJP (the next
    derivative order).
    """
    return _GatherNodes.apply(x, idx, perm, inv_perm, seg_sorted, window,
                              window_sorted)


class _GatedAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, bh, seg, window):
        h = _dispatch(m, gated_aggregate_plain, gated_aggregate_cuda,
                      _unit_stride(m), _unit_stride(bh), seg)
        ctx.seg, ctx.window = seg, window
        ctx.save_for_backward(m, bh, h)
        ctx.save_for_forward(m, bh)
        return h

    @staticmethod
    def backward(ctx, g):
        m, bh, h = ctx.saved_tensors
        seg, window = ctx.seg, ctx.window
        f = m.shape[-1]
        sigma = torch.sigmoid(m)
        # den is summed in f32: the forward divided by its f32 accumulator
        den = sorted_segment_sum(sigma.to(_acc_dtype(sigma.dtype)),
                                 seg, window) + EPS
        ginv = g / den                       # [N, F]
        gh = -g * h / den                    # [N, F] dL/dden
        packed = sorted_gather(torch.cat([ginv, gh], dim=-1), seg, window)
        ginv_e, gh_e = packed[:, :f], packed[:, f:]
        dbh = (sigma * ginv_e).to(bh.dtype)
        dsigma = bh * ginv_e + gh_e
        dm = (sigma * (1 - sigma) * dsigma).to(m.dtype)
        return dm, dbh, None, None

    @staticmethod
    def jvp(ctx, tm, tbh, _seg, _window):
        """dh = (S(sig' tm bh + sig tbh) - h S(sig' tm)) / den, the four
        segment sums in one K2 call, in (at least) f32."""
        m, bh = ctx.saved_tensors
        acc, f = _acc_dtype(m.dtype), m.shape[-1]
        sig = torch.sigmoid(m.to(acc))
        bh32 = bh.to(acc)
        dsig = sig * (1 - sig) * tm.to(acc) if tm is not None else \
            torch.zeros_like(sig)
        dbh = tbh.to(acc) if tbh is not None else torch.zeros_like(sig)
        num, den, dnum, dden = torch.split(sorted_segment_sum(
            torch.cat([sig * bh32, sig, dsig * bh32 + sig * dbh, dsig],
                      dim=-1), ctx.seg, ctx.window), f, dim=-1)
        den = den + EPS
        return ((dnum - num / den * dden) / den).to(m.dtype)


def gated_aggregate(m: torch.Tensor, bh: torch.Tensor, seg: Segments,
                    window: int = 0) -> torch.Tensor:
    """h = segment-normalised sigmoid(m) * bh over sorted dst (K1).

    Takes the pre-sigmoid gate logits `m`; output in m's dtype.  `window`
    (the static span of ``seg.ids``) routes the backward's gather of
    ``[g/den | -g h/den]`` to the edges through K8.
    """
    return _GatedAggregate.apply(m, bh, seg, window)


# the soft-weight sums divide by sum + 1e-3 (JAX's envelope-mode
# soft_agg_eps): with K1's 1e-6 the f32 grad-of-grad of a nearly empty
# segment overflows
SOFT_AGG_EPS = 1e-3


def weighted_aggregate(bh: torch.Tensor, sigma: torch.Tensor,
                       seg: Segments, eps: float = SOFT_AGG_EPS
                       ) -> torch.Tensor:
    """h[n] = sum_e sigma_e bh_e / (sum_e sigma_e + eps) over
    sorted dst, for gates that carry soft edge weights
    (sigma = sigmoid(m) * w, the envelope-weighted models; JAX
    ``edge_gated_aggregate``).

    The packed ``[sigma bh | sigma]`` table is one sorted segment sum
    (K2), whose VJP is :func:`sorted_gather` and whose second order is
    K2 again; on the CPU it is the plain index_add.  Unlike K1 the gates
    come in as values, so the weights are the caller's.  eALIGNN's
    inner-cutoff masks divide by the sum plus 1e-6, as in JAX.
    """
    f = bh.shape[-1]
    summed = sorted_segment_sum(torch.cat([bh * sigma, sigma], dim=-1), seg)
    return summed[:, :f] / (summed[:, f:] + eps)
