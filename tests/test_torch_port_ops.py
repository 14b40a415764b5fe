"""alignn_tpu_torch.ops: K1/K2 and the gathers against alignn_tpu's.

On the CPU the port runs its plain versions; the JAX side runs the Pallas
kernels in interpret mode (N=256, F=128, so the Pallas path is taken).
Both get the same numpy inputs from a seed.  The CUDA kernels are held
against the plain versions in ``test_torch_port_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignn_tpu.ops import pallas_eggc as jk
from alignn_tpu_torch.ops import eggc as tk
from torch_port_threads import _two_threads  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6  # f32, sums over <= ~20 rows in another order


def _problem(num_nodes=256, e=1500, f=128, seed=0):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, num_nodes, size=e))
    m = rng.standard_normal((e, f)).astype(np.float32)
    bh = rng.standard_normal((e, f)).astype(np.float32)
    g = rng.standard_normal((num_nodes, f)).astype(np.float32)
    return dst, m, bh, g


def _seg(ids, num, device="cpu"):
    return tk.Segments.from_sorted(
        torch.as_tensor(np.asarray(ids), dtype=torch.int64, device=device),
        num)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a.detach().cpu()), np.asarray(b),
                               rtol=rtol, atol=atol)


def test_segments_row_ptr():
    dst, *_ = _problem()
    seg = _seg(dst, 256)
    np.testing.assert_array_equal(
        seg.row_ptr.numpy(), np.searchsorted(dst, np.arange(257)))
    assert seg.row_ptr.dtype == torch.int32


@pytest.mark.parametrize("lengths", [[0, 3, 0, 300, 128, 129, 0],
                                     [1] * 40, [0, 0], [1000]])
def test_segment_work_items(lengths):
    ids = np.repeat(np.arange(len(lengths)), lengths)
    seg = _seg(ids, len(lengths))
    rows = seg.item_rows.numpy().astype(np.int64)
    ptr = seg.item_ptr.numpy().astype(np.int64)
    assert rows[0] == 0 and rows[-1] == len(ids) and seg.num_items == \
        len(rows) - 1
    size = np.diff(rows)
    assert np.all(size > 0) and np.all(size <= tk.CHUNK_ROWS)
    row_ptr = np.searchsorted(ids, np.arange(len(lengths) + 1))
    for n, length in enumerate(lengths):
        items = range(ptr[n], ptr[n + 1])
        assert len(items) == -(-length // tk.CHUNK_ROWS)
        if length:
            assert rows[ptr[n]] == row_ptr[n]
            assert rows[ptr[n + 1]] == row_ptr[n + 1]


def _items_numpy(lengths):
    """(item -> segment map, item count) of segments of these lengths,
    built in numpy: ceil(length / CHUNK_ROWS) items a segment."""
    chunks = -(-np.asarray(lengths, dtype=np.int64) // tk.CHUNK_ROWS)
    return np.repeat(np.arange(len(lengths)), chunks), int(chunks.sum())


@pytest.mark.parametrize("lengths", [[0, 3, 0, 300, 128, 129, 0],
                                     [1] * 40, [0, 0], [1000],
                                     [0, 4096, 4097, 0, 20000, 1]])
def test_segment_owner_and_counters(lengths):
    """The item -> segment map and the zeroed arrival counters, before
    and after padding to the most work items: padding items belong to no
    segment (owner num) and the counters grow to 2 per item, all 0."""
    ids = np.repeat(np.arange(len(lengths)), lengths)
    seg = _seg(ids, len(lengths))
    owner, num_items = _items_numpy(lengths)
    assert seg.num_items == num_items
    assert seg.owner.dtype == seg.counters.dtype == torch.int32
    np.testing.assert_array_equal(seg.owner.numpy(), owner)
    np.testing.assert_array_equal(seg.counters.numpy(),
                                  np.zeros(2 * num_items))
    cap = seg.max_items() + 3
    big = seg.with_capacity(cap)
    np.testing.assert_array_equal(
        big.owner.numpy(),
        np.concatenate([owner, np.full(cap - num_items, len(lengths))]))
    np.testing.assert_array_equal(big.counters.numpy(), np.zeros(2 * cap))
    assert big.counters.data_ptr() != seg.counters.data_ptr()


def test_segments_reject_out_of_range_ids():
    with pytest.raises(ValueError, match="lie in"):
        _seg(np.array([0, 1, 5]), 3)


def test_gated_aggregate_matches_pallas():
    dst, m, bh, g = _problem()
    n = 256
    h_j, vjp = jax.vjp(
        lambda m, bh: jk.gated_aggregate(m, bh, jnp.asarray(dst, jnp.int32),
                                         n, True), m, bh)
    dm_j, dbh_j = vjp(jnp.asarray(g))
    mt = torch.tensor(m, requires_grad=True)
    bt = torch.tensor(bh, requires_grad=True)
    h = tk.gated_aggregate(mt, bt, _seg(dst, n))
    h.backward(torch.tensor(g))
    _close(h, h_j)
    _close(mt.grad, dm_j)
    _close(bt.grad, dbh_j)


def test_sorted_segment_sum_matches_pallas():
    dst, m, _bh, g = _problem(seed=1)
    n = 256
    out_j, vjp = jax.vjp(
        lambda x: jk.sorted_segment_sum(x, jnp.asarray(dst, jnp.int32), n,
                                        True), m)
    (dx_j,) = vjp(jnp.asarray(g))
    xt = torch.tensor(m, requires_grad=True)
    out = tk.sorted_segment_sum(xt, _seg(dst, n))
    out.backward(torch.tensor(g))
    _close(out, out_j)
    _close(xt.grad, dx_j)


def test_sorted_gather_vjp_is_segment_sum():
    dst, _m, _bh, g = _problem(seed=2)
    n = 256
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, 128)).astype(np.float32)
    ge = rng.standard_normal((dst.shape[0], 128)).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda x: jk.sorted_gather(x, jnp.asarray(dst, jnp.int32), n, True),
        x)
    (dx_j,) = vjp(jnp.asarray(ge))
    xt = torch.tensor(x, requires_grad=True)
    out = tk.sorted_gather(xt, _seg(dst, n))
    out.backward(torch.tensor(ge))
    _close(out, out_j)
    _close(xt.grad, dx_j)


def test_gather_nodes_and_permute_rows_match_pallas():
    n, e, f = 256, 1500, 128
    rng = np.random.default_rng(4)
    idx = rng.integers(0, n, size=e)
    perm = np.argsort(idx, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(e)
    x = rng.standard_normal((n, f)).astype(np.float32)
    ge = rng.standard_normal((e, f)).astype(np.float32)
    i32 = [jnp.asarray(a, jnp.int32) for a in (idx, perm, inv)]
    out_j, vjp = jax.vjp(
        lambda x: jk.gather_nodes(x, *i32, n, True), x)
    (dx_j,) = vjp(jnp.asarray(ge))
    i64 = [torch.as_tensor(a, dtype=torch.int64) for a in (idx, perm, inv)]
    xt = torch.tensor(x, requires_grad=True)
    out = tk.gather_nodes(xt, *i64, _seg(idx[perm], n))
    out.backward(torch.tensor(ge))
    _close(out, out_j)
    _close(xt.grad, dx_j)

    rows = rng.standard_normal((e, f)).astype(np.float32)
    p_j, vjp = jax.vjp(lambda x: jk.permute_rows(x, i32[1], i32[2]), rows)
    (dp_j,) = vjp(jnp.asarray(ge))
    rt = torch.tensor(rows, requires_grad=True)
    p = tk.permute_rows(rt, i64[1], i64[2])
    p.backward(torch.tensor(ge))
    _close(p, p_j, rtol=0, atol=0)
    _close(rt.grad, dp_j, rtol=0, atol=0)


def test_empty_segments_are_zero():
    dst = np.repeat([0, 3], 5)           # segments 1, 2 and 4.. are empty
    rng = np.random.default_rng(5)
    m = torch.tensor(rng.standard_normal((10, 8)), dtype=torch.float32)
    h = tk.gated_aggregate(m, m, _seg(dst, 6))
    assert torch.all(h[[1, 2, 4, 5]] == 0)
    s = tk.sorted_segment_sum(m, _seg(dst, 6))
    assert torch.all(s[[1, 2, 4, 5]] == 0)


def test_kernel_wrappers_refuse_non_cuda_tensors():
    seg = _seg(np.zeros(4, dtype=np.int64), 1)
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tk.sorted_segment_sum_cuda(x, seg)
    with pytest.raises(ValueError, match="CUDA"):
        tk.gated_aggregate_cuda(x, x, seg)
    meta = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tk.sorted_segment_sum(meta, seg)
