"""alignn_tpu_torch on the card: CUDA kernels against their plain versions.

K1/K2 (``csrc/eggc.cu``, K2 also on the envelope models' soft-weight
sums), K3/K4/K5a/K5b (``csrc/dense.cu``, K3 and K5a/K5b also across
their splits, K5a/K5b with their occupancy and the sigmoid's bit-exact
select) and K6/K7 (``csrc/fused_lstage.cu``), then the
Calculator and the E/F/S train step on the card against the port on the
CPU, sparse, envelope-weighted, dense and fused dense; then the on-device
MD and FIRE loops captured as CUDA graphs against the same loops run
eagerly, and one captured graph across two chunks whose segments need
different work-item counts.

Every test here is marked ``cuda`` and skips on a host without a GPU.
This file imports torch and numpy only (the card's host has no JAX), so
on the card run it without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from alignn_tpu_torch.ops import dense as dk
from alignn_tpu_torch.ops import eggc as ek
from alignn_tpu_torch.ops import fused_lstage as fk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _seg(ids, num, device):
    return ek.Segments.from_sorted(
        torch.as_tensor(np.asarray(ids), dtype=torch.int64, device=device),
        num)


CASES = [  # (segments, rows, F, dtype, strided input)
    (256, 1500, 128, torch.float32, False),
    (256, 1500, 256, torch.bfloat16, False),
    (97, 700, 40, torch.float32, False),      # scalar (unvectorised) path
    (64, 900, 512, torch.float32, True),      # row stride != F, 2 chunks
    (8, 5000, 256, torch.float32, False),     # multi-item segments
    (3, 20000, 256, torch.bfloat16, False),   # trash-slot-like lengths
]


@pytest.mark.parametrize("n,e,f,dtype,strided", CASES)
def test_kernels_match_plain(cuda, n, e, f, dtype, strided):
    rng = np.random.default_rng(6)
    dst = np.sort(rng.integers(0, n - 1, size=e))   # last segment empty
    seg = _seg(dst, n, cuda)
    width = 2 * f if strided else f
    big = torch.tensor(rng.standard_normal((e, width)), device=cuda,
                       dtype=dtype)
    m, bh = big[:, :f], big[:, width - f:]
    before = (ek.gated_aggregate_cuda.launches,
              ek.sorted_segment_sum_cuda.launches)
    h = ek.gated_aggregate_cuda(m, bh, seg)
    s = ek.sorted_segment_sum_cuda(m, seg)
    torch.cuda.synchronize()
    assert (ek.gated_aggregate_cuda.launches,
            ek.sorted_segment_sum_cuda.launches) == (before[0] + 1,
                                                     before[1] + 1)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for out, ref in ((h, ek.gated_aggregate_plain(m, bh, seg)),
                     (s, ek.sorted_segment_sum_plain(m, seg))):
        assert out.dtype == dtype and out.shape == (n, f)
        ref = ref.float()
        err = (out.float() - ref).abs().max().item()
        assert err <= tol * ref.abs().max().item(), err
        assert torch.all(out[-1] == 0)


def test_gated_aggregate_backward_matches_plain(cuda):
    rng = np.random.default_rng(7)
    dst = np.sort(rng.integers(0, 256, size=1500))
    m = rng.standard_normal((1500, 128)).astype(np.float32)
    bh = rng.standard_normal((1500, 128)).astype(np.float32)
    g = torch.tensor(rng.standard_normal((256, 128)), dtype=torch.float32,
                     device=cuda)
    seg = _seg(dst, 256, cuda)
    grads = []
    for fn in (ek.gated_aggregate, ek.gated_aggregate_plain):
        mt = torch.tensor(m, device=cuda, requires_grad=True)
        bt = torch.tensor(bh, device=cuda, requires_grad=True)
        fn(mt, bt, seg).backward(g)
        grads.append((mt.grad, bt.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_unsupported_dtype_raises(cuda):
    seg = _seg(np.zeros(4), 1, cuda)
    with pytest.raises(TypeError):
        ek.sorted_segment_sum_cuda(torch.zeros(4, 8, device=cuda,
                                               dtype=torch.float16), seg)


def test_calculator_cuda_matches_cpu(cuda):
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator

    path = os.path.join(REPO, "docs", "mlearn_r4", "Si")
    frac = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                     [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                     [0.5, 0.5, 0], [0.75, 0.75, 0.25]])
    frac = frac + np.random.default_rng(0).normal(0, 0.01, frac.shape)
    atoms = Atoms(lattice_mat=np.eye(3) * 5.43, frac_coords=frac,
                  elements=["Si"] * 8)
    k1 = ek.gated_aggregate_cuda.launches
    gpu = Calculator(path=path).calculate(atoms)
    assert ek.gated_aggregate_cuda.launches - k1 == 12
    cpu = Calculator(path=path, device="cpu").calculate(atoms)
    assert abs(gpu["energy"] - cpu["energy"]) / 8 < 1e-4
    np.testing.assert_allclose(gpu["forces"], cpu["forces"], atol=5e-4)
    np.testing.assert_allclose(gpu["stress"], cpu["stress"], atol=1e-5)


DENSE_CASES = [  # (nodes, D, F, dtype, strided input)
    (768, 18, 256, torch.float32, False),    # the 512-atom dense shape
    (96, 13, 256, torch.bfloat16, False),
    (17, 5, 42, torch.float32, False),       # scalar (unvectorised) path
    (12, 7, 256, torch.float32, True),       # row stride != F
    (6, 60, 128, torch.float32, False),      # K5a needs > 48 KB of smem
    (4, 3, 1024, torch.bfloat16, True),      # 8 feature chunks
]


def _close_rel(out, ref, dtype):
    """f32 1e-5, bf16 1e-2, times max|plain|."""
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    assert out.dtype == dtype and out.shape == ref.shape
    assert err <= tol * ref.abs().max().item(), err


def _table(rng, rows, f, dtype, strided, device):
    width = 2 * f if strided else f
    big = torch.tensor(rng.standard_normal((rows, width)), device=device,
                       dtype=torch.float32)
    return big.to(dtype)[:, width - f:]


@pytest.mark.parametrize("n,D,f,dtype,strided", DENSE_CASES)
def test_dense_kernels_match_plain(cuda, n, D, f, dtype, strided):
    rng = np.random.default_rng(8)
    em = (rng.random(n * D) < 0.8).astype(np.float32)
    em[:D] = 0.0                                   # an empty node
    em_t = torch.tensor(em, device=cuda)
    lg = (em_t.reshape(n, 1, D) * em_t.reshape(n, D, 1)).reshape(-1)
    m = dk.fold_mask(_table(rng, n * D, f, dtype, strided, cuda), em_t)
    m2 = dk.fold_mask(_table(rng, n * D * D, f, dtype, strided, cuda), lg)
    bh = _table(rng, n * D, f, dtype, strided, cuda)
    g = _table(rng, n * D, f, dtype, strided, cuda)
    u = _table(rng, n * D * D, f, dtype, strided, cuda)
    v = _table(rng, n * D, f, dtype, strided, cuda)
    counters = (dk.dense_gated_aggregate_cuda, dk.dense_pair_aggregate_cuda,
                dk.pair_aggregate_bwd_cuda, dk.pair_aggregate_bwd2_cuda)
    before = [c.launches for c in counters]
    h3 = dk.dense_gated_aggregate_cuda(m, bh, D)
    h4 = dk.dense_pair_aggregate_cuda(m2, bh, D)
    dm2, dbh = dk.pair_aggregate_bwd_cuda(m2, bh, g, D)
    c2 = dk.pair_aggregate_bwd2_cuda(m2, bh, g, u, v, D)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1] * 4
    _close_rel(h3, dk.dense_gated_aggregate_plain(m, bh, D), dtype)
    _close_rel(h4, dk.dense_pair_aggregate_plain(m2, bh, D), dtype)
    ref_dm2, ref_dbh = dk.pair_aggregate_bwd_plain(m2, bh, g, D)
    _close_rel(dm2, ref_dm2, dtype)
    _close_rel(dbh, ref_dbh, dtype)
    for out, ref in zip(c2, dk.pair_aggregate_bwd2_plain(m2, bh, g, u, v, D)):
        _close_rel(out, ref, dtype)
    # masked slots: exact zeros, no NaN
    c_m2, c_bh, c_g = c2
    assert torch.all(h3[0] == 0)
    assert torch.all(h4[:D] == 0) and torch.all(dbh[:D] == 0)
    assert torch.all(dm2[lg == 0] == 0) and torch.all(c_m2[lg == 0] == 0)
    assert torch.all(c_bh[:D] == 0) and torch.all(c_g[:D] == 0)
    assert all(torch.isfinite(x.float()).all() for x in (dm2, *c2))


@pytest.mark.parametrize("kernel,D", [("K4", 460), ("K5a", 160),
                                      ("K5b", 80), ("K6", 65), ("K7", 65)])
def test_pair_kernels_refuse_a_block_too_large(cuda, kernel, D):
    """K4 stages one [D, 128] f32 plane, K5a three, K5b six: past 232,448
    bytes dense.cu refuses the launch.  K6 and K7 refuse a t-group of more
    than 64 pair rows (their m2 tile).  The wrappers raise ValueError."""
    bh = torch.zeros(D, 128, device=cuda)
    pairs = torch.zeros(D * D, 128, device=cuda)
    w, v = torch.zeros(128, 128, device=cuda), torch.zeros(128, device=cuda)
    reason = "64-row tile" if kernel in ("K6", "K7") else "shared memory"
    with pytest.raises(ValueError, match=reason):
        if kernel == "K4":
            dk.dense_pair_aggregate_cuda(pairs, bh, D)
        elif kernel == "K5a":
            dk.pair_aggregate_bwd_cuda(pairs, bh, bh, D)
        elif kernel == "K5b":
            dk.pair_aggregate_bwd2_cuda(pairs, bh, bh, pairs, bh, D)
        elif kernel == "K6":
            fk.fused_pair_lstage_cuda(pairs, w, v, bh, bh, bh, v, v, D)
        else:
            fk.fused_lstage_bwd_cuda(pairs, w, v, bh, bh, bh, v, v, pairs,
                                     bh, D)


# K5a/K5b across their launch plans (dense.cu `bwd_plan`).  Slab width W
# and blocks an SM: K5a W 64 to D 13, W 32 (4 blocks to D 19, then 2) to
# D 28, then W 16 and (f32) W 8; K5b W 64 to D 8, W 32 (4 blocks to D
# 13, then 2) to D 19, then W 16 and (f32) W 8.  Two-pass from D 84
# (K5a f32), 59 (K5a bf16, K5b f32) and 41 (K5b bf16).  layout: "dense"
# contiguous, "strided" row stride 2F, "unaligned" row stride F + 1 and a
# data pointer off 16 bytes (the scalar path).
PAIR_BWD_CASES = [  # (nodes, D, F, dtype, layout)
    (64, 1, 256, torch.float32, "dense"),
    (64, 2, 256, torch.bfloat16, "strided"),
    (40, 8, 256, torch.float32, "dense"),       # K5b: last D at W 64
    (40, 9, 256, torch.float32, "strided"),     # K5b: W 32 from D 9
    (40, 13, 256, torch.float32, "dense"),      # the training batch's D
    (40, 13, 256, torch.bfloat16, "unaligned"),
    (24, 14, 256, torch.bfloat16, "dense"),     # K5a: W 32 from D 14
    (24, 18, 256, torch.float32, "strided"),    # the 512-atom bucket's D
    (24, 18, 256, torch.bfloat16, "dense"),
    (16, 19, 128, torch.bfloat16, "strided"),   # K5a: last D at 4 blocks
    (16, 20, 128, torch.float32, "unaligned"),  # K5a: 2 blocks; K5b W 16
    (3, 40, 64, torch.bfloat16, "dense"),       # K5b bf16: last slab D
    (3, 41, 64, torch.bfloat16, "strided"),     # K5b bf16: two-pass
    (2, 58, 64, torch.float32, "strided"),      # K5b f32: last slab D
    (2, 58, 64, torch.bfloat16, "dense"),       # K5a bf16: last slab D
    (2, 59, 64, torch.float32, "dense"),        # K5b f32: two-pass
    (2, 59, 64, torch.bfloat16, "strided"),     # K5a bf16: two-pass
    (2, 83, 32, torch.float32, "dense"),        # K5a f32: last slab D
    (2, 84, 32, torch.float32, "unaligned"),    # K5a f32: two-pass
    (30, 6, 40, torch.float32, "dense"),        # F = 40 of a 64-wide block
    (30, 6, 72, torch.bfloat16, "strided"),     # a second block of 8 live
    (30, 6, 42, torch.float32, "dense"),        # F % 4 != 0: scalar path
]


def _pair_table(rng, rows, f, dtype, layout, device):
    if layout == "unaligned":
        big = torch.tensor(rng.standard_normal((rows, f + 1)),
                           device=device, dtype=torch.float32).to(dtype)
        return big[:, 1:]
    return _table(rng, rows, f, dtype, layout == "strided", device)


def _pair_bwd_operands(rng, n, D, f, dtype, layout, device):
    """(m2, bh, g, u, v) with node 0 fully masked and 20 % of the other
    slots masked (folded into m2), and the pair mask."""
    em = (rng.random(n * D) < 0.8).astype(np.float32)
    em[:D] = 0.0
    em_t = torch.tensor(em, device=device)
    lg = (em_t.reshape(n, 1, D) * em_t.reshape(n, D, 1)).reshape(-1)
    m2 = _pair_table(rng, n * D * D, f, dtype, layout, device)
    m2.copy_(dk.fold_mask(m2, lg))            # in place: m2 keeps its layout
    bh, g, v = (_pair_table(rng, n * D, f, dtype, layout, device)
                for _ in range(3))
    u = _pair_table(rng, n * D * D, f, dtype, layout, device)
    return (m2, bh, g, u, v), lg


@pytest.mark.parametrize("n,D,f,dtype,layout", PAIR_BWD_CASES)
def test_pair_bwd_kernels_match_plain(cuda, n, D, f, dtype, layout):
    """K5a and K5b against their plain versions (f32 1e-5, bf16 1e-2, times
    max|plain|) on either side of every switch of their launch plans; the
    fully masked node's dm2, dbh, c_m2, c_bh and c_g exactly 0 and every
    output finite; two launches bit-identical."""
    rng = np.random.default_rng(15)
    (m2, bh, g, u, v), lg = _pair_bwd_operands(rng, n, D, f, dtype, layout,
                                               cuda)
    assert m2.stride(0) == bh.stride(0)
    before = (dk.pair_aggregate_bwd_cuda.launches,
              dk.pair_aggregate_bwd2_cuda.launches)
    first = (*dk.pair_aggregate_bwd_cuda(m2, bh, g, D),
             *dk.pair_aggregate_bwd2_cuda(m2, bh, g, u, v, D))
    second = (*dk.pair_aggregate_bwd_cuda(m2, bh, g, D),
              *dk.pair_aggregate_bwd2_cuda(m2, bh, g, u, v, D))
    torch.cuda.synchronize()
    assert (dk.pair_aggregate_bwd_cuda.launches,
            dk.pair_aggregate_bwd2_cuda.launches) == (before[0] + 2,
                                                      before[1] + 2)
    refs = (*dk.pair_aggregate_bwd_plain(m2, bh, g, D),
            *dk.pair_aggregate_bwd2_plain(m2, bh, g, u, v, D))
    for out, again, ref in zip(first, second, refs):
        _close_rel(out, ref, dtype)
        assert torch.isfinite(out.float()).all()
        assert torch.equal(out, again)
    dm2, dbh, c_m2, c_bh, c_g = first
    masked = lg == 0
    assert torch.all(dm2[masked] == 0) and torch.all(c_m2[masked] == 0)
    for x in (dbh, c_bh, c_g):
        assert torch.all(x[:D] == 0)


@pytest.mark.parametrize("kernel,dtype,D,width,blocks", [
    ("K5a", torch.float32, 13, 64, 4), ("K5a", torch.float32, 14, 32, 4),
    ("K5a", torch.float32, 18, 32, 4), ("K5a", torch.float32, 20, 32, 2),
    ("K5a", torch.float32, 83, 8, 1), ("K5a", torch.float32, 84, 0, 1),
    ("K5a", torch.bfloat16, 58, 16, 1), ("K5a", torch.bfloat16, 59, 0, 1),
    ("K5b", torch.float32, 8, 64, 4), ("K5b", torch.float32, 13, 32, 4),
    ("K5b", torch.float32, 18, 32, 2), ("K5b", torch.float32, 58, 8, 1),
    ("K5b", torch.float32, 59, 0, 1), ("K5b", torch.bfloat16, 40, 16, 1),
    ("K5b", torch.bfloat16, 41, 0, 1)])
def test_pair_bwd_occupancy(cuda, kernel, dtype, D, width, blocks):
    """The launch plan at F 256 read on the card: W (0 = two-pass) and at
    least the resident blocks per SM that the plan sized its shared
    memory for (registers must not cut them)."""
    occ = dk.pair_bwd_occupancy(kernel, D, 256, dtype)
    assert occ["width"] == width, occ
    assert occ["blocks_per_sm"] >= blocks, occ
    assert occ["smem_bytes"] <= 232448


def test_sigmoid_select_is_exact_on_every_f32(cuda):
    """dense.cu's sigmoid (0 below -88.75, else 1 / (1 + exp(-x))) equals
    the exact 1 / (1 + exp(-x)) bit for bit on all 2^32 f32 patterns."""
    assert dk.sigmoid_mismatches() == 0


K3_CASES = [  # (nodes, D, F, dtype, layout)
    (512, 13, 256, torch.float32, "contiguous"),   # the training batch
    (512, 13, 256, torch.bfloat16, "contiguous"),
    (768, 18, 256, torch.float32, "contiguous"),   # the 512-atom cell
    (768, 18, 256, torch.bfloat16, "contiguous"),
    (300, 1, 256, torch.float32, "contiguous"),
    (300, 1, 128, torch.bfloat16, "strided"),
    (64, 32, 256, torch.float32, "strided"),
    (64, 32, 256, torch.bfloat16, "contiguous"),
    (40, 13, 42, torch.float32, "unaligned"),      # F % 4: the VEC 1 path
    (40, 18, 64, torch.bfloat16, "unaligned"),     # row stride F + 1
    (9, 1, 40, torch.float32, "unaligned"),
    (5, 200, 64, torch.float32, "contiguous"),     # 13 batches of loads
]


def _k3_operands(rng, n, D, f, dtype, layout, device):
    """Masked logits (node 0 fully masked) and bh, laid out as asked: an
    unaligned table has a row stride of F + 1 elements."""
    em = (rng.random(n * D) < 0.8).astype(np.float32)
    em[:D] = 0.0
    if layout == "unaligned":
        def table():
            big = torch.tensor(rng.standard_normal((n * D, f + 1)),
                               device=device, dtype=torch.float32)
            return big.to(dtype)[:, 1:]
    else:
        def table():
            return _table(rng, n * D, f, dtype, layout == "strided", device)
    m = dk.fold_mask(table(), torch.tensor(em, device=device))
    return m, table()


@pytest.mark.parametrize("n,D,f,dtype,layout", K3_CASES)
def test_dense_gated_aggregate_matches_plain(cuda, n, D, f, dtype, layout):
    """K3 against its plain version (f32 1e-5, bf16 1e-2, times
    max|plain|), its fully masked node exactly 0, every output finite, and
    a second launch bit-identical (the split's partial sums meet in a
    fixed order)."""
    m, bh = _k3_operands(np.random.default_rng(10), n, D, f, dtype, layout,
                         cuda)
    before = dk.dense_gated_aggregate_cuda.launches
    h = dk.dense_gated_aggregate_cuda(m, bh, D)
    torch.cuda.synchronize()
    assert dk.dense_gated_aggregate_cuda.launches == before + 1
    _close_rel(h, dk.dense_gated_aggregate_plain(m, bh, D), dtype)
    assert torch.all(h[0] == 0)
    assert torch.isfinite(h.float()).all()
    assert torch.equal(h, dk.dense_gated_aggregate_cuda(m, bh, D))


def _soft_problem(device, n=256, e=3000, f=128, seed=12):
    """Sorted segments (the last one empty), bh, logits and soft weights
    in [0, 1] with exact zeros, as the envelope gives them."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n - 1, size=e))
    w = rng.random(e)
    w[rng.random(e) < 0.2] = 0.0

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    return (_seg(dst, n, device), t(rng.standard_normal((e, f))),
            t(rng.standard_normal((e, f))), t(w),
            t(rng.standard_normal((n, f))))


def test_weighted_aggregate_runs_k2(cuda):
    """The envelope models' soft-weight aggregation: its packed sums run
    K2 on the card (and no K1), and its value, gradient and gradient of
    the gradient match the plain route on the CPU (rtol 1e-5, atol 1e-5
    x max|CPU|)."""
    out = {}
    for dev in (torch.device("cpu"), cuda):
        seg, bh, m, w, g = _soft_problem(dev)
        bh.requires_grad_(True)
        m.requires_grad_(True)
        k = (ek.gated_aggregate_cuda.launches,
             ek.sorted_segment_sum_cuda.launches)
        h = ek.weighted_aggregate(bh, torch.sigmoid(m) * w[:, None], seg)
        dbh, dm = torch.autograd.grad((h * g).sum(), (bh, m),
                                      create_graph=True)
        second = torch.autograd.grad((dbh ** 2).sum() + (dm * g[:1]).sum(),
                                     (bh, m))
        out[dev.type] = [x.detach().cpu() for x in (h, dbh, dm, *second)]
        if dev.type == "cuda":
            # the forward's sums, then the transpose of the first order's
            # gather in the second
            assert ek.gated_aggregate_cuda.launches == k[0]
            assert ek.sorted_segment_sum_cuda.launches - k[1] == 2
    for got, ref in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))
    assert torch.all(out["cuda"][0][-1] == 0)


def test_envelope_calculator_cuda_matches_cpu(cuda):
    """docs/mlearn_r5/Si_envelope on a rattled diamond cell: the card runs
    K2 and no K1, and matches the port on the CPU at the serving limits."""
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator

    path = os.path.join(REPO, "docs", "mlearn_r5", "Si_envelope")
    frac = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                     [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                     [0.5, 0.5, 0], [0.75, 0.75, 0.25]])
    frac = frac + np.random.default_rng(0).normal(0, 0.01, frac.shape)
    atoms = Atoms(lattice_mat=np.eye(3) * 5.43, frac_coords=frac,
                  elements=["Si"] * 8)
    k = (ek.gated_aggregate_cuda.launches,
         ek.sorted_segment_sum_cuda.launches)
    gpu = Calculator(path=path).calculate(atoms)
    assert ek.gated_aggregate_cuda.launches == k[0]
    assert ek.sorted_segment_sum_cuda.launches > k[1]
    cpu = Calculator(path=path, device="cpu").calculate(atoms)
    assert abs(gpu["energy"] - cpu["energy"]) / 8 < 1e-4
    np.testing.assert_allclose(gpu["forces"], cpu["forces"], atol=5e-4)
    np.testing.assert_allclose(gpu["stress"], cpu["stress"], atol=1e-5)
    assert np.abs(gpu["forces"].sum(axis=0)).max() < 1e-3


def test_dense_autograd_runs_the_kernels(cuda):
    """Through the autograd Functions: K4's backward is K5a; K3's backward
    (plain ops) matches autograd through the plain version."""
    rng = np.random.default_rng(9)
    n, D, f = 32, 6, 128
    m = torch.tensor(rng.standard_normal((n * D, f)), dtype=torch.float32,
                     device=cuda, requires_grad=True)
    m2 = torch.tensor(rng.standard_normal((n * D * D, f)),
                      dtype=torch.float32, device=cuda, requires_grad=True)
    bh = torch.tensor(rng.standard_normal((n * D, f)), dtype=torch.float32,
                      device=cuda, requires_grad=True)
    k5 = dk.pair_aggregate_bwd_cuda.launches
    grads = []
    for fn3, fn4 in ((dk.dense_gated_aggregate,
                      dk.dense_pair_aggregate),
                     (dk.dense_gated_aggregate_plain,
                      dk.dense_pair_aggregate_plain)):
        loss = (fn3(m, bh, D) ** 2).sum() + (fn4(m2, bh, D) ** 2).sum()
        grads.append(torch.autograd.grad(loss, (m, m2, bh)))
    assert dk.pair_aggregate_bwd_cuda.launches == k5 + 1
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_dense_calculator_cuda_matches_cpu(cuda):
    """use_canonize: true Si diamond through the dense layout: 8 K3, 4 K4,
    4 K5a and no K1 launch per call."""
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator

    path = os.path.join(REPO, "docs", "mlearn_r4", "Si")
    frac = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                     [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                     [0.5, 0.5, 0], [0.75, 0.75, 0.25]])
    frac = frac + np.random.default_rng(0).normal(0, 0.01, frac.shape)
    atoms = Atoms(lattice_mat=np.eye(3) * 5.43, frac_coords=frac,
                  elements=["Si"] * 8)
    counters = (ek.gated_aggregate_cuda, dk.dense_gated_aggregate_cuda,
                dk.dense_pair_aggregate_cuda, dk.pair_aggregate_bwd_cuda)
    before = [c.launches for c in counters]
    base = Calculator(path=path)
    config = {**base.config, "use_canonize": True}
    calc = Calculator(model=base.model, config=config, dense=True)
    gpu = calc.calculate(atoms)
    assert calc._spec.dense_D > 0
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 8, 4, 4]
    cpu_base = Calculator(path=path, device="cpu")
    cpu = Calculator(model=cpu_base.model, config=config, dense=True,
                     device="cpu").calculate(atoms)
    assert abs(gpu["energy"] - cpu["energy"]) / 8 < 1e-4
    np.testing.assert_allclose(gpu["forces"], cpu["forces"], atol=5e-4)
    np.testing.assert_allclose(gpu["stress"], cpu["stress"], atol=1e-5)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sparse"])
def test_train_step_cuda_matches_cpu(cuda, dense):
    """One AdamW step of a 1+1/128 model on 4 cells, card against CPU from
    the same seeded weights: loss components to rtol 1e-4, every gradient
    within 1e-3 x max|grad| + 1e-7.  The dense step launches K5b and no
    K1."""
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.build import rocksalt_graphs
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_batch)
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            init_parameters)
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    graphs = rocksalt_graphs(4)
    cfg = ALIGNNAtomWiseConfig(alignn_layers=1, gcn_layers=1,
                               hidden_features=128, embedding_features=32,
                               gradwise_weight=10.0, stresswise_weight=0.1)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        batch = (dense_batch_graphs(graphs, dense_spec_for_batch(graphs), dev)
                 if dense else batch_graphs(
                     graphs, BucketSpec.tight_for_batch(graphs), dev))
        model = init_parameters(ALIGNNAtomWise(cfg),
                                torch.Generator().manual_seed(0))
        state = create_train_state(model, batch,
                                   build_optimizer("adamw", 1e-3, 1e-5))
        k = (ek.gated_aggregate_cuda.launches,
             dk.pair_aggregate_bwd2_cuda.launches)
        _state, losses = make_train_step(model)(state, batch)
        launches = (ek.gated_aggregate_cuda.launches - k[0],
                    dk.pair_aggregate_bwd2_cuda.launches - k[1])
        out[dev.type] = ({n: float(v) for n, v in losses.items()},
                         {n: p.grad.cpu() for n, p in
                          model.named_parameters()}, launches)
    (lc, gc, _), (lg, gg, launches) = out["cpu"], out["cuda"]
    assert launches == ((0, 1) if dense else (3, 0))
    for name, ref in lc.items():
        assert abs(lg[name] - ref) <= 1e-4 * abs(ref) + 1e-7, name
    for name, ref in gc.items():
        diff = float((gg[name] - ref).abs().max())
        assert diff <= 1e-3 * float(ref.abs().max()) + 1e-7, (name, diff)


FUSED_CASES = [  # (nodes, D, F, dtype, strided input)
    (64, 4, 256, torch.float32, False),
    (40, 13, 256, torch.float32, True),      # row stride 2F
    (30, 18, 256, torch.bfloat16, False),
    (24, 13, 128, torch.bfloat16, True),
    (20, 18, 128, torch.float32, False),
    (16, 4, 256, torch.bfloat16, True),
    # K6 tiles 64 // D t-groups, K7 min(64 // D, 16): D 5 and 13 cut nodes
    # across tiles (K7's dsg and dbh from per-tile partials), the node
    # counts leave the last tile part empty
    (7, 1, 128, torch.float32, False),       # G 16 (K7) / 64 (K6)
    (9, 5, 256, torch.bfloat16, True),       # G 12: 2.4 nodes a tile
    (11, 13, 128, torch.float32, True),      # G 4: a node over 4 tiles
    (13, 13, 256, torch.bfloat16, False),
    (5, 18, 256, torch.float32, False),      # G 3: a node is 6 whole tiles
    (7, 18, 128, torch.bfloat16, True),
    (3, 64, 128, torch.bfloat16, False),     # the largest D: one t-group
    (2, 64, 256, torch.float32, True),
]


def _fused_operands(rng, n, D, f, dtype, strided, device, masked=False):
    """(z, w, b, sg_f, dg_f, bh, scale, bias), de, dh and the pair mask: node
    0 empty (every node with `masked`), the edge mask folded into sg_f and
    dg_f, de 0 on masked pair rows (as in the model: nothing reads those
    rows of e_new)."""
    em = (rng.random(n * D) < 0.8).astype(np.float32)
    em[:D] = 0.0
    if masked:
        em[:] = 0.0
    em_t = torch.tensor(em, device=device)
    lg = (em_t.reshape(n, 1, D) * em_t.reshape(n, D, 1)).reshape(-1)

    def vec(scale, offset=0.0):
        return torch.tensor(offset + scale * rng.standard_normal(f),
                            dtype=torch.float32, device=device)

    z = _table(rng, n * D * D, f, dtype, strided, device)
    w = torch.tensor(0.05 * rng.standard_normal((f, f)), dtype=torch.float32,
                     device=device)
    sg = dk.fold_mask(_table(rng, n * D, f, dtype, strided, device), em_t)
    dg = dk.fold_mask(_table(rng, n * D, f, dtype, strided, device), em_t)
    bh = _table(rng, n * D, f, dtype, strided, device)
    de = _table(rng, n * D * D, f, dtype, strided, device) * \
        lg.to(dtype)[:, None]
    dh = _table(rng, n * D, f, dtype, strided, device)
    return (z, w, vec(0.1), sg, dg, bh, vec(0.1, 1.0), vec(0.1)), de, dh, lg


def _check_fused(args, de, dh, lg, D, dtype):
    """K6 and K7 once against their plain versions (f32 1e-5, bf16 1e-2,
    times max|plain|), one launch each; returns their outputs."""
    before = (fk.fused_pair_lstage_cuda.launches,
              fk.fused_lstage_bwd_cuda.launches)
    e_new, h = fk.fused_pair_lstage_cuda(*args, D)
    grads = fk.fused_lstage_bwd_cuda(*args, de, dh, D)
    torch.cuda.synchronize()
    assert (fk.fused_pair_lstage_cuda.launches,
            fk.fused_lstage_bwd_cuda.launches) == (before[0] + 1,
                                                   before[1] + 1)
    ref_e, ref_h = fk.fused_pair_lstage_plain(*args, D)
    real = lg > 0
    if real.any():   # e_new is read on real pair rows only
        _close_rel(e_new[real], ref_e[real], dtype)
    _close_rel(h, ref_h, dtype)
    assert torch.isfinite(e_new.float()).all()
    for out, ref in zip(grads, fk.fused_lstage_bwd_plain(*args, de, dh, D)):
        assert out.dtype == ref.dtype and out.shape == ref.shape
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= tol * ref.float().abs().max().item(), err
        assert torch.isfinite(out.float()).all()
    return (e_new, h, *grads)


@pytest.mark.parametrize("n,D,f,dtype,strided", FUSED_CASES)
def test_fused_kernels_match_plain(cuda, n, D, f, dtype, strided):
    """K6 (h; e_new on real pair rows) and K7 (all eight outputs) against
    their plain versions: f32 1e-5, bf16 1e-2, times max|plain|.  Masked
    rows finite; one launch each."""
    rng = np.random.default_rng(10)
    args, de, dh, lg = _fused_operands(rng, n, D, f, dtype, strided, cuda)
    h = _check_fused(args, de, dh, lg, D, dtype)[1]
    assert torch.all(h[:D] == 0)                    # the empty node


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_all_masked(cuda, dtype):
    """A batch whose pair rows are all masked: h and every cotangent
    exactly 0 (sigmoid of the folded -1e9 is 0 at every order)."""
    rng = np.random.default_rng(13)
    args, de, dh, lg = _fused_operands(rng, 6, 13, 256, dtype, False, cuda,
                                       masked=True)
    outs = _check_fused(args, de, dh, lg, 13, dtype)
    for x in outs[1:]:
        assert torch.all(x == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_are_deterministic(cuda, dtype):
    """Two launches on the same inputs give bit-identical outputs: every
    sum across blocks (dW, db, dscale, dbias, dsg, dbh) is taken from
    partials in a fixed order."""
    rng = np.random.default_rng(14)
    args, de, dh, _lg = _fused_operands(rng, 40, 13, 256, dtype, False, cuda)
    first = (*fk.fused_pair_lstage_cuda(*args, 13),
             *fk.fused_lstage_bwd_cuda(*args, de, dh, 13))
    second = (*fk.fused_pair_lstage_cuda(*args, 13),
              *fk.fused_lstage_bwd_cuda(*args, de, dh, 13))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_fused_autograd_runs_the_kernels(cuda):
    """Through fused_pair_lstage: the forward launches K6, the first
    backward K7, and the grad-of-grad (autograd of K7's plain version)
    matches autograd through the plain forward: rtol 1e-4, atol 1e-5 x
    max|ref|.  The grad-of-grad launches K7 once more: the first
    backward's cotangent de depends on e_new, whose VJP is K7."""
    rng = np.random.default_rng(11)
    args, _de, _dh, lg = _fused_operands(rng, 24, 13, 256, torch.float32,
                                         False, cuda)
    mask = lg[:, None]
    outs = []
    for fn in (fk.fused_pair_lstage, fk.fused_pair_lstage_plain):
        ts = [a.detach().clone().requires_grad_(True) for a in args]
        k = (fk.fused_pair_lstage_cuda.launches,
             fk.fused_lstage_bwd_cuda.launches)
        e, h = fn(*ts, 13)
        (gz,) = torch.autograd.grad(((e * mask) ** 2).sum() + (h ** 2).sum(),
                                    ts[0], create_graph=True)
        g2 = torch.autograd.grad((gz ** 2).sum(), (ts[1], ts[3], ts[5]))
        outs.append((gz, *g2))
        launches = (fk.fused_pair_lstage_cuda.launches - k[0],
                    fk.fused_lstage_bwd_cuda.launches - k[1])
        assert launches == ((1, 2) if fn is fk.fused_pair_lstage else (0, 0))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


def test_fused_dense_calculator_cuda_matches_cpu(cuda, monkeypatch):
    """ALIGNN_TPU_FUSED_LSTAGE=1, use_canonize: true Si diamond: 4 K6 and 4
    K7 launches per call, no K4, K5a or K1; E/F/S against the CPU port's
    fused path at the Calculator's limits."""
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator

    monkeypatch.setenv("ALIGNN_TPU_FUSED_LSTAGE", "1")
    path = os.path.join(REPO, "docs", "mlearn_r4", "Si")
    frac = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                     [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                     [0.5, 0.5, 0], [0.75, 0.75, 0.25]])
    frac = frac + np.random.default_rng(0).normal(0, 0.01, frac.shape)
    atoms = Atoms(lattice_mat=np.eye(3) * 5.43, frac_coords=frac,
                  elements=["Si"] * 8)
    counters = (ek.gated_aggregate_cuda, dk.dense_pair_aggregate_cuda,
                dk.pair_aggregate_bwd_cuda, fk.fused_pair_lstage_cuda,
                fk.fused_lstage_bwd_cuda)
    base = Calculator(path=path)
    config = {**base.config, "use_canonize": True}
    calc = Calculator(model=base.model, config=config, dense=True)
    before = [c.launches for c in counters]
    gpu = calc.calculate(atoms)
    assert calc._spec.dense_D > 0
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [0, 0, 0, 4, 4]
    cpu_base = Calculator(path=path, device="cpu")
    cpu = Calculator(model=cpu_base.model, config=config, dense=True,
                     device="cpu").calculate(atoms)
    assert abs(gpu["energy"] - cpu["energy"]) / 8 < 1e-4
    np.testing.assert_allclose(gpu["forces"], cpu["forces"], atol=5e-4)
    np.testing.assert_allclose(gpu["stress"], cpu["stress"], atol=1e-5)


# ---------------------------------------------------------------------------
# the on-device MD and relaxation loops as CUDA graphs
# ---------------------------------------------------------------------------


def _rattled_si(n, rattle=0.03, seed=0):
    from alignn_tpu_torch.chem.atoms import Atoms

    frac = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                     [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                     [0.5, 0.5, 0], [0.75, 0.75, 0.25]])
    sc = Atoms(lattice_mat=np.eye(3) * 5.43, frac_coords=frac,
               elements=["Si"] * 8).make_supercell([n] * 3)
    cart = sc.cart_coords + np.random.default_rng(seed).normal(
        0.0, rattle, sc.cart_coords.shape)
    return Atoms(lattice_mat=sc.lattice_mat,
                 frac_coords=cart @ np.linalg.inv(sc.lattice_mat),
                 elements=sc.elements)


def test_md_jit_captured_matches_eager(cuda):
    """Si_envelope on rattled si64, NVE, 2 chunks of 5 steps: the chunk's
    step captured once and replayed (one capture: the padded segments keep
    the launch sizes of the bucket) against the same loop run eagerly,
    positions within 1e-5 A and energies within 1e-6 eV/atom (two f32
    ulps of the 64-atom total)."""
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.ff.md_jit import run_md_jit
    from alignn_tpu_torch.ff.step_loop import StepLoop

    model = Calculator(path=os.path.join(
        REPO, "docs", "mlearn_r5", "Si_envelope")).model
    kw = dict(steps=10, chunk_steps=5, cutoff=4.5,
              initial_temperature_K=300.0, seed=1)
    c0 = StepLoop.captures
    a_graph, log_graph = run_md_jit(model, _rattled_si(2), **kw)
    assert StepLoop.captures - c0 == 1
    a_eager, log_eager = run_md_jit(model, _rattled_si(2), cuda_graph=False,
                                    **kw)
    assert StepLoop.captures - c0 == 1
    np.testing.assert_allclose(a_graph.cart_coords, a_eager.cart_coords,
                               rtol=0, atol=1e-5)
    for x, y in zip(log_graph.rows, log_eager.rows):
        assert abs(x["epot"] - y["epot"]) / 64 < 1e-6
        assert abs(x["ekin"] - y["ekin"]) / 64 < 1e-6


def test_md_jit_recaptures_for_a_new_bucket(cuda):
    """Two chunks whose segments need different work-item counts
    (num_items 2 vs 3 at the same bucket): padded to the bucket's
    capacity, one captured graph serves both; a batch of a larger bucket
    is refused.  The replayed graph gives K2's unpadded sums bit for bit,
    and the plain sums within 1e-5 x their largest (each batch runs the
    loop's warm-up steps and one more, so its last step is a replay)."""
    from alignn_tpu_torch.ff.step_loop import (WARMUP_STEPS, StepLoop,
                                               with_item_capacity)
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.build import build_graph

    graphs = [build_graph(_rattled_si(1, rattle=r, seed=s),
                          neighbor_strategy="radius_graph", cutoff=4.5)
              for r, s in ((0.0, 0), (0.2, 3))]
    spec = BucketSpec(n_nodes=128, n_edges=512, n_lg_edges=8192, n_graphs=2)
    raw = [batch_graphs([g], spec, cuda, gather_windows=False)
           for g in graphs]
    assert raw[0].lg_index.dst.num_items != raw[1].lg_index.dst.num_items
    batches = [with_item_capacity(b) for b in raw]
    x = torch.randn(8192, 64, device=cuda)
    out = torch.zeros(512, 64, device=cuda)

    def step():
        out.copy_(ek.sorted_segment_sum(x, loop.batch.lg_index.dst))

    loop = StepLoop(step, batches[0])
    c0 = StepLoop.captures
    for b, r in zip(batches, raw):
        if b is not loop.batch:
            loop.load_batch(b)
        loop.run(WARMUP_STEPS + 1)
        torch.cuda.synchronize()
        assert torch.equal(out, ek.sorted_segment_sum_cuda(
            x, r.lg_index.dst))
        ref = ek.sorted_segment_sum_plain(x, r.lg_index.dst)
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert StepLoop.captures - c0 == 1
    bigger = with_item_capacity(batch_graphs(
        graphs[:1], BucketSpec(n_nodes=256, n_edges=512, n_lg_edges=8192,
                               n_graphs=2), cuda, gather_windows=False))
    with pytest.raises(ValueError, match="signature"):
        loop.load_batch(bigger)


def test_batch_relax_captured_matches_eager(cuda):
    """Four rattled si8 cells, Si_envelope's graph (radius 4.5): the
    captured FIRE loop against the eager one, positions within 1e-5 A."""
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.ff.relax_jit import batch_relax

    model = Calculator(path=os.path.join(
        REPO, "docs", "mlearn_r5", "Si_envelope")).model
    cells = [_rattled_si(1, rattle=0.05, seed=s) for s in range(4)]
    kw = dict(fmax=1e-3, max_steps=20, chunk_steps=10, cutoff=4.5)
    a, ea, fa = batch_relax(model, cells, **kw)
    b, eb, fb = batch_relax(model, cells, cuda_graph=False, **kw)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.cart_coords, y.cart_coords, rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(ea, eb, rtol=0, atol=1e-5)
    assert (fa < np.array([np.inf])).all()
