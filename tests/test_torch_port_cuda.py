"""alignn_tpu_torch on the card: CUDA kernels against their plain versions.

K1/K2 (``csrc/eggc.cu``) and K3/K4/K5a (``csrc/dense.cu``), then the
Calculator on the card against the port on the CPU, sparse and dense.

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
    before = {k: fn.launches for k, fn in (
        ("K3", dk.dense_gated_aggregate_cuda),
        ("K4", dk.dense_pair_aggregate_cuda),
        ("K5a", dk.pair_aggregate_bwd_cuda))}
    h3 = dk.dense_gated_aggregate_cuda(m, bh, D)
    h4 = dk.dense_pair_aggregate_cuda(m2, bh, D)
    dm2, dbh = dk.pair_aggregate_bwd_cuda(m2, bh, g, D)
    torch.cuda.synchronize()
    assert dk.dense_gated_aggregate_cuda.launches == before["K3"] + 1
    assert dk.dense_pair_aggregate_cuda.launches == before["K4"] + 1
    assert dk.pair_aggregate_bwd_cuda.launches == before["K5a"] + 1
    _close_rel(h3, dk.dense_gated_aggregate_plain(m, bh, D), dtype)
    _close_rel(h4, dk.dense_pair_aggregate_plain(m2, bh, D), dtype)
    ref_dm2, ref_dbh = dk.pair_aggregate_bwd_plain(m2, bh, g, D)
    _close_rel(dm2, ref_dm2, dtype)
    _close_rel(dbh, ref_dbh, dtype)
    # masked slots: exact zeros, no NaN
    assert torch.all(h3[0] == 0)
    assert torch.all(h4[:D] == 0) and torch.all(dbh[:D] == 0)
    assert torch.all(dm2[lg == 0] == 0)
    assert torch.isfinite(dm2.float()).all()


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
