"""alignn_tpu_torch on the card: CUDA kernels against their plain versions.

Every test here is marked ``cuda`` and skips on a host without a GPU.
This file imports torch and numpy only (the card's host has no JAX), so
on the card run it without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import os

import numpy as np
import pytest
import torch

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
