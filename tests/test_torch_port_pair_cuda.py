"""K4 ``dense_pair_aggregate`` (``csrc/dense.cu`` ``pair_kernel``) on the
card, against its plain version:

- within 1e-5 (f32) or 1e-2 (bf16, f16) x max|plain| at D of 1, 2, 13,
  14, 18 and 35 and F of 36, 40, 256 and 512, contiguous, with a row
  stride of 2F and misaligned (the scalar path), with a slot mask that
  leaves a fully masked node and fully masked (j, t) rows, which come
  out exactly 0;
- at the largest D the kernel takes at F 256 (454), and one past it
  raises the wrapper's ValueError;
- with more rows than the card holds row slots at once (several passes
  of the persistent blocks, the last one partial);
- bit for bit where every partial sum is exact (m2 = 0, so every
  unmasked sigmoid is 1/2, and dyadic bh);
- two launches, and three replays of a CUDA graph, give the same bits.

Every test here is marked ``cuda`` and skips on a host without a GPU.
This file imports torch and numpy only:

    python -m pytest --noconftest -m cuda tests/test_torch_port_pair_cuda.py
"""

import numpy as np
import pytest
import torch

from alignn_tpu_torch.ops import dense as dk

pytestmark = pytest.mark.cuda

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
DEPTHS = (1, 2, 13, 14, 18, 35)
WIDTHS = (36, 40, 256, 512)
LAYOUTS = ("contiguous", "strided", "misaligned")
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}
D_MAX = 454   # one [D][128] f32 plane of a block's 232,448 bytes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mask(n: int, D: int, rng) -> np.ndarray:
    """[n*D*D] slot mask: about a third of the slots off, node 0 fully
    masked (a padded node), and row (1, 0) fully masked."""
    mask = (rng.random((n, D, D)) > 0.3).astype(np.float32)
    mask[0] = 0.0
    if n > 1:
        mask[1, 0] = 0.0
    return mask.reshape(-1)


def _place(t: torch.Tensor, layout: str) -> torch.Tensor:
    """t as is, as a view with row stride 2F (16-byte aligned), or as a
    view 3 elements in (misaligned)."""
    if layout == "contiguous":
        return t
    rows, f = t.shape
    big = torch.zeros(rows, 2 * f, dtype=t.dtype, device=t.device)
    at = 3 if layout == "misaligned" else f
    big[:, at:at + f] = t
    return big[:, at:at + f]


def _inputs(n, D, f, dtype, device, seed, layout="contiguous"):
    rng = np.random.default_rng(seed)
    m2 = torch.tensor(2.0 * rng.standard_normal((n * D * D, f)),
                      dtype=torch.float32, device=device).to(dtype)
    bh = torch.tensor(rng.standard_normal((n * D, f)), dtype=torch.float32,
                      device=device).to(dtype)
    mask = torch.tensor(_mask(n, D, rng), device=device)
    m2 = dk.fold_mask(m2, mask)
    return _place(m2, layout), _place(bh, layout), mask


def _check(m2, bh, mask, D, dtype):
    got = dk.dense_pair_aggregate_cuda(m2, bh, D)
    again = dk.dense_pair_aggregate_cuda(m2, bh, D)
    ref = dk.dense_pair_aggregate_plain(m2, bh, D)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == ref.shape
    assert torch.equal(got, again), "two launches differ"
    empty = mask.reshape(-1, D).sum(dim=1) == 0
    assert bool(empty.any())
    assert torch.all(got[empty] == 0), "a fully masked row is not 0"
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("D", DEPTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pair_matches_plain(cuda, dtype, D, f):
    n = 7 if D > 2 else 40
    for layout in LAYOUTS:
        m2, bh, mask = _inputs(n, D, f, dtype, cuda, D * 1000 + f, layout)
        _check(m2, bh, mask, D, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pair_largest_D(cuda, dtype):
    m2, bh, mask = _inputs(2, D_MAX, 256, dtype, cuda, 1)
    _check(m2, bh, mask, D_MAX, dtype)
    del m2, bh
    D = D_MAX + 1
    m2 = torch.zeros(D * D, 256, dtype=dtype, device=cuda)
    bh = torch.zeros(D, 256, dtype=dtype, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        dk.dense_pair_aggregate_cuda(m2, bh, D)


@pytest.mark.parametrize("f", (40, 256))
@pytest.mark.parametrize("D", (13, 18))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pair_many_passes(cuda, dtype, D, f):
    """12,600 (D 18) or 9,100 rows: more than the card's row slots."""
    m2, bh, mask = _inputs(700, D, f, dtype, cuda, 2)
    _check(m2, bh, mask, D, dtype)


@pytest.mark.parametrize("D", (1, 13, 18, 35))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pair_exact_on_dyadic_inputs(cuda, dtype, D):
    """m2 = 0 (masked slots folded below): every sigmoid is 1/2 or 0, bh
    is a multiple of 1/16 in [-4, 4], so every partial sum over s is
    exact in any order and the kernel equals the plain version bit for
    bit."""
    n = 300
    rng = np.random.default_rng(D)
    mask = torch.tensor(_mask(n, D, rng), device=cuda)
    m2 = dk.fold_mask(torch.zeros(n * D * D, 256, dtype=dtype,
                                  device=cuda), mask)
    bh = torch.tensor(rng.integers(-64, 65, (n * D, 256)) / 16.0,
                      dtype=torch.float32, device=cuda).to(dtype)
    got = dk.dense_pair_aggregate_cuda(m2, bh, D)
    ref = dk.dense_pair_aggregate_plain(m2, bh, D)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pair_graph_replay(cuda, dtype):
    """Three replays of a captured launch give the eager launch's bits."""
    m2, bh, _mask = _inputs(600, 18, 256, dtype, cuda, 3)
    eager = dk.dense_pair_aggregate_cuda(m2, bh, 18)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dk.dense_pair_aggregate_cuda(m2, bh, 18)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = dk.dense_pair_aggregate_cuda(m2, bh, 18)
    for _ in range(3):
        static.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static, eager)
