"""K1 and K2 (``csrc/eggc.cu``) on the card: one launch a call, in-launch
completion of segments of several work items, deterministic sums.

Every case runs on one set of segments with leading, interior and
trailing empty ones and segments of 1, 2, C - 1, C, C + 1, 32 C (32 work
items of C = ``CHUNK_ROWS`` rows: one full combine group), 32 C + 1 (two
groups) and 20,000 rows, as built and padded to their most work items
(``with_capacity``):

- K2 on dyadic inputs equals its plain version bit for bit (every f32
  partial sum is exact, so the order does not matter), in each dtype;
- K1 within 1e-5 (f32) or 1e-2 (bf16, f16) of max|plain|, also with
  every gate at sigmoid(-30) (den -> eps);
- two launches, and three replays of a CUDA graph, give the same bits;
- empty segments come out exactly 0;
- F of 36 (the scalar path), 40, 256 and 512, contiguous, with a row
  stride of 2F, and misaligned (the scalar path);
- the arrival counters are back at 0 after every call.

Every test here is marked ``cuda`` and skips on a host without a GPU.
This file imports torch and numpy only:

    python -m pytest --noconftest -m cuda tests/test_torch_port_segments_cuda.py
"""

import numpy as np
import pytest
import torch

from alignn_tpu_torch.ops import eggc as ek

pytestmark = pytest.mark.cuda

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
C = ek.CHUNK_ROWS
LENGTHS = (0, 1, 0, 2, C - 1, 0, 0, C, C + 1, 32 * C, 32 * C + 1, 1, 20000,
           0, 0)
WIDTHS = (36, 40, 256, 512)
LAYOUTS = ("contiguous", "strided", "misaligned")
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _segments(device, padded: bool) -> ek.Segments:
    ids = np.repeat(np.arange(len(LENGTHS)), LENGTHS)
    seg = ek.Segments.from_sorted(torch.as_tensor(ids, device=device),
                                  len(LENGTHS))
    return seg.with_capacity(seg.max_items() + 5) if padded else seg


def _table(values: np.ndarray, dtype, device, layout: str):
    """[rows, F] of `values` in `dtype`: contiguous, a view with row
    stride 2F (16-byte aligned), or a view 3 elements in (misaligned)."""
    rows, f = values.shape
    t = torch.tensor(values, dtype=torch.float32, device=device).to(dtype)
    if layout == "contiguous":
        return t
    big = torch.zeros(rows, 2 * f, dtype=dtype, device=device)
    at = 3 if layout == "misaligned" else f
    big[:, at:at + f] = t
    return big[:, at:at + f]


def _empty(seg):
    return (seg.row_ptr[1:] == seg.row_ptr[:-1]).nonzero().flatten()


def _check_common(seg, out, again):
    torch.cuda.synchronize()
    assert torch.equal(out, again), "two launches differ"
    assert torch.all(out[_empty(seg)] == 0)
    assert not seg.counters.any(), "arrival counters left non-zero"


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_segment_sum_exact(cuda, dtype, f, layout, padded):
    seg = _segments(cuda, padded)
    rng = np.random.default_rng(f)
    x = _table(rng.integers(-64, 65, (seg.ids.shape[0], f)) / 16, dtype,
               cuda, layout)
    before = ek.sorted_segment_sum_cuda.launches
    out = ek.sorted_segment_sum_cuda(x, seg)
    assert ek.sorted_segment_sum_cuda.launches == before + 1
    _check_common(seg, out, ek.sorted_segment_sum_cuda(x, seg))
    assert out.dtype == dtype and out.shape == (len(LENGTHS), f)
    assert torch.equal(out, ek.sorted_segment_sum_plain(x, seg))


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_aggregate_matches_plain(cuda, dtype, f, layout, padded):
    seg = _segments(cuda, padded)
    rng = np.random.default_rng(f + 1)
    rows = seg.ids.shape[0]
    m = _table(rng.standard_normal((rows, f)), dtype, cuda, layout)
    bh = _table(rng.standard_normal((rows, f)), dtype, cuda, layout)
    before = ek.gated_aggregate_cuda.launches
    h = ek.gated_aggregate_cuda(m, bh, seg)
    assert ek.gated_aggregate_cuda.launches == before + 1
    _check_common(seg, h, ek.gated_aggregate_cuda(m, bh, seg))
    ref = ek.gated_aggregate_plain(m, bh, seg).float()
    err = (h.float() - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item(), err


@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_aggregate_saturated_gates(cuda, dtype):
    """Every gate at sigmoid(-30) ~ 9e-14: den is eps to six digits, so
    h ~ 1e-7 * sum(bh); the kernel divides as the plain version does."""
    seg = _segments(cuda, padded=False)
    rows = seg.ids.shape[0]
    rng = np.random.default_rng(5)
    m = torch.full((rows, 256), -30.0, device=cuda, dtype=dtype)
    bh = _table(rng.standard_normal((rows, 256)), dtype, cuda, "contiguous")
    h = ek.gated_aggregate_cuda(m, bh, seg)
    _check_common(seg, h, ek.gated_aggregate_cuda(m, bh, seg))
    assert torch.isfinite(h).all()
    ref = ek.gated_aggregate_plain(m, bh, seg).float()
    err = (h.float() - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item(), err


@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_graph_replays_repeat(cuda, dtype):
    """K1 and K2 captured once on padded segments: three replays, the
    last on new inputs copied into the captured ones, each equal bit for
    bit to an eager launch on the same inputs, the counters back at 0."""
    seg = _segments(cuda, padded=True)
    rows, f = seg.ids.shape[0], 256
    rng = np.random.default_rng(9)

    def draw():
        return [_table(rng.standard_normal((rows, f)), dtype, cuda,
                       "contiguous") for _ in range(2)]

    m, bh = draw()

    def step():
        return (ek.gated_aggregate_cuda(m, bh, seg),
                ek.sorted_segment_sum_cuda(bh, seg))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    for replay in range(3):
        if replay == 2:
            new_m, new_bh = draw()
            m.copy_(new_m)
            bh.copy_(new_bh)
        graph.replay()
        torch.cuda.synchronize()
        assert not seg.counters.any()
        for got, want in zip(captured, step()):
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"replay {replay}"
        assert not seg.counters.any()
