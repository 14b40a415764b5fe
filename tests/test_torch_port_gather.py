"""alignn_tpu_torch's windowed gather (K8) and gather windows against
alignn_tpu's.

(a) the window helpers against ``alignn_tpu.ops.pallas_gather``'s; (b) the
plain ``windowed_gather_plain`` against JAX's ``windowed_gather`` (Pallas in
interpret mode), bit for bit, and the static eligibility rule; (c) the
batch's six ``win_*`` against JAX ``batch_graphs``'; (d) ``sorted_gather``,
``gather_nodes`` and ``gated_aggregate`` with windows against JAX with
``use_pallas=True``: value, VJP and grad-of-grad; (e) a 1+1/128 model with
``ALIGNN_TPU_FORCE_PALLAS`` and ``ALIGNN_TPU_ENABLE_WGATHER`` set: E/F/S and
the step-0 gradients against JAX, and windowed against unwindowed in the
port; (f) on the card, K8 against its plain version (marked ``cuda``).

JAX is imported inside the tests, so that the ``cuda`` tests run on a host
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_gather.py
"""

import numpy as np
import pytest
import torch

from alignn_tpu_torch.ops import gather as tg
from torch_port_threads import _two_threads  # noqa: E402,F401

CPU = torch.device("cpu")
LR = 1e-3
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _blocky(rng, blocks, refs_per_block, trash, quantum=512):
    """Batched-graph-style indices (tests/test_pallas_gather.py): per block
    random refs into the block, then trash up to a multiple of
    `quantum`."""
    idx, off = [], 0
    for b in blocks:
        idx.extend(off + rng.integers(0, b, size=refs_per_block * b))
        off += b
    m = -(-len(idx) // quantum) * quantum
    return np.array(list(idx) + [trash] * (m - len(idx)), dtype=np.int64)


def _case(name: str, F: int = 256):
    """(x [rows, F] f32, idx int64, window) of a K8 case.

    blocky: graph blocks with a trash tail, window from window_for;
    below_span: the same indices with window 256, under their span, so
    real rows past the window read 0; sparse_tile: one all-trash tile and
    one with 40 real rows; tile256 / tile128: index lengths whose
    supertile is 256 or 128."""
    rng = np.random.default_rng(0)
    rows = 1280
    x = rng.standard_normal((rows, F)).astype(np.float32)
    trash = rows - 1
    if name in ("blocky", "below_span"):
        idx = _blocky(rng, [180, 200, 150, 190, 170, 160], 4, trash)
    elif name == "sparse_tile":
        idx = np.full(1024, trash, np.int64)
        idx[812:852] = 7
    else:
        q = 256 if name == "tile256" else 128
        idx = _blocky(rng, [60, 90, 40], 3, trash, q)
        idx = np.concatenate([idx, np.full(q, trash, np.int64)]) \
            if len(idx) % (2 * q) == 0 else idx
        assert tg.supertile_for(len(idx)) == q
    window = 256 if name == "below_span" else tg.window_for(idx, trash)
    assert window > 0
    return x, idx, window


K8_CASES = ["blocky", "below_span", "sparse_tile", "tile256", "tile128"]


# ---------------------------------------------------------------------------
# (a) window helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("quantum", [512, 256, 128])
def test_window_helpers_match_jax(seed, quantum):
    """supertile_for, max_tile_span and window_for equal JAX's on blocky
    indices, sorted and unsorted, with blocks small and too large for a
    window (window 0)."""
    from alignn_tpu.ops import pallas_gather as jg

    rng = np.random.default_rng(seed)
    for blocks in ([30, 70, 50, 90], [400, 700, 300], [2500, 100]):
        trash = sum(blocks) + 5
        idx = _blocky(rng, blocks, 3, trash, quantum)
        for a in (idx, np.sort(idx)):
            ja = a.astype(np.int32)
            assert tg.supertile_for(len(a)) == jg.supertile_for(len(a))
            for tile in (512, 256, 128):
                assert tg.max_tile_span(a, trash, tile) == \
                    jg.max_tile_span(ja, trash, tile)
            assert tg.window_for(a, trash) == jg.window_for(ja, trash)
        assert tg.supertile_for(len(idx) + 64) == 0
        assert tg.window_for(np.concatenate([idx, idx[:64]]), trash) == 0
    assert tg.window_for(_blocky(rng, [2500], 1, 9999), 9999) == 0


# ---------------------------------------------------------------------------
# (b) the plain version against JAX, and the eligibility rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", K8_CASES)
def test_plain_matches_jax_bit_for_bit(name, dtype):
    """windowed_gather_plain equals JAX's windowed_gather (Pallas K8 in
    interpret mode) bit for bit; kept rows hold x[idx], every other row is
    exactly +0."""
    import jax.numpy as jnp

    from alignn_tpu.ops import pallas_gather as jg

    x, idx, w = _case(name)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    ref = np.asarray(jg.windowed_gather(jx, jnp.asarray(idx, jnp.int32), w))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(DTYPES[dtype])
    got = tg.windowed_gather_plain(tx, torch.tensor(idx), w)
    got_np = _np(got.view(torch.int16 if dtype == "bfloat16"
                          else torch.int32))
    assert np.array_equal(got_np, ref.view(got_np.dtype))
    kept = (got != 0).any(dim=1).numpy()
    trash = x.shape[0] - 1
    assert not kept[idx == trash].any()
    assert torch.equal(got[kept], tx[torch.tensor(idx[kept])])
    assert torch.all(got[~kept].view(torch.int16 if dtype == "bfloat16"
                                     else torch.int32) == 0)
    if name == "below_span":
        assert (~kept & (idx != trash)).sum() > 0   # real rows past window


@pytest.mark.parametrize("why", ["window0", "window_over_cap",
                                 "window_not_quantum", "float64", "float16",
                                 "narrow_features", "no_supertile"])
def test_ineligible_shapes_take_plain_index(why, monkeypatch):
    """Every failing case of the static rule gives x[idx], trash rows
    reading x[trash], without the window path; JAX's windowed_gather
    agrees where it takes the dtype."""
    import jax.numpy as jnp

    from alignn_tpu.ops import pallas_gather as jg

    x, idx, w = _case("blocky")
    dtype = {"float64": torch.float64, "float16": torch.float16}.get(
        why, torch.float32)
    if why == "window0":
        w = 0
    elif why == "window_over_cap":
        w = 2304
    elif why == "window_not_quantum":
        w = 384
    elif why == "narrow_features":
        x = x[:, :64]
    elif why == "no_supertile":
        idx = idx[:-64]
    tx, tidx = torch.tensor(x).to(dtype), torch.tensor(idx)
    assert not tg.eligible(tx, tidx, w)
    calls = []
    monkeypatch.setattr(tg, "windowed_gather_plain",
                        lambda *a: calls.append(1))
    got = tg.windowed_gather(tx, tidx, w)
    assert not calls
    assert torch.equal(got, tx[tidx])
    assert bool((got[tidx == x.shape[0] - 1] != 0).any())
    if dtype == torch.float32:
        ref = jg.windowed_gather(jnp.asarray(x), jnp.asarray(idx, jnp.int32),
                                 w)
        np.testing.assert_array_equal(_np(got), np.asarray(ref))


def test_eligible_shape_takes_the_window():
    x, idx, w = _case("blocky")
    tx, tidx = torch.tensor(x), torch.tensor(idx)
    assert tg.eligible(tx, tidx, w)
    got = tg.windowed_gather(tx, tidx, w)
    assert torch.all(got[tidx == x.shape[0] - 1] == 0)
    assert torch.equal(got, tg.windowed_gather_plain(tx, tidx, w))


def test_cuda_wrapper_refuses_cpu_tensors():
    x, idx, w = _case("blocky")
    with pytest.raises(ValueError, match="CUDA"):
        tg.windowed_gather_cuda(torch.tensor(x), torch.tensor(idx), w)


# ---------------------------------------------------------------------------
# (c) the batch's windows
# ---------------------------------------------------------------------------


def _big_graph(rng, n_nodes=30, n_edges=2600, n_lg=600):
    """A synthetic graph whose L-edge sources span more edges than any
    window (win_lg_src comes out 0); dst and lg_dst ascending, lg_dst
    within 300 edges, indices graph-local."""
    from alignn_tpu_torch.graph.build import GraphData

    dst = np.sort(rng.integers(0, n_nodes, n_edges)).astype(np.int32)
    lg_dst = np.sort(rng.integers(0, 300, n_lg)).astype(np.int32)
    return GraphData(
        z=np.full(n_nodes, 11, np.int32),
        frac_coords=rng.random((n_nodes, 3)), lattice=np.eye(3) * 9.0,
        volume=729.0, src=rng.integers(0, n_nodes, n_edges).astype(np.int32),
        dst=dst, r=rng.standard_normal((n_edges, 3)) + 3.0,
        images=np.zeros((n_edges, 3)),
        lg_src=rng.integers(0, n_edges, n_lg).astype(np.int32),
        lg_dst=lg_dst)


@pytest.mark.parametrize("spec_kind", ["tight", "for_graphs"])
def test_batch_windows_match_jax(spec_kind):
    """The six win_* of the port's batch_graphs equal JAX's on the same
    graphs and bucket (BucketSpec.for_graphs equal too); a graph too
    large for a window gives 0; gather_windows=False leaves all 0."""
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu_torch.graph.batch import (WIN_FIELDS, BucketSpec,
                                              batch_graphs)
    from alignn_tpu_torch.graph.build import rocksalt_graphs

    graphs = rocksalt_graphs(6, 0)
    for gs in (graphs, graphs[:2] + [_big_graph(np.random.default_rng(1))]):
        jgs = [JGraph(**vars(g)) for g in gs]
        if spec_kind == "tight":
            spec = BucketSpec.tight_for_batch(gs)
            jspec = JSpec.tight_for_batch(jgs)
        else:
            spec = BucketSpec.for_graphs(gs, len(gs), slack=1.1)
            jspec = JSpec.for_graphs(jgs, len(jgs), slack=1.1)
        assert vars(spec) == {k: getattr(jspec, k) for k in vars(spec)}
        got = batch_graphs(gs, spec, CPU)
        ref = jbatch(jgs, jspec)
        assert [getattr(got, k) for k in WIN_FIELDS] == \
            [getattr(ref, k) for k in WIN_FIELDS]
        assert got.win_src > 0 and got.win_lg_dst > 0
        off = batch_graphs(gs, spec, CPU, gather_windows=False)
        assert [getattr(off, k) for k in WIN_FIELDS] == [0] * 6
    assert got.win_lg_src == 0 and got.win_lg_dst > 0


def test_dense_batch_has_no_windows():
    from alignn_tpu_torch.graph.batch import WIN_FIELDS
    from alignn_tpu_torch.graph.build import rocksalt_graphs
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_batch)

    gs = rocksalt_graphs(2, 0)
    b = dense_batch_graphs(gs, dense_spec_for_batch(gs), CPU)
    assert [getattr(b, k) for k in WIN_FIELDS] == [0] * 6


# ---------------------------------------------------------------------------
# (d) the differentiable ops with windows
# ---------------------------------------------------------------------------


def _op_problem():
    """One [128, 128] node table (trash row 127), 512 dst-sorted edges of
    five graph blocks with a trash tail, src inside each edge's block;
    the stable argsort of src; the windows of dst, src and src[perm]."""
    from alignn_tpu_torch.ops.eggc import Segments

    rng = np.random.default_rng(3)
    n, F, trash = 128, 128, 127
    blocks = [20, 25, 30, 18, 22]
    dst, src, off = [], [], 0
    for b in blocks:
        k = 4 * b
        dst.extend(np.sort(off + rng.integers(0, b, k)))
        src.extend(off + rng.integers(0, b, k))
        off += b
    pad = 512 - len(dst)
    dst = np.array(dst + [trash] * pad, np.int64)
    src = np.array(src + [trash] * pad, np.int64)
    perm = np.argsort(src, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    wins = dict(dst=tg.window_for(dst, trash), src=tg.window_for(src, trash),
                src_sorted=tg.window_for(src[perm], trash))
    assert min(wins.values()) > 0
    t = torch.tensor
    port = dict(seg=Segments.from_sorted(t(dst), n), src=t(src),
                perm=t(perm), inv=t(inv),
                seg_sorted=Segments.from_sorted(t(src[perm]), n))
    x = rng.standard_normal((n, F)).astype(np.float32)
    m = rng.standard_normal((len(dst), F)).astype(np.float32)
    bh = rng.standard_normal((len(dst), F)).astype(np.float32)
    return dict(n=n, dst=dst, src=src, perm=perm, inv=inv, wins=wins,
                port=port, x=x, m=m, bh=bh, rng=rng)


def _op_fns(op, p):
    """(JAX fn, port fn) of one or two operands."""
    import jax.numpy as jnp

    from alignn_tpu.ops import pallas_eggc as je
    from alignn_tpu_torch.ops import eggc as te

    n, w, pt = p["n"], p["wins"], p["port"]
    jdst, jsrc = jnp.asarray(p["dst"], jnp.int32), jnp.asarray(p["src"],
                                                                jnp.int32)
    jperm, jinv = jnp.asarray(p["perm"], jnp.int32), jnp.asarray(p["inv"],
                                                                 jnp.int32)
    if op == "sorted_gather":
        return (lambda x: je.sorted_gather(x, jdst, n, True, w["dst"]),
                lambda x: te.sorted_gather(x, pt["seg"], w["dst"]))
    if op == "gather_nodes":
        return (lambda x: je.gather_nodes(x, jsrc, jperm, jinv, n, True,
                                          w["src"], w["src_sorted"]),
                lambda x: te.gather_nodes(x, pt["src"], pt["perm"],
                                          pt["inv"], pt["seg_sorted"],
                                          w["src"], w["src_sorted"]))
    return (lambda a, b: je.gated_aggregate(a, b, jdst, n, True, w["dst"]),
            lambda a, b: te.gated_aggregate(a, b, pt["seg"], w["dst"]))


@pytest.fixture(scope="module")
def op_problem():
    return _op_problem()


@pytest.mark.parametrize("op", ["sorted_gather", "gather_nodes",
                                "gated_aggregate"])
def test_windowed_ops_match_jax(op, op_problem, monkeypatch):
    """Value, VJP and grad-of-grad against JAX's custom VJPs with
    use_pallas=True (Pallas K1, K2 and K8 in interpret mode), f32.  The
    gathers' values are bit-equal with trash rows exactly 0; the rest to
    rtol 1e-4, atol 1e-5 x max|ref| (sums in another order).  Both
    packages went through their windowed gather at every order."""
    import jax
    import jax.numpy as jnp

    from alignn_tpu.ops import pallas_gather as jg

    p = op_problem
    jfn, tfn = _op_fns(op, p)
    args = (p["x"],) if op != "gated_aggregate" else (p["m"], p["bh"])
    jcalls, tcalls = [], []
    real_j, real_t = jg._windowed_gather_impl, tg.windowed_gather_plain
    monkeypatch.setattr(jg, "_windowed_gather_impl",
                        lambda *a: jcalls.append(1) or real_j(*a))
    monkeypatch.setattr(tg, "windowed_gather_plain",
                        lambda *a: tcalls.append(1) or real_t(*a))

    ref = np.asarray(jfn(*args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = tfn(*ts)
    rng = np.random.default_rng(11)
    wout = rng.standard_normal(ref.shape).astype(np.float32)
    if op == "gated_aggregate":
        np.testing.assert_allclose(_np(out), ref, rtol=1e-5, atol=1e-6)
    else:
        assert np.array_equal(_np(out), ref)
        trash_rows = (p["dst"] if op == "sorted_gather" else p["src"]) == \
            p["n"] - 1
        assert np.all(ref[trash_rows] == 0)

    def jloss(*a):
        return jnp.sum(wout * jfn(*a) ** 2)

    jvjp = jax.grad(jloss, argnums=tuple(range(len(args))))(*args)
    tvjp = torch.autograd.grad(torch.sum(torch.tensor(wout) * out ** 2), ts,
                               create_graph=True)
    for got, r in zip(tvjp, jvjp):
        np.testing.assert_allclose(_np(got), np.asarray(r), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(r)).max())

    def jgg(*a):
        gs = jax.grad(jloss, argnums=tuple(range(len(args))))(*a)
        return sum(jnp.sum(g ** 2) for g in gs)

    jgg_ref = jax.grad(jgg, argnums=tuple(range(len(args))))(*args)
    tgg = torch.autograd.grad(sum(torch.sum(g ** 2) for g in tvjp), ts)
    for got, r in zip(tgg, jgg_ref):
        r = np.asarray(r)
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(_np(got), r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max())
    # forward, and the gathers of the backward (VJP of the segment sums,
    # the [ginv | gh] gather) and of the second order
    assert len(jcalls) >= 2 and len(tcalls) >= 2, (jcalls, tcalls)


# ---------------------------------------------------------------------------
# (e) the windowed model
# ---------------------------------------------------------------------------

SMALL = dict(name="alignn_atomwise", alignn_layers=1, gcn_layers=1,
             hidden_features=128, embedding_features=32,
             gradwise_weight=10.0, stresswise_weight=0.1,
             graphwise_weight=1.0)


def _port_run(params, batch):
    """(E/F/S, step-0 loss components, every parameter's gradient) of the
    port's E/F/S loss on `batch`, one forward and backward."""
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig)
    from alignn_tpu_torch.train.state import _forward_and_loss

    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**SMALL))
    model.load_state_dict(state_dict_from_flax(params))
    model.train()
    losses, res = _forward_and_loss(model, batch, "l1", False,
                                    create_graph=True)
    losses["loss"].backward()
    return ({k: _np(res[k]) for k in ("out", "grad", "stresses")},
            {k: float(v.detach()) for k, v in losses.items()},
            {k: p.grad.clone() if p.grad is not None
             else torch.zeros_like(p) for k, p in model.named_parameters()})


@pytest.fixture(scope="module")
def windowed_runs():
    """2 rocksalt cells (8 atoms each), a 1+1/128 model from one JAX init:
    JAX's E/F/S loss and its gradient with ALIGNN_TPU_FORCE_PALLAS and
    ALIGNN_TPU_ENABLE_WGATHER set (one jit), the port's with the switch
    on, and the port's with it off."""
    import jax
    from flax import core

    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu.nn.models import ALIGNNAtomWise as JModel
    from alignn_tpu.nn.models import ALIGNNAtomWiseConfig as JConfig
    from alignn_tpu.ops import pallas_gather as jg
    from alignn_tpu.train.state import _forward_and_loss
    from alignn_tpu_torch.graph.batch import WIN_FIELDS, BucketSpec, \
        batch_graphs
    from alignn_tpu_torch.graph.build import rocksalt_graphs
    from alignn_tpu_torch.nn.convert import state_dict_from_flax

    graphs = rocksalt_graphs(2, 0)
    jgraphs = [JGraph(**vars(g)) for g in graphs]
    jb = jbatch(jgraphs, JSpec.tight_for_batch(jgraphs), target_width=1)
    tb = batch_graphs(graphs, BucketSpec.tight_for_batch(graphs), CPU,
                      target_width=1)
    jmodel = JModel(cfg=JConfig(**SMALL))
    out = {"n": sum(g.num_nodes for g in graphs), "ng": len(graphs),
           "windows": [getattr(tb, k) for k in WIN_FIELDS],
           "jwindows": [getattr(jb, k) for k in WIN_FIELDS]}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALIGNN_TPU_FORCE_PALLAS", "1")
        mp.setenv("ALIGNN_TPU_ENABLE_WGATHER", "1")
        params = jax.jit(lambda key, b: jmodel.init(key, b, b.r,
                                                    train=False))(
            jax.random.PRNGKey(0), jb)["params"]
        jcalls, tcalls = [], []
        real_j, real_t = jg._windowed_gather_impl, tg.windowed_gather_plain
        mp.setattr(jg, "_windowed_gather_impl",
                   lambda *a: jcalls.append(1) or real_j(*a))
        mp.setattr(tg, "windowed_gather_plain",
                   lambda *a: tcalls.append(1) or real_t(*a))
        (_, (jl0, jres, _s)), jgr = jax.jit(jax.value_and_grad(
            lambda p: _forward_and_loss(jmodel, p, core.FrozenDict(), jb,
                                        "l1", False, True),
            has_aux=True))(params)
        out["jres"] = {k: np.asarray(jres[k])
                       for k in ("out", "grad", "stresses")}
        out["jl0"] = {k: float(v) for k, v in jl0.items()}
        out["jgrads"] = state_dict_from_flax(jgr)
        out["windowed"] = _port_run(params, tb)
        out["calls"] = (len(jcalls), len(tcalls))
    out["unwindowed"] = _port_run(params, tb)
    return out


def test_both_packages_took_the_window_path(windowed_runs):
    """The batch's windows are JAX's and all six are used; both packages
    ran their windowed gather (JAX while tracing, the port per call)."""
    assert windowed_runs["windows"] == windowed_runs["jwindows"]
    assert min(windowed_runs["windows"]) > 0
    jcalls, tcalls = windowed_runs["calls"]
    assert jcalls > 0 and tcalls > 0, windowed_runs["calls"]


def test_windowed_model_matches_jax(windowed_runs):
    """E/F/S at the limits of the port's model tests: energy rtol 2e-4,
    atol 2e-5; forces and stress rtol 5e-4, atol 5e-5.  Step-0 loss
    components to rtol 1e-4 and every parameter's gradient to rtol 1e-3,
    atol 1e-5 x that tensor's max|grad|."""
    j = windowed_runs["jres"]
    t, losses, grads = windowed_runs["windowed"]
    n, ng = windowed_runs["n"], windowed_runs["ng"]
    np.testing.assert_allclose(t["out"][:ng], j["out"][:ng], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(t["grad"][:n], j["grad"][:n], rtol=5e-4,
                               atol=5e-5)
    np.testing.assert_allclose(t["stresses"][:ng], j["stresses"][:ng],
                               rtol=5e-4, atol=5e-5)
    assert np.abs(j["grad"][:n]).max() > 1e-2
    for k, ref in windowed_runs["jl0"].items():
        np.testing.assert_allclose(losses[k], ref, rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert set(grads) == set(windowed_runs["jgrads"])
    for k, ref in windowed_runs["jgrads"].items():
        np.testing.assert_allclose(_np(grads[k]), _np(ref), rtol=1e-3,
                                   atol=1e-5 * float(ref.abs().max()),
                                   err_msg=k)


def test_windowed_matches_unwindowed_port(windowed_runs):
    """The switch changes only padded rows: E/F/S on real rows, the loss
    components and the gradients agree with the unwindowed port (rtol
    1e-5; gradients within 1e-5 x max|grad|)."""
    (tw, lw, gw), (tu, lu, gu) = (windowed_runs["windowed"],
                                  windowed_runs["unwindowed"])
    n, ng = windowed_runs["n"], windowed_runs["ng"]
    for k, rows in (("out", ng), ("grad", n), ("stresses", ng)):
        np.testing.assert_allclose(tw[k][:rows], tu[k][:rows], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in lu:
        np.testing.assert_allclose(lw[k], lu[k], rtol=1e-5, err_msg=k)
    for k, ref in gu.items():
        np.testing.assert_allclose(_np(gw[k]), _np(ref), rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# (f) K8 on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "row_strided",
                                    "unaligned", "wide"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("name", K8_CASES)
def test_k8_matches_plain(cuda, name, dtype, layout):
    """K8 equals windowed_gather_plain exactly (torch.equal) on every case:
    a unit-stride table, one whose rows are strided (a column slice of a
    wider table), one whose rows are not 16-byte aligned (the element-wise
    copy) and F = 512; f16 rows are copied as bf16 ones.  One launch per
    call."""
    from alignn_tpu_torch.ops import gather as gk

    x, idx, w = _case(name, 512 if layout == "wide" else 256)
    F = x.shape[1]
    big = torch.tensor(np.concatenate([x, x[:, :16]], axis=1), device=cuda,
                       dtype=DTYPES[dtype])
    tx = {"row_strided": big[:, :F], "unaligned": big[:, 1:F + 1]}.get(
        layout, big[:, :F].contiguous())
    assert tx.stride(1) == 1
    tidx = torch.tensor(idx, device=cuda)
    before = gk.windowed_gather_cuda.launches
    got = gk.windowed_gather_cuda(tx, tidx, w)
    torch.cuda.synchronize()
    assert gk.windowed_gather_cuda.launches == before + 1
    assert torch.equal(got, gk.windowed_gather_plain(tx, tidx, w))
    if dtype != "float16":   # f16 takes x[idx] in the model, as in JAX
        assert torch.equal(gk.windowed_gather(tx, tidx, w), got)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sorted_gather", "gather_nodes",
                                "gated_aggregate"])
def test_windowed_ops_on_card_match_cpu(cuda, op):
    """The windowed Functions on the card (K8, K2, K1) against the port on
    the CPU: value and VJP to rtol 1e-5, atol 1e-5 x max|ref|; K8 ran."""
    from alignn_tpu_torch.ops import eggc as te
    from alignn_tpu_torch.ops import gather as gk

    p = _op_problem()
    args = (p["x"],) if op != "gated_aggregate" else (p["m"], p["bh"])
    res = []
    for dev in (cuda, CPU):
        pt = p["port"]
        if dev.type == "cuda":
            pt = {k: (v if isinstance(v, torch.Tensor) else
                      te.Segments.from_sorted(v.ids.to(dev), v.num))
                  for k, v in pt.items()}
            pt = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                  for k, v in pt.items()}
        w = p["wins"]
        ts = [torch.tensor(a, device=dev, requires_grad=True) for a in args]
        before = gk.windowed_gather_cuda.launches
        if op == "sorted_gather":
            out = te.sorted_gather(ts[0], pt["seg"], w["dst"])
        elif op == "gather_nodes":
            out = te.gather_nodes(ts[0], pt["src"], pt["perm"], pt["inv"],
                                  pt["seg_sorted"], w["src"],
                                  w["src_sorted"])
        else:
            out = te.gated_aggregate(ts[0], ts[1], pt["seg"], w["dst"])
        grads = torch.autograd.grad((out ** 2).sum(), ts)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert gk.windowed_gather_cuda.launches > before
        res.append([out.detach().cpu()] + [g.cpu() for g in grads])
    for got, ref in zip(*res):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))
