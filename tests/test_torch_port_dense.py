"""alignn_tpu_torch's dense-neighbourhood layout against alignn_tpu's.

(a) the builder, array for array; (b) K3, (c) K4 and K5a, whose plain
versions are held against the Pallas kernels in interpret mode; (d) the
dense cosines; (e) a small ALIGNNAtomWise on a dense batch; (f) the
Calculator at full width with the committed Si weights, and its routing.
Inputs come from numpy with fixed seeds and go to both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignn_tpu.ops import pallas_dense as jd
from alignn_tpu_torch.ops import dense as td

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SI_DIR = os.path.join(REPO, "docs", "mlearn_r4", "Si")
DIAMOND = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                    [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                    [0.5, 0.5, 0], [0.75, 0.75, 0.25]])
CPU = torch.device("cpu")


def _rocksalt_graphs(n=3, seed=0):
    """The rattled 8-atom rocksalt cells of tests/test_dense.py."""
    from alignn_tpu_torch.graph.build import rocksalt_graphs

    return rocksalt_graphs(n, seed, rattle=0.03)


def _si8(rattle=0.0, shift=0.0):
    """Si diamond (a = 5.43 A), optionally rattled (seed 0) and shifted."""
    from alignn_tpu_torch.chem.atoms import Atoms

    lat = np.eye(3) * 5.43
    cart = DIAMOND @ lat + np.random.default_rng(0).normal(
        0.0, rattle, (8, 3))
    cart[0] += shift
    return Atoms(lattice_mat=lat, frac_coords=cart @ np.linalg.inv(lat),
                 elements=["Si"] * 8)


def _canonized_si8():
    from alignn_tpu_torch.graph.build import build_graph

    return [build_graph(_si8(), cutoff=8.0, max_neighbors=12,
                        use_canonize=True, tie_tol=1e-6)]


def _both_batches(graphs):
    """(port dense batch, JAX dense batch) of the same graphs."""
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu.graph.dense import dense_batch_graphs as jbatch
    from alignn_tpu.graph.dense import dense_spec_for_batch as jspec
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_batch)

    spec = dense_spec_for_batch(graphs)
    jgraphs = [JGraph(**vars(g)) for g in graphs]
    js = jspec(jgraphs)
    assert (js.n_nodes, js.n_edges, js.n_lg_edges, js.n_graphs,
            js.dense_D) == tuple(vars(spec).values())
    return dense_batch_graphs(graphs, spec, CPU), jbatch(jgraphs, js)


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a.detach()), np.asarray(b),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# (a) builder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["rocksalt3", "si8_canonized"])
def test_dense_builder_equals_jax(which):
    graphs = _rocksalt_graphs() if which == "rocksalt3" else \
        _canonized_si8()
    tb, jb = _both_batches(graphs)
    assert tb.dense_D == jb.dense_D > 0
    for key in ("src", "dst", "rev", "r", "node_mask", "edge_mask",
                "lg_mask", "lg_src", "lg_dst", "z", "atom_features",
                "frac_coords", "images", "node_graph", "edge_graph",
                "lattice", "volume", "n_nodes", "graph_mask"):
        np.testing.assert_array_equal(getattr(tb, key).numpy(),
                                      np.asarray(getattr(jb, key)),
                                      err_msg=key)
    np.testing.assert_array_equal(tb.g_index.src_perm.numpy(), jb.src_perm)
    np.testing.assert_array_equal(tb.g_index.src_perm_inv.numpy(),
                                  jb.src_perm_inv)
    assert tb.lg_index is None and tb.g_index.dst is None
    ids = tb.g_index.src_sorted.ids.numpy()
    np.testing.assert_array_equal(ids, np.sort(tb.src.numpy()))


def test_pair_kernel_codes_raise():
    """dense.cu's one shared-memory guard returns ERR_SMEM, which the
    K4/K5a/K5b wrappers raise as ValueError naming D; any other nonzero
    code is a CUDA error (RuntimeError); 0 passes."""
    with pytest.raises(ValueError, match="D = 80 needs more shared memory"):
        td._raise_on_pair(td.ERR_SMEM, "pair_aggregate_bwd2", 80)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        td._raise_on_pair(1, "pair_aggregate_bwd2", 80)
    td._raise_on_pair(0, "pair_aggregate_bwd2", 80)


def test_asymmetric_edges_raise_in_both():
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu.graph.dense import AsymmetricEdgesError as JAsym
    from alignn_tpu.graph.dense import dense_batch_graphs as jbatch
    from alignn_tpu_torch.graph.build import GraphData
    from alignn_tpu_torch.graph.dense import (AsymmetricEdgesError,
                                              dense_batch_graphs,
                                              dense_spec_for_batch)

    # 0 -> 1 through the image (1, 0, 0) has no 1 -> 0 through (-1, 0, 0)
    g = GraphData(z=np.array([14, 14], np.int32),
                  frac_coords=np.zeros((2, 3)), lattice=np.eye(3) * 3,
                  volume=27.0, src=np.array([1, 0, 0], np.int32),
                  dst=np.array([0, 1, 1], np.int32), r=np.ones((3, 3)),
                  images=np.array([[0, 0, 0], [0, 0, 0], [1, 0, 0]], float),
                  lg_src=np.zeros(0, np.int32), lg_dst=np.zeros(0, np.int32))
    spec = dense_spec_for_batch([g])
    with pytest.raises(AsymmetricEdgesError):
        dense_batch_graphs([g], spec, CPU)
    with pytest.raises(JAsym):
        jbatch([JGraph(**vars(g))], spec)
    assert issubclass(AsymmetricEdgesError, ValueError)


# ---------------------------------------------------------------------------
# (b) K3, (c) K4 and K5a: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def test_dense_gated_aggregate_matches_pallas():
    """M 128, D 4, F 128, 80 % of the slots real, node 0 empty.  Value to
    rtol 1e-5 and VJP to rtol 1e-4 (sums of 4 rows in another order)."""
    M, D, F = 128, 4, 128
    rng = np.random.default_rng(0)
    m = rng.standard_normal((M * D, F)).astype(np.float32)
    bh = rng.standard_normal((M * D, F)).astype(np.float32)
    g = rng.standard_normal((M, F)).astype(np.float32)
    mask = (rng.random(M * D) < 0.8).astype(np.float32)
    mask[:D] = 0.0

    def jfn(m, bh):
        return jd.dense_gated_aggregate(jd.fold_mask(m, jnp.asarray(mask)),
                                        bh, D, True)

    h_j, vjp = jax.vjp(jfn, m, bh)
    dm_j, dbh_j = vjp(jnp.asarray(g))
    mt = torch.tensor(m, requires_grad=True)
    bt = torch.tensor(bh, requires_grad=True)
    h = td.dense_gated_aggregate(td.fold_mask(mt, torch.tensor(mask)), bt, D)
    h.backward(torch.tensor(g))
    _close(h, h_j, 1e-5, 1e-6)
    _close(mt.grad, dm_j, 1e-4, 1e-6)
    _close(bt.grad, dbh_j, 1e-4, 1e-6)
    off = mask == 0
    assert torch.all(mt.grad[off] == 0) and torch.all(bt.grad[off] == 0)
    assert torch.all(h[0] == 0)
    np.testing.assert_array_equal(
        td.fold_mask(torch.tensor(m), torch.tensor(mask)).numpy(),
        np.asarray(jd.fold_mask(jnp.asarray(m), jnp.asarray(mask))))


def _pair_problem(n=16, D=5, F=128, seed=1):
    rng = np.random.default_rng(seed)
    em = (rng.random(n * D) < 0.8).astype(np.float32)
    em[:D] = 0.0                                  # node 0 has no edges
    em[D + 1] = 0.0                               # (1, t=1) is a pad row
    lg_mask = (em.reshape(n, 1, D) * em.reshape(n, D, 1)).reshape(-1)
    m2 = rng.standard_normal((n * D * D, F)).astype(np.float32)
    m2 = (m2 + (lg_mask - 1.0)[:, None] * np.float32(1e9)).astype(np.float32)
    bh = rng.standard_normal((n * D, F)).astype(np.float32)
    g = rng.standard_normal((n * D, F)).astype(np.float32)
    return m2, bh, g, lg_mask, D


@pytest.mark.parametrize("pallas_bwd", [False, True],
                         ids=["xla_pair_bwd", "pair_bwd_kernel"])
def test_pair_aggregate_and_bwd_match_jax(monkeypatch, pallas_bwd):
    """K4 against the Pallas ``_pair_kernel`` (n 16, D 5, F 128), K5a
    against ``_xla_pair_bwd`` or, with ALIGNN_TPU_PAIR_BWD_KERNEL=1, the
    Pallas ``_pair_bwd_kernel``; all in interpret mode.  rtol 1e-5 on
    h, 1e-4 on dm2 and dbh."""
    m2, bh, g, lg_mask, D = _pair_problem()
    calls = []
    if pallas_bwd:
        monkeypatch.setenv("ALIGNN_TPU_PAIR_BWD_KERNEL", "1")
        real = jd._pallas_pair_bwd
        monkeypatch.setattr(jd, "_pallas_pair_bwd",
                            lambda *a: calls.append(1) or real(*a))
    else:
        monkeypatch.delenv("ALIGNN_TPU_PAIR_BWD_KERNEL", raising=False)
    h_j, vjp = jax.vjp(lambda m2, bh: jd.dense_pair_aggregate(m2, bh, D,
                                                              True), m2, bh)
    dm2_j, dbh_j = vjp(jnp.asarray(g))
    assert len(calls) == int(pallas_bwd)

    mt = torch.tensor(m2, requires_grad=True)
    bt = torch.tensor(bh, requires_grad=True)
    h = td.dense_pair_aggregate(mt, bt, D)
    h.backward(torch.tensor(g))
    _close(h, h_j, 1e-5, 1e-6)
    _close(mt.grad, dm2_j, 1e-4, 1e-6)
    _close(bt.grad, dbh_j, 1e-4, 1e-6)
    dm2, dbh = td.pair_aggregate_bwd(torch.tensor(m2), torch.tensor(bh),
                                     torch.tensor(g), D)
    dm2_b, dbh_b = jd.pair_aggregate_bwd(m2, bh, g, D, True)
    _close(dm2, dm2_b, 1e-4, 1e-6)
    _close(dbh, dbh_b, 1e-4, 1e-6)
    # padded (j, t) rows: h = 0 and dm2 = 0 exactly, no NaN anywhere
    pad_rows = lg_mask.reshape(-1, D).sum(axis=1) == 0
    assert pad_rows.sum() >= D + 1
    assert torch.all(h[torch.tensor(pad_rows)] == 0)
    assert torch.all(dm2.reshape(-1, D, m2.shape[1])[
        torch.tensor(pad_rows)] == 0)
    assert torch.all(dm2[torch.tensor(lg_mask == 0)] == 0)
    assert torch.isfinite(dm2).all() and torch.isfinite(dbh).all()


def test_pair_bwd2_refuses_a_third_derivative():
    """K4's second order runs (K5b); differentiating K5b raises rather
    than passing silently through a kernel with no derivative."""
    m2, bh, g, _lg, D = _pair_problem(n=4, D=3, F=8)
    mt = torch.tensor(m2, requires_grad=True)
    h = td.dense_pair_aggregate(mt, torch.tensor(bh), D)
    (dm2,) = torch.autograd.grad(h, mt, torch.tensor(g), create_graph=True)
    (c_m2,) = torch.autograd.grad(torch.sum(dm2 ** 2), mt, create_graph=True)
    assert torch.isfinite(c_m2).all()
    with pytest.raises(NotImplementedError, match="third derivative"):
        torch.autograd.grad(c_m2.sum(), mt)


def test_dense_kernel_wrappers_refuse_non_cuda_tensors():
    x = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        td.dense_gated_aggregate_cuda(x, x, 2)
    with pytest.raises(ValueError, match="CUDA"):
        td.dense_pair_aggregate_cuda(torch.zeros(16, 4), x, 2)
    with pytest.raises(ValueError, match="CUDA"):
        td.pair_aggregate_bwd_cuda(torch.zeros(16, 4), x, x, 2)
    with pytest.raises(ValueError, match="multiple of D"):
        td.dense_gated_aggregate_cuda(torch.zeros(7, 4), x, 2)
    meta = torch.empty(8, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        td.dense_gated_aggregate(meta, meta, 2)


# ---------------------------------------------------------------------------
# (d) dense cosines
# ---------------------------------------------------------------------------


def test_bond_cosines_dense_matches_jax():
    """Value to 1e-6 and VJP to 1e-5 on the canonized diamond batch: the
    diagonal s = t sits on the clip bound, trash slots are (1, 0, 0)."""
    from alignn_tpu.ops.basis import bond_cosines_dense as jcos
    from alignn_tpu_torch.ops.basis import bond_cosines_dense

    tb, _jb = _both_batches(_canonized_si8())
    D = tb.dense_D
    rng = np.random.default_rng(2)
    r = tb.r.numpy() + rng.normal(0, 0.01, tb.r.shape).astype(np.float32)
    ct = rng.standard_normal(r.shape[0] * D).astype(np.float32)
    c_j, vjp = jax.vjp(lambda r: jcos(r, D), r)
    (dr_j,) = vjp(jnp.asarray(ct))
    rt = torch.tensor(r, requires_grad=True)
    c = bond_cosines_dense(rt, D)
    c.backward(torch.tensor(ct))
    _close(c, c_j, 1e-6, 1e-6)
    _close(rt.grad, dr_j, 1e-5, 1e-5)
    # the diagonal |r|^2 / (|r| |r|) lands on the bound to within an ulp
    diag = c.detach().reshape(-1, D, D).diagonal(dim1=1, dim2=2)
    assert torch.all((diag - 1.0).abs() <= 2.0 ** -23)


# ---------------------------------------------------------------------------
# (e) model
# ---------------------------------------------------------------------------

SMALL = dict(name="alignn_atomwise", alignn_layers=2, gcn_layers=2,
             hidden_features=64, embedding_features=32,
             stresswise_weight=0.1)


@pytest.fixture(scope="module")
def dense_model_results():
    from alignn_tpu.nn.models import ALIGNNAtomWise as JModel
    from alignn_tpu.nn.models import ALIGNNAtomWiseConfig as JConfig
    from alignn_tpu.nn.models import atomwise_forward as jforward
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            atomwise_forward)

    graphs = _rocksalt_graphs()
    tb, jb = _both_batches(graphs)
    jmodel = JModel(cfg=JConfig(**SMALL))
    variables = jmodel.init(jax.random.PRNGKey(0), jb, jb.r, train=False)
    jres = jax.device_get(jforward(jmodel, variables, jb, train=False))
    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(**SMALL)).eval()
    model.load_state_dict(state_dict_from_flax(variables["params"]))
    tres = atomwise_forward(model, tb)
    sres = atomwise_forward(model, batch_graphs(
        graphs, BucketSpec.tight_for_batch(graphs), CPU))
    n = sum(g.num_nodes for g in graphs)
    return jres, tres, sres, n, len(graphs)


def test_dense_model_matches_jax(dense_model_results):
    """E, forces and stress of the dense batch (rtol 1e-4, atol 1e-5)."""
    jres, tres, _sres, n, ng = dense_model_results
    _close(tres["out"][:ng], jres["out"][:ng], 1e-4, 1e-5)
    _close(tres["en_out"][:ng], jres["en_out"][:ng], 1e-4, 1e-5)
    _close(tres["grad"][:n], jres["grad"][:n], 1e-4, 1e-5)
    _close(tres["stresses"][:ng], jres["stresses"][:ng], 1e-4, 1e-5)
    assert np.abs(jres["grad"][:n]).max() > 1e-2    # the rattle is felt
    assert np.abs(jres["stresses"][:ng]).max() > 1e-3


def test_dense_model_matches_sparse_layout(dense_model_results):
    """The port's dense layout against its sparse layout, same graphs."""
    _jres, tres, sres, n, ng = dense_model_results
    _close(tres["out"][:ng], sres["out"][:ng].detach(), 1e-4, 1e-5)
    _close(tres["grad"][:n], sres["grad"][:n].detach(), 1e-4, 1e-5)
    _close(tres["stresses"][:ng], sres["stresses"][:ng].detach(), 1e-4,
           1e-5)


# ---------------------------------------------------------------------------
# (f) Calculator
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def si_dense_results():
    """Full width, committed Si weights, use_canonize: true, rattled
    diamond8; both Calculators with dense=True, both with the numpy
    neighbour search."""
    import alignn_tpu.native
    import alignn_tpu_torch.native
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.ff.calculator import Calculator as JCalculator
    from alignn_tpu.zoo import load_model_dir
    from alignn_tpu_torch.ff.calculator import Calculator

    atoms = _si8(rattle=0.05)
    jm, jv, jc = load_model_dir(SI_DIR)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (alignn_tpu.native, alignn_tpu_torch.native):
            mp.setattr(mod, "periodic_pairs_native", lambda *a, **k: None)
        jcalc = JCalculator(model=jm, variables=jv,
                            config={**jc, "use_canonize": True}, dense=True)
        jr = jcalc.calculate(JAtoms(lattice_mat=atoms.lattice_mat,
                                    frac_coords=atoms.frac_coords,
                                    elements=atoms.elements))
        base = Calculator(path=SI_DIR, device="cpu")
        calc = Calculator(model=base.model,
                          config={**base.config, "use_canonize": True},
                          dense=True, device="cpu")
        tr = calc.calculate(atoms)
    return jr, tr, jcalc, calc


def test_dense_calculator_matches_jax(si_dense_results):
    """The sparse Calculator's limits: 1e-4 eV/atom, 5e-4 eV/A,
    1e-5 eV/A^3."""
    jr, tr, jcalc, calc = si_dense_results
    assert jcalc._spec.dense_D > 0 and calc._spec.dense_D > 0
    assert calc._spec.dense_D == jcalc._spec.dense_D
    assert abs(tr["energy"] - jr["energy"]) / 8 < 1e-4
    np.testing.assert_allclose(tr["forces"], jr["forces"], rtol=0,
                               atol=5e-4)
    np.testing.assert_allclose(tr["stress"], jr["stress"], rtol=0,
                               atol=1e-5)
    assert np.abs(tr["forces"]).max() > 0.05
    assert np.abs(tr["forces"].sum(axis=0)).max() < 1e-4


def test_dense_calculator_reuses_its_bucket(si_dense_results):
    _jr, _tr, _jcalc, calc = si_dense_results
    spec = calc._spec
    res = calc.calculate(_si8(rattle=0.05, shift=0.02))
    assert calc._spec is spec and calc._fb_spec is None
    assert res["forces"].shape == (8, 3)


def _small_calc(config, **kw):
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig)

    torch.manual_seed(0)
    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(
        alignn_layers=1, gcn_layers=1, hidden_features=16,
        embedding_features=8, stresswise_weight=0.1))
    return Calculator(model=model, config={
        "neighbor_strategy": "k-nearest", "cutoff": 8.0,
        "max_neighbors": 12, **config}, device="cpu", **kw)


def test_uncanonized_config_routes_sparse(capsys):
    """Duplicated k-NN edges give an in-degree above 20 (25 here):
    sparse, with the reason printed once."""
    calc = _small_calc({"use_canonize": False, "dense_neighborhoods": True})
    assert calc.dense
    res = calc.calculate(_si8(rattle=0.05))
    calc.calculate(_si8(rattle=0.05))
    out = capsys.readouterr().out
    assert out.count("dense layout skipped: in-degree") == 1
    assert int(out.split("in-degree ")[1].split()[0]) > 20
    assert calc._spec is None and calc._fb_spec.dense_D == 0
    assert np.isfinite(res["energy"])


def test_asymmetric_fallback_is_per_call(monkeypatch, capsys):
    """An injected AsymmetricEdgesError sends one call sparse; the next
    call runs dense again; any other ValueError propagates."""
    import alignn_tpu_torch.graph.dense as gd

    calc = _small_calc({"use_canonize": True}, dense=True)
    atoms = _si8(rattle=0.05)
    real = gd.dense_batch_graphs
    fail = {"n": 1}

    def flaky(*a, **kw):
        if fail["n"]:
            fail["n"] -= 1
            raise gd.AsymmetricEdgesError("injected asymmetry")
        return real(*a, **kw)

    monkeypatch.setattr(gd, "dense_batch_graphs", flaky)
    r1 = calc.calculate(atoms)
    assert "dense layout unavailable" in capsys.readouterr().out
    assert calc.dense and calc._fb_spec is not None
    r2 = calc.calculate(atoms)
    assert calc._spec.dense_D > 0
    np.testing.assert_allclose(r2["energy"], r1["energy"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(r2["forces"], r1["forces"], atol=1e-5)
    np.testing.assert_allclose(r2["stress"], r1["stress"], atol=1e-6)

    def broken(*a, **kw):
        raise ValueError("inconsistent dense spec")

    monkeypatch.setattr(gd, "dense_batch_graphs", broken)
    with pytest.raises(ValueError, match="inconsistent"):
        calc.calculate(atoms)


def test_dense_neighborhoods_config_is_the_default():
    assert _small_calc({"dense_neighborhoods": True}).dense
    assert not _small_calc({}).dense
    assert not _small_calc({"dense_neighborhoods": True}, dense=False).dense
