"""alignn_tpu_torch host side against alignn_tpu: graph, batch, features,
checkpoint decoder, import hygiene and the default device."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_port_threads import _two_threads  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SI_DIR = os.path.join(REPO, "docs", "mlearn_r4", "Si")
DIAMOND = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                    [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                    [0.5, 0.5, 0], [0.75, 0.75, 0.25]])


def _structures():
    """(name, lattice, frac): diamond Si and a rattled 2x2x2 supercell."""
    from alignn_tpu_torch.chem.atoms import Atoms

    prim = Atoms(lattice_mat=np.eye(3) * 5.43, frac_coords=DIAMOND,
                 elements=["Si"] * 8)
    sc = prim.make_supercell([2, 2, 2])
    rng = np.random.default_rng(0)
    cart = sc.cart_coords + rng.normal(0.0, 0.03, sc.cart_coords.shape)
    frac = cart @ np.linalg.inv(sc.lattice_mat)
    return [("diamond", prim.lattice_mat, prim.frac_coords),
            ("rattled64", sc.lattice_mat, frac)]


@pytest.fixture
def numpy_neighbors(monkeypatch):
    """A C++ cell list orders tied pairs otherwise than the numpy search;
    both packages take the numpy search here, to compare like with like
    (tests/test_torch_port_native.py compares their C++ lists)."""
    import alignn_tpu.native
    import alignn_tpu_torch.native

    for mod in (alignn_tpu.native, alignn_tpu_torch.native):
        monkeypatch.setattr(mod, "periodic_pairs_native",
                            lambda *a, **k: None)


@pytest.mark.parametrize("strategy,cutoff,canon", [
    ("k-nearest", 8.0, False), ("k-nearest", 8.0, True),
    ("radius_graph", 4.0, True)])
@pytest.mark.parametrize("which", [0, 1])
def test_build_graph_equals_jax(numpy_neighbors, strategy, cutoff, canon,
                                which):
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.graph.build import build_graph as jbuild
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.graph.build import build_graph

    _name, lat, frac = _structures()[which]
    kw = dict(neighbor_strategy=strategy, cutoff=cutoff, use_canonize=canon,
              tie_tol=1e-6)
    gj = jbuild(JAtoms(lattice_mat=lat, frac_coords=frac,
                       elements=["Si"] * len(frac)), **kw)
    gt = build_graph(Atoms(lattice_mat=lat, frac_coords=frac,
                           elements=["Si"] * len(frac)), **kw)
    for key in ("z", "src", "dst", "images", "lg_src", "lg_dst"):
        np.testing.assert_array_equal(getattr(gt, key), getattr(gj, key),
                                      err_msg=key)
    np.testing.assert_allclose(gt.r, gj.r, rtol=0, atol=1e-12)
    assert np.all(np.diff(gt.dst) >= 0) and np.all(np.diff(gt.lg_dst) >= 0)


def test_wrap_frac_is_strict():
    from alignn_tpu.graph.build import wrap_frac as jwrap
    from alignn_tpu_torch.graph.build import wrap_frac

    frac = np.array([[-2.7e-17, 1.0, 0.5], [-1.25, 2.0 - 1e-17, 0.999]])
    np.testing.assert_array_equal(wrap_frac(frac), jwrap(frac))
    assert wrap_frac(frac).max() < 1.0 and wrap_frac(frac).min() >= 0.0


def test_batch_matches_jax_batch(numpy_neighbors):
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.build import build_graph

    graphs = [build_graph(Atoms(lattice_mat=lat, frac_coords=frac,
                                elements=["Si"] * len(frac)),
                          use_canonize=False, tie_tol=1e-6)
              for _n, lat, frac in _structures()]
    spec = BucketSpec.tight_for_batch(graphs)
    tb = batch_graphs(graphs, spec, torch.device("cpu"))
    jb = jbatch([JGraph(**vars(g)) for g in graphs],
                JSpec(n_nodes=spec.n_nodes, n_edges=spec.n_edges,
                      n_lg_edges=spec.n_lg_edges, n_graphs=spec.n_graphs),
                gather_windows=False)
    for key in ("z", "atom_features", "frac_coords", "node_graph",
                "node_mask", "src", "dst", "r", "images", "edge_graph",
                "edge_mask", "lg_src", "lg_dst", "lg_mask", "lattice",
                "volume", "n_nodes", "graph_mask"):
        np.testing.assert_array_equal(getattr(tb, key).numpy(),
                                      np.asarray(getattr(jb, key)),
                                      err_msg=key)
    for inc, perm, inv in ((tb.g_index, jb.src_perm, jb.src_perm_inv),
                           (tb.lg_index, jb.lg_src_perm,
                            jb.lg_src_perm_inv)):
        np.testing.assert_array_equal(inc.src_perm.numpy(), perm)
        np.testing.assert_array_equal(inc.src_perm_inv.numpy(), inv)
        ids = inc.src_sorted.ids.numpy()
        assert np.all(np.diff(ids) >= 0)
        np.testing.assert_array_equal(
            inc.src_sorted.row_ptr.numpy(),
            np.searchsorted(ids, np.arange(inc.src_sorted.num + 1)))


def test_batch_rejects_unsorted_dst():
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.build import GraphData

    g = GraphData(z=np.array([14, 14], np.int32), frac_coords=np.zeros((2, 3)),
                  lattice=np.eye(3), volume=1.0,
                  src=np.array([0, 1], np.int32),
                  dst=np.array([1, 0], np.int32), r=np.ones((2, 3)),
                  images=np.zeros((2, 3)),
                  lg_src=np.zeros(0, np.int32), lg_dst=np.zeros(0, np.int32))
    with pytest.raises(ValueError, match="ascending"):
        batch_graphs([g], BucketSpec.tight_for_batch([g]),
                     torch.device("cpu"))


def test_cgcnn_table_equal_and_stamped():
    from alignn_tpu.chem.features import attribute_lookup_table as jtable
    from alignn_tpu_torch.chem.features import (attribute_lookup_table,
                                                feature_table_provenance)
    from alignn_tpu_torch.train.checkpoint import load_params_with_meta

    ours = attribute_lookup_table("cgcnn")
    assert ours.dtype == np.float32 and ours.shape == (104, 92)
    assert ours.tobytes() == np.asarray(jtable("cgcnn")).tobytes()
    _p, _b, meta = load_params_with_meta(
        os.path.join(SI_DIR, "best_model.mpk"))
    assert feature_table_provenance("cgcnn")["sha256"] == \
        meta["feature_table"]["sha256"]
    assert meta["feature_table"]["sha256"].startswith("ce26abb3dbe6f63a")


def test_msgpack_decoder_matches_flax():
    from flax import serialization

    from alignn_tpu_torch.train.checkpoint import msgpack_restore

    with open(os.path.join(SI_DIR, "best_model.mpk"), "rb") as f:
        data = f.read()
    ref = serialization.msgpack_restore(data)
    ours = msgpack_restore(data)

    def compare(a, b, path):
        if isinstance(b, dict):
            assert isinstance(a, dict) and a.keys() == b.keys(), path
            for k in b:
                compare(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert a.tobytes() == b.tobytes(), path
        else:
            assert a == b and type(a) is type(b), path

    compare(ours, ref, "")


def test_msgpack_decoder_scalar_and_ext_types():
    from flax import serialization

    from alignn_tpu_torch.train.checkpoint import msgpack_restore

    tree = {"a": np.arange(6, dtype=np.float16).reshape(2, 3),
            "b": {"c": np.float32(2.5), "d": [1, -3, 300, -70000, 2**40]},
            "e": None, "f": True, "g": "x" * 40, "h": 1.25,
            "i": np.zeros((0,), np.int64)}
    data = serialization.msgpack_serialize(tree)
    ref = serialization.msgpack_restore(data)
    ours = msgpack_restore(data)
    np.testing.assert_array_equal(ours["a"], ref["a"])
    assert ours["b"]["c"] == ref["b"]["c"] and \
        ours["b"]["c"].dtype == np.float32
    assert ours["b"]["d"] == ref["b"]["d"]
    for k in "efgh":
        assert ours[k] == ref[k]
    assert ours["i"].shape == (0,) and ours["i"].dtype == np.int64


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import alignn_tpu_torch\n"
        "import alignn_tpu_torch.ff.calculator\n"
        "for m in pkgutil.walk_packages(alignn_tpu_torch.__path__,"
        " 'alignn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'alignn_tpu')"
        " or m.startswith(('jax.', 'flax.', 'alignn_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "flax", "alignn_tpu"}, roots


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_calculator_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from alignn_tpu_torch.ff.calculator import Calculator

    with pytest.raises(RuntimeError, match="CUDA"):
        Calculator(path=SI_DIR)
