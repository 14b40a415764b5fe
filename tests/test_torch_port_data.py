"""alignn_tpu_torch's data layer against alignn_tpu's.

(a) ``get_id_train_val_test``; (b) records to graphs, ``GraphDataset``
scaling and ``mad``; (c) the ``BucketedLoader`` of both packages over the
same graphs (the port's graphs handed to JAX as the same numpy arrays):
bucket, per-epoch order under shuffle, host slices, batch arrays and the
floored gather windows, a batch with a 0 window included; (d) the dense
buckets from ``dense_spec_for_graphs`` and ``dense_spec_from_counts``.
"""

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")
BATCH_KEYS = ("z", "atom_features", "frac_coords", "node_graph", "node_mask",
              "src", "dst", "r", "images", "edge_graph", "edge_mask",
              "lg_src", "lg_dst", "lg_mask", "lattice", "volume", "n_nodes",
              "graph_mask", "target", "forces", "stress")


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("kw", [
    dict(total_size=100),
    dict(total_size=57, split_seed=7, train_ratio=0.6, val_ratio=0.2,
         test_ratio=0.2),
    dict(total_size=40, n_train=25, n_val=5, n_test=0),
    dict(total_size=40, n_train=20, n_val=0, n_test=8),
    dict(total_size=33, keep_data_order=True, val_ratio=0.15,
         test_ratio=0.15)])
def test_splits_match_jax(kw):
    from alignn_tpu.data.splits import get_id_train_val_test as jsplit
    from alignn_tpu_torch.data.splits import get_id_train_val_test

    got, ref = get_id_train_val_test(**kw), jsplit(**kw)
    assert got == ref
    assert all(type(i) is int for part in got for i in part)


def test_splits_reject_oversized_counts():
    from alignn_tpu_torch.data.splits import get_id_train_val_test

    with pytest.raises(ValueError, match="total number"):
        get_id_train_val_test(total_size=10, n_train=8, n_val=2, n_test=1)


def _records():
    """Seven rocksalt records in the reference schema (Atoms dicts, one in
    cartesian coordinates), with forces and Voigt stresses; one target is
    "na" and one NaN, which filter_records drops."""
    from alignn_tpu_torch.graph.build import ROCKSALT_ELEMENTS, ROCKSALT_FRAC

    rng = np.random.default_rng(4)
    recs = []
    for i in range(7):
        a = 4.2 + 0.3 * rng.standard_normal()
        frac = ROCKSALT_FRAC + 0.03 * rng.standard_normal((8, 3))
        lat = np.eye(3) * a
        cart = i == 1
        atoms = {"lattice_mat": lat.tolist(),
                 "coords": (frac @ lat if cart else frac).tolist(),
                 "elements": ROCKSALT_ELEMENTS, "cartesian": cart}
        target = "na" if i == 3 else float("nan") if i == 5 \
            else float(rng.standard_normal())
        recs.append({"jid": f"rs-{i}", "atoms": atoms, "target": target,
                     "atomwise_grad": rng.standard_normal((8, 3)).tolist(),
                     "stresses": rng.standard_normal(6).tolist()})
    return recs


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


def test_records_to_graphs_match_jax(numpy_neighbors):
    """filter_records (NaN and "na" dropped, the factor applied), the
    Voigt stress and records_to_graphs: every array of every graph equal
    to JAX's."""
    from alignn_tpu.data import dataset as jd
    from alignn_tpu_torch.data import dataset as td

    recs = _records()
    for r in recs:
        v = r["stresses"]
        r["stresses"] = td.voigt_6_to_full_3x3_stress(v)
        np.testing.assert_array_equal(r["stresses"],
                                      jd.voigt_6_to_full_3x3_stress(v))
    kept = td.filter_records(recs, target_multiplication_factor=2.0)
    assert [r["jid"] for r in kept] == \
        [r["jid"] for r in jd.filter_records(
            recs, target_multiplication_factor=2.0)]
    assert len(kept) == 5
    got = td.records_to_graphs(kept, cutoff=8.0, max_neighbors=12)
    ref = jd.records_to_graphs(kept, cutoff=8.0, max_neighbors=12)
    for g, j in zip(got, ref):
        for k, v in vars(g).items():
            if v is None:
                assert getattr(j, k) is None, k
            else:
                np.testing.assert_array_equal(v, getattr(j, k), err_msg=k)
    with pytest.raises(NotImplementedError, match="extra_features"):
        td.records_to_graphs([{**kept[0], "extra_features": [1.0]}])


def test_dataset_scaling_and_mad_match_jax():
    """standardize_from the training split, a second scale_targets, mad and
    targets: equal to JAX's GraphDataset (rtol 1e-12)."""
    from alignn_tpu.data.dataset import GraphDataset as JDataset
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu_torch.data.dataset import GraphDataset
    from alignn_tpu_torch.graph.build import rocksalt_graphs

    graphs = rocksalt_graphs(6, 2)
    graphs[4].target = None     # a force-only record
    ids = [f"g{i}" for i in range(6)]
    train = GraphDataset(graphs[:3], ids[:3])
    val = GraphDataset(graphs[3:], ids[3:])
    jtrain = JDataset([JGraph(**vars(g)) for g in graphs[:3]], ids[:3])
    jval = JDataset([JGraph(**vars(g)) for g in graphs[3:]], ids[3:])
    assert train.mad() == pytest.approx(jtrain.mad(), rel=1e-12)
    for ds, jds in ((val, jval), (train, jtrain)):
        ds.standardize_from(train if ds is val else None)
        jds.standardize_from(jtrain if jds is jval else None)
        ds.scale_targets(0.5, 2.0)
        jds.scale_targets(0.5, 2.0)
        assert ds.target_mean == pytest.approx(jds.target_mean, rel=1e-12)
        assert ds.target_std == pytest.approx(jds.target_std, rel=1e-12)
    np.testing.assert_allclose(train.targets(), jtrain.targets(), rtol=1e-12)
    assert train.mad() == pytest.approx(jtrain.mad(), rel=1e-12)
    assert val.graphs[1].target is None
    meta = GraphDataset(graphs[:3], ids[:3],
                        metadata={"targets": [[1.0], [2.0], [4.0]]})
    jmeta = JDataset([JGraph(**vars(g)) for g in graphs[:3]], ids[:3],
                     metadata={"targets": [[1.0], [2.0], [4.0]]})
    np.testing.assert_array_equal(meta.targets(), jmeta.targets())
    assert meta.mad() == jmeta.mad()


def _big_graph(rng, n_nodes=30, n_edges=2600, n_lg=600):
    """A synthetic labelled graph whose L-edge sources span more edges than
    any window, so that a batch holding it has win_lg_src 0."""
    from alignn_tpu_torch.graph.build import GraphData

    return GraphData(
        z=np.full(n_nodes, 11, np.int32),
        frac_coords=rng.random((n_nodes, 3)), lattice=np.eye(3) * 9.0,
        volume=729.0, src=rng.integers(0, n_nodes, n_edges).astype(np.int32),
        dst=np.sort(rng.integers(0, n_nodes, n_edges)).astype(np.int32),
        r=rng.standard_normal((n_edges, 3)) + 3.0,
        images=np.zeros((n_edges, 3)),
        lg_src=rng.integers(0, n_edges, n_lg).astype(np.int32),
        lg_dst=np.sort(rng.integers(0, 300, n_lg)).astype(np.int32),
        target=np.array([0.5]), forces=rng.standard_normal((n_nodes, 3)),
        stress=np.eye(3) * 0.02)


@pytest.fixture(scope="module")
def loader_graphs():
    from alignn_tpu_torch.graph.build import rocksalt_graphs

    graphs = rocksalt_graphs(9, 3)
    graphs.insert(4, _big_graph(np.random.default_rng(5)))
    return graphs


def _loaders(graphs, **kw):
    from alignn_tpu.data.dataset import GraphDataset as JDataset
    from alignn_tpu.data.loader import BucketedLoader as JLoader
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu_torch.data.dataset import GraphDataset
    from alignn_tpu_torch.data.loader import BucketedLoader

    ids = [f"g{i}" for i in range(len(graphs))]
    port = BucketedLoader(GraphDataset(list(graphs), ids), device=CPU, **kw)
    ref = JLoader(JDataset([JGraph(**vars(g)) for g in graphs], ids),
                  prefetch=0, **kw)
    return port, ref


@pytest.mark.parametrize("kw", [
    dict(batch_size=3, shuffle=True, seed=11),
    dict(batch_size=3, shuffle=True, drop_last=True, seed=2),
    dict(batch_size=4, shuffle=False),
    dict(batch_size=2, shuffle=True, seed=5, host_id=1, num_hosts=3)],
    ids=["shuffle", "drop_last", "in_order", "host_slice"])
def test_loader_matches_jax(loader_graphs, kw):
    """Two epochs: the same bucket, length, batch ids, batch arrays and
    floored windows as JAX's loader; the port's prefetch thread on.  Under
    shuffle some batch holds the large graph, gets win_lg_src 0, and the
    floor stays monotone around it."""
    from alignn_tpu_torch.graph.batch import WIN_FIELDS

    port, ref = _loaders(loader_graphs, **kw)
    assert vars(port.spec) == {k: getattr(ref.spec, k)
                               for k in vars(port.spec)}
    windows = []
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert len(port) == len(ref)
        assert port.batch_ids() == ref.batch_ids()
        got, exp = list(port), list(ref)
        assert len(got) == len(exp) == len(port)
        for b, j in zip(got, exp):
            for k in BATCH_KEYS:
                np.testing.assert_array_equal(_np(getattr(b, k)),
                                              np.asarray(getattr(j, k)),
                                              err_msg=k)
            w = [getattr(b, k) for k in WIN_FIELDS]
            assert w == [getattr(j, k) for k in WIN_FIELDS]
            windows.append(w)
    if kw.get("shuffle") and not kw.get("drop_last") and \
            kw.get("num_hosts", 1) == 1:
        lg_src = [w[3] for w in windows]
        assert 0 in lg_src and max(lg_src) > 0
        for i, name in enumerate(WIN_FIELDS):
            seen = [w[i] for w in windows if w[i]]
            assert seen == sorted(seen), (name, seen)


def test_loader_floor_rule():
    """_floor_windows on hand-made window sets: the max with the floor,
    0 passing through without lowering it."""
    import dataclasses

    from alignn_tpu.data.loader import BucketedLoader as JLoader
    from alignn_tpu_torch.data.dataset import GraphDataset
    from alignn_tpu_torch.data.loader import BucketedLoader
    from alignn_tpu_torch.graph.batch import WIN_FIELDS

    @dataclasses.dataclass
    class Wins:
        win_src: int = 0
        win_dst: int = 0
        win_src_sorted: int = 0
        win_lg_src: int = 0
        win_lg_dst: int = 0
        win_lg_src_sorted: int = 0

    port = BucketedLoader(GraphDataset([], []), 4, device=CPU)
    ref = JLoader.__new__(JLoader)
    ref._win_floor = {}
    seq = [(512, 256, 256, 768, 256, 256), (256, 256, 0, 512, 512, 256),
           (256, 512, 256, 0, 256, 1024), (256, 256, 256, 512, 256, 256)]
    outs = []
    for vals in seq:
        b = Wins(*vals)
        got, exp = port._floor_windows([b]), ref._floor_windows([b])
        assert got == exp
        outs.append([got[k] for k in WIN_FIELDS])
    assert outs[-1] == [512, 512, 256, 768, 512, 1024]
    assert outs[1][2] == 0 and outs[2][3] == 0


def test_loader_refuses_shards_and_needs_a_device():
    from alignn_tpu_torch.data.dataset import GraphDataset
    from alignn_tpu_torch.data.loader import BucketedLoader

    with pytest.raises(NotImplementedError, match="DDP"):
        BucketedLoader(GraphDataset([], []), 4, num_shards=2, device=CPU)
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        BucketedLoader(GraphDataset([], []), 4)


def test_spec_functions_match_jax(loader_graphs):
    from alignn_tpu.data.loader import spec_from_counts as jfrom_counts
    from alignn_tpu.data.loader import worst_case_spec as jworst
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu_torch.data.loader import spec_from_counts, worst_case_spec

    jgraphs = [JGraph(**vars(g)) for g in loader_graphs]
    counts = [[g.num_nodes for g in loader_graphs],
              [g.num_edges for g in loader_graphs],
              [g.num_lg_edges for g in loader_graphs]]
    for bs, slack in ((3, 1.0), (8, 1.2)):
        for got, ref in ((worst_case_spec(loader_graphs, bs, slack=slack),
                          jworst(jgraphs, bs, slack=slack)),
                         (spec_from_counts(*counts, bs, slack=slack),
                          jfrom_counts(*counts, bs, slack=slack))):
            assert vars(got) == {k: getattr(ref, k) for k in vars(got)}


def test_dense_buckets_match_jax():
    """dense_spec_for_graphs and dense_spec_from_counts equal JAX's; the
    dense loader sizes its bucket from 4-column count metadata when given,
    from the graphs otherwise, and its first batch equals JAX's."""
    from alignn_tpu.data.dataset import GraphDataset as JDataset
    from alignn_tpu.data.loader import BucketedLoader as JLoader
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu.graph.dense import dense_spec_for_graphs as jfor
    from alignn_tpu.graph.dense import dense_spec_from_counts as jcounts
    from alignn_tpu_torch.data.dataset import GraphDataset
    from alignn_tpu_torch.data.loader import BucketedLoader
    from alignn_tpu_torch.graph.batch import BucketSpec
    from alignn_tpu_torch.graph.build import rocksalt_graphs
    from alignn_tpu_torch.graph.dense import (dense_spec_for_graphs,
                                              dense_spec_from_counts,
                                              max_in_degree)

    graphs = rocksalt_graphs(5, 6)
    jgraphs = [JGraph(**vars(g)) for g in graphs]

    def same(a, b):
        assert vars(a) == {k: getattr(b, k) for k in vars(a)}

    for bs, slack, D in ((2, 1.0, None), (4, 1.3, None), (3, 1.0, 16)):
        same(dense_spec_for_graphs(graphs, bs, D=D, slack=slack),
             jfor(jgraphs, bs, D=D, slack=slack))
    nodes = [g.num_nodes for g in graphs]
    indeg = [max_in_degree([g]) for g in graphs]
    same(dense_spec_from_counts(nodes, indeg, 3, slack=1.1),
         jcounts(nodes, indeg, 3, slack=1.1))
    ids = [f"g{i}" for i in range(5)]
    meta = {"counts": [[g.num_nodes, g.num_edges, g.num_lg_edges, d + 1]
                       for g, d in zip(graphs, indeg)]}
    for md in ({}, meta):
        port = BucketedLoader(GraphDataset(list(graphs), ids,
                                           metadata=dict(md)), 2,
                              dense=True, device=CPU)
        ref = JLoader(JDataset(list(jgraphs), ids, metadata=dict(md)), 2,
                      dense=True, prefetch=0)
        same(port.spec, ref.spec)
        assert port.spec.dense_D == max(indeg) + (1 if md else 0)
        b, j = next(iter(port)), next(iter(ref))
        for k in BATCH_KEYS + ("rev",):
            np.testing.assert_array_equal(_np(getattr(b, k)),
                                          np.asarray(getattr(j, k)),
                                          err_msg=k)
        assert b.dense_D == j.dense_D and b.win_src == j.win_src == 0
    with pytest.raises(ValueError, match="dense BucketSpec"):
        BucketedLoader(GraphDataset(list(graphs), ids), 2, dense=True,
                       spec=BucketSpec(128, 1024, 8192, 3), device=CPU)
