"""alignn_tpu_torch's folder-training path against alignn_tpu's, on the CPU.

(a) ``TrainingConfig``: defaults, an environment override and every
committed ``docs/mlearn_r{4,5}/*/config.json`` give JAX's ``to_dict``;
(b) the four feature tables and their provenance hashes; (c)
``load_folder_records`` on csv, json and a multi-output csv; (d)
``get_train_val_loaders``: split file, ``mad`` and batch targets against
JAX, the graph cache and the process pool; (e) the trainer against JAX's
from one starting ``.mpk`` and its checkpoints read by alignn_tpu (the
E/F/S trainer of the force field against JAX's is in
``test_torch_port_trainer_ff.py``); (f) resume; (g)
classification; (h) ``cli.train`` and ``cli.predict``.  The
folders are written by the tests: rattled rocksalt cells drawn from
numpy seeds, as POSCARs with ``id_prop.csv`` or as ``id_prop.json``
with forces and stresses.
"""

import glob
import json
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED_CONFIGS = sorted(
    glob.glob(os.path.join(REPO, "docs", "mlearn_r4", "*", "config.json"))
    + glob.glob(os.path.join(REPO, "docs", "mlearn_r5", "*", "config.json")))
SMALL_MODEL = {"name": "alignn", "alignn_layers": 1, "gcn_layers": 1,
               "hidden_features": 32, "embedding_features": 16}
RUN = {"epochs": 2, "batch_size": 4, "n_train": 8, "n_val": 4, "n_test": 4,
       "learning_rate": 1e-3, "criterion": "l1", "num_workers": 0,
       "model": SMALL_MODEL}


def write_folder(root, n: int, seed: int = 0, kind: str = "csv") -> str:
    """n rattled 8-atom rocksalt cells (a = 4.2 + 0.3 N(0, 1) A, rattle
    0.02 N(0, 1) fractional, target N(0, 1)).  kind "csv": POSCARs and
    ``id_prop.csv``; "multi": the same with three targets a row; "json":
    ``id_prop.json`` with total_energy, forces and Voigt stresses."""
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.graph.build import ROCKSALT_ELEMENTS, ROCKSALT_FRAC

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows, entries = [], []
    for i in range(n):
        a = 4.2 + 0.3 * rng.standard_normal()
        atoms = Atoms(lattice_mat=np.eye(3) * a,
                      frac_coords=ROCKSALT_FRAC
                      + 0.02 * rng.standard_normal((8, 3)),
                      elements=ROCKSALT_ELEMENTS)
        t = rng.standard_normal(3 if kind == "multi" else 1)
        name = f"POSCAR-{i}.vasp"
        if kind == "json":
            entries.append({"jid": name, "atoms": atoms.to_dict(),
                            "total_energy": float(t[0]),
                            "forces": (0.1 * rng.standard_normal((8, 3)))
                            .tolist(),
                            "stresses": (0.01 * rng.standard_normal(6))
                            .tolist()})
            continue
        with open(os.path.join(root, name), "w") as f:
            f.write(atoms.to_poscar())
        rows.append(",".join([name] + [repr(float(x)) for x in t]))
    if kind == "json":
        with open(os.path.join(root, "id_prop.json"), "w") as f:
            json.dump(entries, f)
    else:
        with open(os.path.join(root, "id_prop.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return str(root)


def write_config(path, **overrides) -> str:
    cfg = {**RUN, **overrides}
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def _cfg_dicts(port, jax_cfg):
    a, b = port.to_dict(), jax_cfg.to_dict()
    for d in (a, b):
        d.pop("version")
        d.pop("output_dir")
    return a, b


# ---------------------------------------------------------------------------
# (a) TrainingConfig, (b) feature tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["defaults", "env_override"])
def test_training_config_matches_jax(case, monkeypatch):
    """Defaults, and an environment override that fills a default field
    but loses to an explicit one, as in JAX; unknown keys raise."""
    from alignn_tpu.config import TrainingConfig as JConfig
    from alignn_tpu_torch.config import TrainingConfig

    kw = {}
    if case == "env_override":
        monkeypatch.setenv("ALIGNN_TPU_EPOCHS", "7")
        monkeypatch.setenv("ALIGNN_TPU_BATCH_SIZE", "3")
        monkeypatch.setenv("ALIGNN_TPU_USE_CACHE", "False")
        kw = {"batch_size": 16, "model": dict(SMALL_MODEL)}
    port = TrainingConfig.from_dict(kw)
    a, b = _cfg_dicts(port, JConfig.from_dict(kw))
    assert a == b
    if case == "env_override":
        assert (port.epochs, port.batch_size, port.use_cache) == \
            (7, 16, False)
    with pytest.raises(ValueError, match="unknown TrainingConfig keys"):
        TrainingConfig.from_dict({"epochs": 1, "not_a_key": 2})


@pytest.mark.parametrize(
    "path", COMMITTED_CONFIGS,
    ids=[os.path.relpath(os.path.dirname(p), REPO) for p in
         COMMITTED_CONFIGS])
def test_committed_configs_match_jax(path):
    from alignn_tpu.config import TrainingConfig as JConfig
    from alignn_tpu_torch.config import TrainingConfig

    a, b = _cfg_dicts(TrainingConfig.from_json(path), JConfig.from_json(path))
    assert a == b


@pytest.mark.parametrize("name", ["basic", "atomic_number", "cfid", "cgcnn"])
def test_feature_tables_match_jax(name):
    """Byte for byte, with the same provenance stamp, and the same
    per-element vectors."""
    from alignn_tpu.chem import features as jf
    from alignn_tpu_torch.chem import features as tf

    a, b = tf.attribute_lookup_table(name), jf.attribute_lookup_table(name)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tf.feature_table_provenance(name) == \
        jf.feature_table_provenance(name)
    for symbol in ("H", "Si", "Cu", "U"):
        assert tf.get_node_attributes(symbol, name) == \
            jf.get_node_attributes(symbol, name)


# ---------------------------------------------------------------------------
# (c) folder records, (d) loaders
# ---------------------------------------------------------------------------


def _records_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            if k == "atoms":
                for f in ("lattice_mat", "coords", "elements"):
                    np.testing.assert_array_equal(np.asarray(g[k][f]),
                                                  np.asarray(r[k][f]))
            else:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(r[k]))


@pytest.mark.parametrize("kind", ["csv", "json", "multi"])
def test_load_folder_records_matches_jax(tmp_path, kind):
    from alignn_tpu.data.dataset import load_folder_records as jload
    from alignn_tpu_torch.data.dataset import load_folder_records

    root = write_folder(tmp_path / kind, 6, seed=2, kind=kind)
    kw = dict(train_grad=True, train_stress=True) if kind == "json" else {}
    got, ref = load_folder_records(root, **kw), jload(root, **kw)
    _records_equal(got, ref)
    if kind == "json":
        assert np.asarray(got[0]["stresses"]).shape == (3, 3)
    if kind == "multi":
        assert len(got[0]["target"]) == 3


def _loader_kw(out, **extra):
    return dict(batch_size=4, n_train=8, n_val=4, n_test=4,
                output_dir=str(out), **extra)


def test_loaders_match_jax(tmp_path):
    """ids_train_val_test.json, mad, and every batch's targets over two
    epochs of the shuffled train loader (and the val and test loaders),
    equal to JAX's."""
    from alignn_tpu.data.dataset import load_folder_records as jload
    from alignn_tpu.data.loader import get_train_val_loaders as jloaders
    from alignn_tpu_torch.data.loader import get_train_val_loaders

    root = write_folder(tmp_path / "d", 16, seed=3)
    records = jload(root)
    port = get_train_val_loaders(records, device="cpu",
                                 **_loader_kw(tmp_path / "p"))
    ref = jloaders(records, **_loader_kw(tmp_path / "j"))
    for name in ("ids_train_val_test.json", "mad"):
        with open(tmp_path / "p" / name) as a, open(tmp_path / "j" / name) \
                as b:
            assert a.read() == b.read()
    assert port[3] == ref[3]
    for epoch in (0, 1):
        for lp, lj in zip(port[:3], ref[:3]):
            lp.set_epoch(epoch)
            lj.set_epoch(epoch)
            assert len(lp) == len(lj) and lp.batch_ids() == lj.batch_ids()
            for bp, bj in zip(lp, lj):
                np.testing.assert_array_equal(bp.target.numpy(),
                                              np.asarray(bj.target))


def _graphs_equal(a, b):
    for field in ("z", "frac_coords", "lattice", "src", "dst", "r",
                  "images", "lg_src", "lg_dst", "target"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)
    assert a.volume == b.volume


def test_graph_cache_and_pool(tmp_path):
    """The first call writes the cache, the second reads it (its graphs
    equal graphs built without a cache); the spawn pool's graphs equal the
    serial build's, and its workers import no torch."""
    from alignn_tpu_torch.data.dataset import (load_folder_records,
                                               records_to_graphs)
    from alignn_tpu_torch.data.loader import get_train_val_loaders

    records = load_folder_records(write_folder(tmp_path / "d", 16, seed=4))
    kw = _loader_kw(tmp_path / "o", cache_dir=str(tmp_path / "cache"),
                    device="cpu")
    first = get_train_val_loaders(records, **kw)
    second = get_train_val_loaders(records, **kw)
    assert first[0].graph_stats["cached"] == \
        {"train": False, "val": False, "test": False}
    assert second[0].graph_stats["cached"] == \
        {"train": True, "val": True, "test": True}
    built = records_to_graphs(records[:8])
    cached = second[0].dataset.graphs
    assert len(cached) == 8
    for i in range(8):
        _graphs_equal(cached[i], built[i])
    pooled = records_to_graphs(records, num_workers=2)
    for a, b in zip(pooled, records_to_graphs(records)):
        _graphs_equal(a, b)
    # the pool's workers import the graph builder without torch, so that
    # they start in a fraction of a second
    import subprocess
    import sys

    code = ("import sys, alignn_tpu_torch.data.dataset; "
            "sys.exit('torch' in sys.modules)")
    assert subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          timeout=120).returncode == 0
    # a changed label misses the cache
    changed = [dict(r) for r in records]
    changed[0]["target"] = 9.0
    third = get_train_val_loaders(changed, **kw)
    assert third[0].graph_stats["cached"]["train"] is False


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_files_cross_packages(tmp_path, writer):
    """A cache that the port writes, or that alignn_tpu writes through its
    C++ record store (its Python store without g++), reads back in the
    port and in alignn_tpu, graph for graph, a record's extra features
    included."""
    from alignn_tpu.data.cache import GraphCache as JCache
    from alignn_tpu.data.cache import GraphCacheWriter as JWriter
    from alignn_tpu_torch.data import cache
    from alignn_tpu_torch.data.dataset import (load_folder_records,
                                               records_to_graphs)

    from alignn_tpu.data.dataset import records_to_graphs as jgraphs

    build = records_to_graphs if writer == "port" else jgraphs
    records = load_folder_records(write_folder(tmp_path / "d", 5, seed=10))
    records[2]["extra_features"] = [0.5, -1.0, 2.0]
    graphs = build(records)
    graphs[1].forces = np.ones((8, 3))
    path = str(tmp_path / "cache" / "graphs_train")
    with (cache.GraphCacheWriter if writer == "port" else JWriter)(path) \
            as w:
        for g in graphs:
            w.put(g)
    for reader in (cache.GraphCache(path), JCache(path)):
        assert len(reader) == len(graphs)
        for i, g in enumerate(graphs):
            _graphs_equal(reader[i], g)
        np.testing.assert_array_equal(reader[1].forces, graphs[1].forces)
        np.testing.assert_array_equal(reader[2].extra_features,
                                      [0.5, -1.0, 2.0])
        assert reader[1].extra_features is None


# ---------------------------------------------------------------------------
# (e) the trainer against JAX's, (f) resume, (g) classification
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages train the 1+1/32 property model on 16 cells for 2
    epochs from one ``.mpk`` that JAX's save_params wrote from a JAX
    init."""
    import jax

    from alignn_tpu.cli.train import train_for_folder as jtrain
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import build_graph as jbuild
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.nn.models import ALIGNN as JModel
    from alignn_tpu.nn.models import ALIGNNConfig as JConfig
    from alignn_tpu.train.checkpoint import checkpoint_meta, save_params
    from alignn_tpu_torch.cli.train import train_for_folder

    base = tmp_path_factory.mktemp("trainer")
    root = write_folder(base / "data", 16, seed=5)
    config = write_config(base / "config.json")
    g = jbuild(JAtoms.from_poscar(os.path.join(root, "POSCAR-0.vasp")))
    jm = JModel(cfg=JConfig(**{k: v for k, v in SMALL_MODEL.items()
                               if k != "name"}))
    v = jax.jit(lambda k, b: jm.init(k, b, train=False))(
        jax.random.PRNGKey(7), jbatch([g], JSpec.tight_for_batch([g])))
    init = str(base / "init.mpk")
    save_params(init, v["params"], v["batch_stats"], meta=checkpoint_meta())
    out = {"jax": str(base / "jax"), "port": str(base / "port")}
    jtrain(root_dir=root, config_name=config, output_dir=out["jax"],
           restart_model_path=init)
    summary = train_for_folder(root_dir=root, config_name=config,
                               output_dir=out["port"],
                               restart_model_path=init, device="cpu")
    return root, out, summary


def _load(out, name):
    with open(os.path.join(out, name)) as f:
        return json.load(f)


def test_trainer_matches_jax(trained):
    """History: epoch 1 within 1e-4 relative, epoch 2 within 1e-3; the
    test predictions within 1e-4; the same artifact set."""
    _root, out, _summary = trained
    for name in ("history_train.json", "history_val.json"):
        got, ref = _load(out["port"], name), _load(out["jax"], name)
        assert len(got) == len(ref) == 2
        for row_g, row_r, rtol in zip(got, ref, (1e-4, 1e-3)):
            np.testing.assert_allclose(row_g, row_r, rtol=rtol, atol=1e-7)
    got, ref = _load(out["port"], "Test_results.json"), \
        _load(out["jax"], "Test_results.json")
    assert [r["id"] for r in got] == [r["id"] for r in ref]
    np.testing.assert_allclose([r["predictions"] for r in got],
                               [r["predictions"] for r in ref], atol=1e-4)
    np.testing.assert_array_equal([r["target"] for r in got],
                                  [r["target"] for r in ref])
    expected = {"config.json", "history_train.json", "history_val.json",
                "ids_train_val_test.json", "mad", "Test_results.json",
                "Train_results.json", "Val_results.json",
                "best_model.mpk", "current_model.mpk", "last_model.mpk",
                "restart.mpk", "prediction_results_test_set.csv",
                "prediction_results_train_set.csv", "graph_cache"}
    assert expected <= set(os.listdir(out["port"]))
    assert expected - {"graph_cache"} <= set(os.listdir(out["jax"]))


def test_port_checkpoint_loads_in_jax(trained):
    """The port's model directory (best_model.mpk, its batch_stats and
    meta) loads in alignn_tpu.zoo.load_model_dir; JAX's predictions from
    it equal the port's within 1e-5."""
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.zoo import load_model_dir as jload
    from alignn_tpu.zoo import predict_structures as jpredict
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.zoo import load_model_dir, predict_structures

    root, out, _summary = trained
    files = [os.path.join(root, f"POSCAR-{i}.vasp") for i in (12, 13, 14)]
    jm, jv, _ = jload(out["port"])
    assert "batch_stats" in jv
    ref = jpredict(jm, jv, [JAtoms.from_poscar(f) for f in files])
    model, _cfg = load_model_dir(out["port"], device="cpu")
    got = predict_structures(model, [Atoms.from_poscar(f) for f in files])
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)


class _StopAtEpoch:
    """A train loader that raises when an epoch starts: a run killed
    between epochs."""

    def __init__(self, loader, epoch: int):
        self._loader, self._stop, self._epoch = loader, epoch, 0

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def __len__(self):
        return len(self._loader)

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        self._loader.set_epoch(epoch)

    def __iter__(self):
        if self._epoch == self._stop:
            raise RuntimeError("stopped")
        return iter(self._loader)


def test_resume_matches_uninterrupted(tmp_path):
    """A 2-epoch run stopped after epoch 1 and resumed from restart.mpk
    (``resume="auto"``'s file) equals the uninterrupted run: histories,
    final weights and BatchNorm statistics, test predictions within
    1e-6."""
    from alignn_tpu_torch.config import TrainingConfig
    from alignn_tpu_torch.data.dataset import load_folder_records
    from alignn_tpu_torch.data.loader import get_train_val_loaders
    from alignn_tpu_torch.nn.convert import flax_from_module
    from alignn_tpu_torch.train.trainer import train_model

    records = load_folder_records(write_folder(tmp_path / "d", 16, seed=6))
    tr, va, te, _ = get_train_val_loaders(
        records, device="cpu", **_loader_kw(tmp_path / "ids"))
    runs = {}
    for name in ("straight", "resumed"):
        cfg = TrainingConfig.from_dict({**RUN,
                                        "output_dir": str(tmp_path / name)})
        if name == "resumed":
            with pytest.raises(RuntimeError, match="stopped"):
                train_model(cfg, _StopAtEpoch(tr, 1), va, te)
            restart = os.path.join(cfg.output_dir, "restart.mpk")
            summary = train_model(cfg, tr, va, te, restart_state_path=restart)
            assert summary["epochs_run"] == 1
        else:
            summary = train_model(cfg, tr, va, te)
        runs[name] = (cfg.output_dir, flax_from_module(
            summary["state"].model))
    (out_a, (pa, sa)), (out_b, (pb, sb)) = runs["straight"], runs["resumed"]
    for name in ("history_train.json", "history_val.json"):
        np.testing.assert_allclose(_load(out_b, name), _load(out_a, name),
                                   rtol=1e-6, atol=1e-7)
    import jax

    for a, b in zip(jax.tree_util.tree_leaves((pb, sb)),
                    jax.tree_util.tree_leaves((pa, sa))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        [r["predictions"] for r in _load(out_b, "Test_results.json")],
        [r["predictions"] for r in _load(out_a, "Test_results.json")],
        atol=1e-6)


def test_classification_writes_rocauc(tmp_path):
    """A classifier (labels thresholded at 0) trains, writes test_rocauc,
    and the rank-formula AUC equals scikit-learn's on the same
    predictions."""
    from sklearn.metrics import roc_auc_score

    from alignn_tpu_torch.cli.train import train_for_folder
    from alignn_tpu_torch.train.trainer import roc_auc

    root = write_folder(tmp_path / "d", 16, seed=8)
    config = write_config(tmp_path / "c.json", epochs=1,
                          classification_threshold=0.0,
                          model={**SMALL_MODEL, "classification": True})
    summary = train_for_folder(root_dir=root, config_name=config,
                               output_dir=str(tmp_path / "o"), device="cpu")
    rows = _load(str(tmp_path / "o"), "Test_results.json")
    labels = [r["target"][0] for r in rows]
    prob = [np.exp(r["predictions"][1]) for r in rows]
    assert 0 < sum(labels) < len(labels)
    assert summary["test_rocauc"] == pytest.approx(
        roc_auc_score(labels, prob), abs=1e-12)
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 40)
    s = np.round(rng.random(40), 1)     # ties
    assert roc_auc(y, s) == pytest.approx(roc_auc_score(y, s), abs=1e-12)


# ---------------------------------------------------------------------------
# (h) the CLIs
# ---------------------------------------------------------------------------


def test_cli_train_and_predict(tmp_path, capsys):
    """``cli.train.main`` and ``cli.predict.main`` with ``--device cpu``:
    the artifact set, then predict on a file and on a folder prints the
    trainer's test predictions (one epoch: the best model is the last)."""
    from alignn_tpu_torch.cli import predict, train

    root = write_folder(tmp_path / "d", 16, seed=9)
    config = write_config(tmp_path / "c.json", epochs=1, num_workers=2)
    out = str(tmp_path / "out")
    train.main(["--root_dir", root, "--config_name", config,
                "--output_dir", out, "--device", "cpu"])
    for name in ("best_model.mpk", "current_model.mpk", "last_model.mpk",
                 "restart.mpk", "Test_results.json",
                 "prediction_results_test_set.csv"):
        assert os.path.exists(os.path.join(out, name)), name
    test_rows = {r["id"]: r["predictions"]
                 for r in _load(out, "Test_results.json")}
    rows = predict.main(["--model_path", out, "--file_path",
                         os.path.join(root, "POSCAR-12.vasp"),
                         "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rows[0]
    np.testing.assert_allclose(rows[0]["prediction"],
                               test_rows["POSCAR-12.vasp"], atol=1e-5)
    folder = tmp_path / "test_set"
    folder.mkdir()
    for sid in test_rows:
        (folder / sid).write_text(open(os.path.join(root, sid)).read())
    rows = predict.main(["--model_path", out, "--file_path", str(folder),
                         "--device", "cpu"])
    np.testing.assert_allclose(
        [r["prediction"] for r in rows],
        [test_rows[os.path.basename(r["file"])] for r in rows], atol=1e-5)
    # edge partitioning over a graph axis takes the atomwise model
    # (tests/test_torch_port_gp.py); the property model is refused before
    # any rank spawns
    graph_axis = write_config(tmp_path / "g.json", epochs=1,
                              mesh_shape={"data": 1, "graph": 2})
    with pytest.raises(ValueError, match="requires an atomwise model"):
        train.main(["--root_dir", root, "--config_name", graph_axis,
                    "--output_dir", str(tmp_path / "g"),
                    "--devices", "2", "--device", "cpu"])
    assert not os.path.exists(tmp_path / "g")
