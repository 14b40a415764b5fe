"""alignn_tpu_torch/scripts/ (the campaign scripts) against
alignn_tpu/scripts/, on the CPU.

- Every JAX script has its port, with ``main`` (or ``generate``); no port
  script imports jax, flax or alignn_tpu, at the top or inside a function
  (an AST scan: the package walk of ``test_torch_port_graph.py`` does not
  see imports made inside ``main``).
- The host scripts give JAX's outputs: ``should_stop`` and the split ids
  exactly, ``train_all``'s files up to the package name, the plots and the
  graph drawing.
- The FF scripts run both packages' Calculators on the model directory of
  a JAX-initialised 1+1/16 force field (``config.json`` +
  ``best_model.mpk``): E-V curves and vacancy energies within 1e-4
  eV/atom, relaxed positions within 1e-4 A, phonon frequencies within
  1e-3 THz; ``alignn_evac``, ``predict_db`` (records, and a dataset from
  the cache) and ``predict_db_all`` within 1e-5 of JAX's predictions.
- The training scripts with both packages' trainers replaced by one stub
  that writes a fixed ``Test_results.json``: ``train_mlearn``'s routed
  ``config_<el>.json``, ``prepare_all``'s folder and harvested MAEs,
  ``final_model``'s and ``compare_cfid``'s configs and outputs equal
  JAX's exactly; then one real one-epoch ``train_mlearn`` of the port.
"""

import ast
import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from torch_port_threads import _two_threads  # noqa: E402,F401

PORT_DIR = os.path.join(REPO, "alignn_tpu_torch", "scripts")
JAX_DIR = os.path.join(REPO, "alignn_tpu", "scripts")
SCRIPTS = sorted(f[:-3] for f in os.listdir(JAX_DIR)
                 if f.endswith(".py") and f != "__init__.py")
SMALL_FF = dict(name="alignn_atomwise", alignn_layers=1, gcn_layers=1,
                hidden_features=16, embedding_features=8,
                gradwise_weight=1.0, stresswise_weight=0.1)
FF_CONFIG = {"neighbor_strategy": "k-nearest", "cutoff": 5.0,
             "max_neighbors": 12}
FCC = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
ROCKSALT = np.concatenate([FCC, FCC + [0.5, 0, 0]])
E_TOL = 1e-4      # eV/atom
X_TOL = 1e-4      # A
P_TOL = 1e-5      # predictions


def _mods(name):
    import importlib

    return (importlib.import_module(f"alignn_tpu_torch.scripts.{name}"),
            importlib.import_module(f"alignn_tpu.scripts.{name}"))


def _quiet(fn, *args):
    """fn(*args) with its standard output captured: (result, output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


# ---------------------------------------------------------------------------
# every script, and no JAX inside any
# ---------------------------------------------------------------------------


def test_every_jax_script_is_ported():
    port = sorted(f[:-3] for f in os.listdir(PORT_DIR)
                  if f.endswith(".py") and f != "__init__.py")
    assert port == SCRIPTS and len(SCRIPTS) == 16


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_imports_no_jax(name):
    port, _jax = _mods(name)
    assert callable(getattr(port, "main", None)) or \
        callable(getattr(port, "generate", None))
    with open(os.path.join(PORT_DIR, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    banned = ("jax", "flax", "alignn_tpu")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in banned, (name, n, node.lineno)


# ---------------------------------------------------------------------------
# host scripts
# ---------------------------------------------------------------------------


def test_should_stop_matches_jax(tmp_path):
    port, jax_mod = _mods("early_stopping_checker")
    rng = np.random.default_rng(0)
    for n in (0, 3, 10, 60, 120):
        hist = rng.random(n).tolist()
        rows = [[v, v] for v in hist]
        for patience in (1, 5, 50):
            for h in (hist, rows):
                assert port.should_stop(h, patience) == \
                    jax_mod.should_stop(h, patience)
    hist = [[1.0 - 0.001 * i, 0.0] for i in range(30)] + \
        [[2.0, 0.0]] * 60
    with open(tmp_path / "history_val.json", "w") as f:
        json.dump(hist, f)
    args = ["--output_dir", str(tmp_path), "--patience", "50"]
    assert _quiet(port.main, args)[1] == _quiet(jax_mod.main, args)[1]
    assert json.loads(_quiet(port.main, args)[1])["stop"] is True
    empty = ["--output_dir", str(tmp_path / "none")]
    assert _quiet(port.main, empty)[1] == _quiet(jax_mod.main, empty)[1]


def test_cross_pred_split_matches_jax(tmp_path):
    port, jax_mod = _mods("make_test_split_cross_pred")
    recs = tmp_path / "records.json"
    with open(recs, "w") as f:
        json.dump([{"jid": f"JVASP-{i}", "x": i} for i in range(37)], f)
    out = {}
    for tag, mod in (("port", port), ("jax", jax_mod)):
        path = str(tmp_path / f"{tag}.json")
        _quiet(mod.main, ["--records_json", str(recs), "--output", path,
                          "--split_seed", "7"])
        with open(path) as f:
            out[tag] = json.load(f)
    assert out["port"] == out["jax"]
    assert len(out["port"]["id_test"]) > 0


def test_train_all_files_match_jax(tmp_path):
    port, jax_mod = _mods("train_all")
    listing = {}
    for tag, mod in (("port", port), ("jax", jax_mod)):
        root = tmp_path / tag
        _quiet(mod.main, ["--dataset", "megnet", "--output_root", str(root),
                          "--epochs", "7"])
        files = {}
        for dirpath, _d, names in os.walk(root):
            for n in names:
                path = os.path.join(dirpath, n)
                with open(path) as f:
                    text = f.read().replace(str(root), "ROOT")
                files[os.path.relpath(path, root)] = (
                    text, os.access(path, os.X_OK))
        listing[tag] = files
    assert sorted(listing["port"]) == sorted(listing["jax"])
    assert len(listing["port"]) == 4
    for name, (text, exe) in listing["jax"].items():
        ported = text.replace("alignn_tpu.", "alignn_tpu_torch.")
        assert listing["port"][name] == (ported, exe), name
    assert "alignn_tpu_torch.data.figshare" in \
        listing["port"]["megnet_e_form/run.sh"][0]


def test_plot_ff_results_and_graph_viz_match_jax(tmp_path):
    from alignn_tpu_torch.chem.atoms import Atoms

    port, jax_mod = _mods("plot_ff_results")
    rng = np.random.default_rng(0)
    for tag in ("port", "jax"):
        d = tmp_path / tag
        d.mkdir()
        with open(d / "history_val.json", "w") as f:
            json.dump([[1.0 / (i + 1), 0.5 / (i + 1)] for i in range(5)], f)
        rows = [{"id": str(i), "target_out": float(rng.random()),
                 "pred_out": float(rng.random()),
                 "target_grad": rng.random((4, 3)).tolist(),
                 "pred_grad": rng.random((4, 3)).tolist()}
                for i in range(6)]
        with open(d / "Val_results.json", "w") as f:
            json.dump(rows, f)
    _quiet(port.main, [str(tmp_path / "port")])
    _quiet(jax_mod.main, [str(tmp_path / "jax")])
    for name in ("history.png", "parity.png"):
        assert (tmp_path / "port" / name).exists() == \
            (tmp_path / "jax" / name).exists()
    assert (tmp_path / "port" / "history.png").exists()

    port, jax_mod = _mods("graph_viz")
    poscar = tmp_path / "POSCAR"
    poscar.write_text(Atoms(lattice_mat=np.eye(3) * 5.6, frac_coords=ROCKSALT,
                            elements=["Na"] * 4 + ["Cl"] * 4).to_poscar())
    for tag, mod in (("port", port), ("jax", jax_mod)):
        out = _quiet(mod.main, ["--file_path", str(poscar), "--cutoff",
                                "4.5", "--output",
                                str(tmp_path / f"{tag}.png")])[1]
        assert out.startswith("wrote")
        assert (tmp_path / f"{tag}.png").stat().st_size > 0


# ---------------------------------------------------------------------------
# FF scripts, through both packages' Calculators
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A JAX-initialised 1+1/16 force field (seed 0) saved as a model
    directory: config.json + best_model.mpk."""
    import jax

    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu.graph.build import build_graph
    from alignn_tpu.nn.models import ALIGNNAtomWise, ALIGNNAtomWiseConfig
    from alignn_tpu.train.checkpoint import checkpoint_meta, save_params

    model = ALIGNNAtomWise(cfg=ALIGNNAtomWiseConfig(**SMALL_FF))
    probe = JAtoms(lattice_mat=np.eye(3) * 4.0,
                   frac_coords=[[0, 0, 0], [0.5, 0.5, 0.5]],
                   elements=["Na", "Cl"])
    g = build_graph(probe, cutoff=5.0, max_neighbors=12)
    batch = batch_graphs([g], BucketSpec.tight_for_batch([g]))
    variables = model.init(jax.random.PRNGKey(0), batch, batch.r,
                           train=False)
    d = tmp_path_factory.mktemp("small_ff")
    with open(d / "config.json", "w") as f:
        json.dump({**FF_CONFIG, "model": SMALL_FF}, f)
    save_params(str(d / "best_model.mpk"), variables["params"],
                meta=checkpoint_meta())
    return str(d)


@pytest.fixture(scope="module")
def poscars(tmp_path_factory):
    """{name: POSCAR path}: CsCl-type NaCl (2 atoms) and rattled rocksalt
    NaCl (8 atoms)."""
    from alignn_tpu_torch.chem.atoms import Atoms

    d = tmp_path_factory.mktemp("poscars")
    rng = np.random.default_rng(3)
    cells = {
        "nacl2": Atoms(lattice_mat=np.eye(3) * 3.4,
                       frac_coords=[[0, 0, 0], [0.5, 0.5, 0.5]],
                       elements=["Na", "Cl"]),
        "nacl8": Atoms(lattice_mat=np.eye(3) * 5.6,
                       frac_coords=ROCKSALT
                       + 0.01 * rng.standard_normal((8, 3)),
                       elements=["Na"] * 4 + ["Cl"] * 4)}
    out = {}
    for name, atoms in cells.items():
        out[name] = str(d / f"POSCAR-{name}")
        with open(out[name], "w") as f:
            f.write(atoms.to_poscar())
    return out


def _run_both(name, args, tmp_path, out_flag="--output", suffix=".json"):
    """Both packages' script `name` on `args` (+ the port on the CPU);
    returns (port's json, JAX's json) from their output files."""
    port, jax_mod = _mods(name)
    got = {}
    for tag, mod, extra in (("port", port, ["--device", "cpu"]),
                            ("jax", jax_mod, [])):
        path = str(tmp_path / f"{tag}{suffix}")
        _quiet(mod.main, args + [out_flag, path] + extra)
        with open(path) as f:
            got[tag] = json.load(f)
    return got["port"], got["jax"]


def test_ev_curve_matches_jax(model_dir, poscars, tmp_path):
    f = poscars["nacl2"]
    port, jax_out = _run_both(
        "ev_curve", ["--model_path", model_dir, f,
                     "--dx=-0.03,-0.01,0.0,0.01,0.03"], tmp_path)
    n = 2
    np.testing.assert_allclose(np.asarray(port[f]["energies"]) / n,
                               np.asarray(jax_out[f]["energies"]) / n,
                               rtol=0, atol=E_TOL)
    np.testing.assert_allclose(port[f]["volumes"], jax_out[f]["volumes"],
                               rtol=1e-6)
    assert sorted(port[f]) == sorted(jax_out[f])


def test_ev_curve_comp_matches_jax(model_dir, poscars, tmp_path):
    port, jax_mod = _mods("ev_curve_comp")
    f = poscars["nacl2"]
    lines = {}
    for tag, mod, extra in (("port", port, ["--device", "cpu"]),
                            ("jax", jax_mod, [])):
        out = _quiet(mod.main, ["--model_path", model_dir, f, "--no_relax",
                                "--output", str(tmp_path / f"{tag}.png")]
                     + extra)[1]
        lines[tag] = json.loads(out.strip().splitlines()[-1])
        assert (tmp_path / f"{tag}.png").stat().st_size > 0
    (formula, kv), = lines["port"]["kv_ff"].items()
    assert list(lines["jax"]["kv_ff"]) == [formula]
    np.testing.assert_allclose(kv, lines["jax"]["kv_ff"][formula],
                               rtol=1e-3)


def test_cubic_mat_relax_matches_jax(model_dir, poscars, tmp_path):
    from alignn_tpu_torch.chem.atoms import Atoms

    f = poscars["nacl8"]
    port, jax_out = _run_both(
        "cubic_mat_relax", ["--model_path", model_dir, f, "--steps", "60"],
        tmp_path)
    a, b = Atoms.from_dict(port[f]["atoms"]), Atoms.from_dict(
        jax_out[f]["atoms"])
    np.testing.assert_allclose(a.cart_coords, b.cart_coords, rtol=0,
                               atol=X_TOL)
    np.testing.assert_allclose(a.lattice_mat, b.lattice_mat, rtol=0,
                               atol=X_TOL)
    assert abs(port[f]["energy"] - jax_out[f]["energy"]) / 8 < E_TOL
    assert port[f]["steps"] == jax_out[f]["steps"]


def test_defect_matches_jax(model_dir, poscars, tmp_path):
    f = poscars["nacl2"]
    port, jax_out = _run_both(
        "defect", ["--model_path", model_dir, f], tmp_path)
    assert [r["element"] for r in port[f]] == \
        [r["element"] for r in jax_out[f]] == ["Na", "Cl"]
    for p, j in zip(port[f], jax_out[f]):
        assert abs(p["E_bulk"] - j["E_bulk"]) / 16 < E_TOL
        assert abs(p["E_vacancy"] - j["E_vacancy"]) / 15 < E_TOL
        assert abs(p["E_formation"] - j["E_formation"]) < 16 * E_TOL


def test_plot_phonons_ff_matches_jax(model_dir, poscars, tmp_path,
                                     monkeypatch):
    """Both scripts' plots, and the band structures they plot (taken from
    each package's ``phonon_band_structure`` as the script calls it)."""
    from alignn_tpu.ff import phonons as jph

    port, jax_mod = _mods("plot_phonons_ff")
    seen = {}
    orig = jph.phonon_band_structure

    def keep(*a, **k):
        seen["jax"] = orig(*a, **k)
        return seen["jax"]

    monkeypatch.setattr(jph, "phonon_band_structure", keep)
    args = ["--model_path", model_dir, "--file_path", poscars["nacl2"]]
    got = _quiet(port.main, args + ["--output_prefix",
                                    str(tmp_path / "port"), "--device",
                                    "cpu"])[0]
    _quiet(jax_mod.main, args + ["--output_prefix", str(tmp_path / "jax")])
    for tag in ("port", "jax"):
        assert (tmp_path / f"{tag}_bands_dos.png").stat().st_size > 0
    np.testing.assert_allclose(got["frequencies_THz"],
                               np.asarray(seen["jax"]["frequencies_THz"]),
                               rtol=0, atol=1e-3)


def test_alignn_evac_matches_jax(model_dir, poscars, tmp_path):
    f = poscars["nacl2"]
    port, jax_out = _run_both(
        "alignn_evac", [f, "--model", model_dir, "--supercell", "2,2,1"],
        tmp_path)
    assert [(r["symb"], r["n_def"]) for r in port] == \
        [(r["symb"], r["n_def"]) for r in jax_out]
    for p, j in zip(port, jax_out):
        assert abs(p["Ef2"] - j["Ef2"]) < P_TOL * (p["n_def"] + 2)
        assert abs(p["mu"] - j["mu"]) < P_TOL


def test_zoo_names_are_not_downloaded(poscars, tmp_path):
    port, _jax = _mods("alignn_evac")
    with pytest.raises(NotImplementedError, match="not ported"):
        _quiet(port.main, [poscars["nacl2"], "--model", "jv_no_such_model",
                           "--output", str(tmp_path / "x.json"),
                           "--device", "cpu"])


# ---------------------------------------------------------------------------
# prediction scripts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def records():
    from alignn_tpu_torch.chem.atoms import Atoms

    rng = np.random.default_rng(5)
    out = []
    for i in range(6):
        a = 5.4 + 0.2 * rng.random()
        atoms = Atoms(lattice_mat=np.eye(3) * a,
                      frac_coords=ROCKSALT
                      + 0.01 * rng.standard_normal((8, 3)),
                      elements=["Na"] * 4 + ["Cl"] * 4)
        out.append({"jid": f"JVASP-{i}", "atoms": atoms.to_dict(),
                    "formation_energy_peratom": float(rng.random()),
                    "optb88vdw_bandgap": float(rng.random()),
                    "exfoliation_energy": "na"})
    return out


def test_predict_db_matches_jax(model_dir, records, tmp_path, monkeypatch):
    recs = tmp_path / "records.json"
    with open(recs, "w") as f:
        json.dump(records, f)
    port, jax_out = _run_both(
        "predict_db", ["--model_dir", model_dir, "--records_json",
                       str(recs), "--limit", "5"], tmp_path)
    assert sorted(port) == sorted(jax_out) and len(port) == 5
    for k in port:
        np.testing.assert_allclose(port[k], jax_out[k], rtol=0, atol=P_TOL)
    # a dataset name reads the cache; a missing one raises
    cache = tmp_path / "cache"
    cache.mkdir()
    with open(cache / "dft_2d.json", "w") as f:
        json.dump(records, f)
    monkeypatch.setenv("ALIGNN_TPU_DATA_CACHE", str(cache))
    port_ds, jax_ds = _run_both(
        "predict_db", ["--model_dir", model_dir, "--dataset", "dft_2d"],
        tmp_path, suffix="_ds.json")
    for k in port_ds:
        np.testing.assert_allclose(port_ds[k], jax_ds[k], rtol=0,
                                   atol=P_TOL)
    port_mod, _j = _mods("predict_db")
    with pytest.raises(NotImplementedError, match="not ported"):
        _quiet(port_mod.main, ["--model_dir", model_dir, "--dataset",
                               "megnet", "--device", "cpu", "--output",
                               str(tmp_path / "x.json")])


def test_predict_db_all_matches_jax(model_dir, records, tmp_path,
                                    monkeypatch):
    cache = tmp_path / "cache"
    cache.mkdir()
    with open(cache / "dft_2d.json", "w") as f:
        json.dump(records, f)
    monkeypatch.setenv("ALIGNN_TPU_DATA_CACHE", str(cache))
    port, jax_mod = _mods("predict_db_all")
    csv = {}
    for tag, mod, extra in (("port", port, ["--device", "cpu"]),
                            ("jax", jax_mod, [])):
        d = tmp_path / tag
        d.mkdir()
        _quiet(mod.main, ["--datasets", "dft_2d", "--gap_model", model_dir,
                          "--form_model", model_dir, "--output_dir", str(d)]
               + extra)
        csv[tag] = {n: np.genfromtxt(d / n, delimiter=",", skip_header=1,
                                     dtype=None, encoding=None)
                    for n in sorted(os.listdir(d))}
    assert sorted(csv["port"]) == sorted(csv["jax"]) == [
        "dft_2d_formation_energy_peratompredictions.csv",
        "dft_2d_optb88vdw_bandgappredictions.csv"]
    for n in csv["port"]:
        p, j = csv["port"][n], csv["jax"][n]
        assert [r[0] for r in p] == [r[0] for r in j]
        for col in (1, 2, 3):
            np.testing.assert_allclose([r[col] for r in p],
                                       [r[col] for r in j], rtol=0,
                                       atol=P_TOL)


# ---------------------------------------------------------------------------
# training scripts, with one stub in place of both packages' trainers
# ---------------------------------------------------------------------------

FIXED_RESULTS = [
    {"id": "a", "target": [1.0], "predictions": [1.25],
     "target_grad": [[0.0, 0.5, 0.0]] * 3,
     "pred_grad": [[0.25, 0.5, 0.0]] * 3},
    {"id": "b", "target": [2.0], "predictions": [1.5],
     "target_grad": [[0.0, 0.0, 1.0]] * 9,
     "pred_grad": [[0.0, 0.0, 0.0]] * 9},
]


def _mlearn_root(root, elements=("Si", "Ni", "Cu", "Ge", "Li", "Mo")):
    """A synthetic mlearn-like data root: per element an id_prop.json and
    a config.json, and all/config_example.json."""
    os.makedirs(os.path.join(root, "all"), exist_ok=True)
    for i, el in enumerate(elements):
        d = os.path.join(root, el)
        os.makedirs(d, exist_ok=True)
        rows = [{"jid": str(j), "total_energy": -1.0 * (i + j)}
                for j in range(2 + i)]
        with open(os.path.join(d, "id_prop.json"), "w") as f:
            json.dump(rows, f)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"epochs": 50, "batch_size": 5,
                       "model": {"name": "alignn_atomwise",
                                 "hidden_features": 256}}, f)
    with open(os.path.join(root, "all", "config_example.json"), "w") as f:
        json.dump({"epochs": 3, "output_dir": "elsewhere",
                   "model": {"name": "alignn_atomwise"}}, f)
    return root


def _stub_train_main(calls):
    def stub(argv):
        args = dict(zip(argv[::2], argv[1::2]))
        with open(args["--config_name"]) as f:
            calls.append({"argv": [a for a in argv],
                          "config": json.load(f)})
        os.makedirs(args["--output_dir"], exist_ok=True)
        with open(os.path.join(args["--output_dir"], "Test_results.json"),
                  "w") as f:
            json.dump(FIXED_RESULTS, f)
        return {}
    return stub


def test_train_mlearn_routing_prepare_and_harvest_match_jax(tmp_path,
                                                            monkeypatch):
    import alignn_tpu.cli.train as jax_cli
    import alignn_tpu_torch.cli.train as port_cli

    root = _mlearn_root(str(tmp_path / "mlearn"))
    port, jax_mod = _mods("train_mlearn")
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(port_cli, "main", _stub_train_main(calls["port"]))
    monkeypatch.setattr(jax_cli, "main", _stub_train_main(calls["jax"]))
    out = {}
    overrides = ["epochs=2", "hidden_features=64", "learning_rate=0.01",
                 "envelope_edge_weights=true", "dense_neighborhoods=true",
                 "name=alignn_atomwise"]
    for tag, mod, extra in (("port", port, ["--device", "cpu"]),
                            ("jax", jax_mod, [])):
        o = str(tmp_path / tag)
        res = _quiet(mod.main, ["--elements", "Si,Ge,all", "--data_root",
                                root, "--output_dir", o, "--override",
                                *overrides] + extra)[0]
        files = {}
        for dirpath, _d, names in os.walk(o):
            for n in names:
                with open(os.path.join(dirpath, n)) as f:
                    files[os.path.relpath(os.path.join(dirpath, n), o)] = \
                        f.read().replace(o, "OUT")
        out[tag] = (json.loads(json.dumps(res).replace(o, "OUT")), files)
    assert out["port"] == out["jax"]
    files = out["port"][1]
    for el in ("Si", "Ge", "all"):
        assert f"config_{el}.json" in files
    routed = json.loads(files["config_Si.json"])
    assert routed["model"]["hidden_features"] == 64
    assert routed["model"]["envelope_edge_weights"] is True
    assert routed["epochs"] == 2 and routed["dense_neighborhoods"] is True
    rows = json.loads(files["all_data/id_prop.json"])
    assert [r["jid"] for r in rows[:3]] == ["Si-0", "Si-1", "Ni-0"]
    assert out["port"][0][0]["test_energy_mae"] == 0.375
    assert out["port"][0][0]["test_force_mae"] == pytest.approx(
        (3 * 0.25 + 9 * 1.0) / 36)
    # the same train_main argument lists, up to the output root and the
    # port's device
    strip = [[a.replace(str(tmp_path / t), "OUT") for a in c["argv"]
              if a not in ("--device", "cpu")] for t in ("port", "jax")
             for c in calls[t]]
    assert strip[:3] == strip[3:]
    assert all(c["argv"][-2:] == ["--device", "cpu"] for c in calls["port"])


def _stub_trainer(seen):
    def stub(cfg, tr, va, te, *a, **k):
        seen.append({"config": json.loads(json.dumps(cfg.to_dict(),
                                                     default=str)),
                     "n": (len(tr.dataset), len(va.dataset),
                           len(te.dataset))})
        return {"test_mae": 0.125, "best_val": 1.0}
    return stub


@pytest.mark.parametrize("name", ["final_model", "compare_cfid"])
def test_training_scripts_match_jax(name, records, tmp_path, monkeypatch):
    import alignn_tpu.train.trainer as jax_trainer
    import alignn_tpu_torch.train.trainer as port_trainer

    recs = [{**r, "target": float(i)} for i, r in enumerate(records * 2)]
    path = tmp_path / "records.json"
    with open(path, "w") as f:
        json.dump(recs, f)
    seen = {"port": [], "jax": []}
    monkeypatch.setattr(port_trainer, "train_model",
                        _stub_trainer(seen["port"]))
    monkeypatch.setattr(jax_trainer, "train_model",
                        _stub_trainer(seen["jax"]))
    port, jax_mod = _mods(name)
    outs = {}
    for tag, mod, extra in (("port", port, ["--device", "cpu"]),
                            ("jax", jax_mod, [])):
        o = str(tmp_path / tag)
        args = ["--records_json", str(path), "--output_dir", o]
        if name == "compare_cfid":
            args += ["--epochs", "2", "--batch_size", "4"]
        _quiet(mod.main, args + extra)
        outs[tag] = o
    for p, j in zip(seen["port"], seen["jax"]):
        assert p["n"] == j["n"]
        pc, jc = p["config"], j["config"]
        assert pc["output_dir"].replace(outs["port"], "OUT") == \
            jc["output_dir"].replace(outs["jax"], "OUT")
        for k in ("epochs", "batch_size", "n_train", "n_val", "n_test",
                  "atom_features", "keep_data_order", "cutoff"):
            assert pc[k] == jc[k], k
        for k in ("name", "atom_input_features", "hidden_features"):
            assert pc["model"][k] == jc["model"][k], k
    assert len(seen["port"]) == len(seen["jax"]) == \
        (2 if name == "compare_cfid" else 1)
    if name == "compare_cfid":
        with open(os.path.join(outs["port"], "comparison.json")) as f:
            got = json.load(f)
        with open(os.path.join(outs["jax"], "comparison.json")) as f:
            want = json.load(f)
        assert got.keys() == want.keys() == {"cgcnn", "cfid"}
        for k in got:
            assert got[k]["test_mae"] == want[k]["test_mae"] == 0.125
            assert got[k]["mad"] == pytest.approx(want[k]["mad"],
                                                  rel=1e-12)


def test_train_mlearn_one_epoch_on_the_cpu(model_dir, tmp_path):
    """The port's train_mlearn for real: one epoch of a 1+1/16 force field
    on eight labelled rattled rocksalt cells."""
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator

    calc = Calculator(path=model_dir, device="cpu")
    root = tmp_path / "root"
    (root / "NaCl").mkdir(parents=True)
    rng = np.random.default_rng(11)
    rows = []
    for i in range(8):
        atoms = Atoms(lattice_mat=np.eye(3) * 5.6,
                      frac_coords=ROCKSALT
                      + 0.02 * rng.standard_normal((8, 3)),
                      elements=["Na"] * 4 + ["Cl"] * 4)
        res = calc.calculate(atoms)
        rows.append({"jid": f"c{i}", "atoms": atoms.to_dict(),
                     "total_energy": res["energy"] / 8,
                     "forces": np.asarray(res["forces"]).tolist(),
                     "stresses": np.asarray(res["stress"]).tolist()})
    with open(root / "NaCl" / "id_prop.json", "w") as f:
        json.dump(rows, f)
    with open(root / "NaCl" / "config.json", "w") as f:
        json.dump({**FF_CONFIG, "epochs": 3, "batch_size": 2, "n_train": 4,
                   "n_val": 2, "n_test": 2, "model": SMALL_FF}, f)
    port, _jax = _mods("train_mlearn")
    out = str(tmp_path / "out")
    res = _quiet(port.main, ["--elements", "NaCl", "--data_root", str(root),
                             "--output_dir", out, "--override", "epochs=1",
                             "--device", "cpu"])[0]
    assert res[0]["element"] == "NaCl"
    assert np.isfinite(res[0]["test_energy_mae"])
    assert np.isfinite(res[0]["test_force_mae"])
    with open(os.path.join(out, "config_NaCl.json")) as f:
        assert json.load(f)["epochs"] == 1
    with open(os.path.join(out, "mlearn_summary.json")) as f:
        assert json.load(f) == res
    assert os.path.exists(os.path.join(out, "NaCl", "best_model.mpk"))
