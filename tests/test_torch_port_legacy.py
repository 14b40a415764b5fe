"""alignn_tpu_torch's legacy config-file CLI (``cli/legacy.py``) and the
cache half of ``data/figshare.py`` against alignn_tpu's, on the CPU.

Both CLIs train the 1+1/16 property model for one epoch on a
``<cache_dir>/dft_3d.json`` written by the test (16 two-atom rocksalt
records), from the same initial weights (JAX's initialisation at the
config's seed, carried into the port), into a scratch
``--checkpoint_dir``: ``metrics.json`` and ``fullconfig.json`` beside the
config and the checkpoints copied back, equal to JAX's within tolerance.
Without the cache file a dataset with a URL raises NotImplementedError
(downloads are not ported) and one without raises JAX's ValueError.
"""

import json
import os

import numpy as np
import pytest
from torch_port_threads import _two_threads  # noqa: E402,F401

MODEL = {"name": "alignn", "alignn_layers": 1, "gcn_layers": 1,
         "hidden_features": 16, "embedding_features": 8}
# SGD: the biases that feed a BatchNorm have a gradient of 0 but for
# rounding, which AdamW would scale up to steps of about lr in either
# package
CONFIG = {"dataset": "dft_3d", "target": "formation_energy_peratom",
          "epochs": 1, "batch_size": 4, "n_train": 8, "n_val": 4,
          "n_test": 4, "keep_data_order": True, "num_workers": 0,
          "progress": False, "optimizer": "sgd", "model": MODEL}


def _records(n=16):
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        a = 4.0 + 0.1 * rng.standard_normal()
        out.append({
            "jid": f"t-{i}",
            "atoms": {"lattice_mat": (np.eye(3) * a).tolist(),
                      "coords": [[0, 0, 0], [0.5, 0.5, 0.5]],
                      "elements": ["Na", "Cl"]},
            "formation_energy_peratom": float(rng.standard_normal()),
        })
    return out


def _jax_init(records):
    """JAX's initial variables of MODEL at the trainer's seed (123): the
    values depend on the seed and the shapes alone."""
    import jax

    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu.graph.build import build_graph
    from alignn_tpu.nn.models import ALIGNN, ALIGNNConfig

    g = build_graph(JAtoms.from_dict(records[0]["atoms"]))
    jm = ALIGNN(cfg=ALIGNNConfig(**{k: v for k, v in MODEL.items()
                                    if k != "name"}))
    return jax.jit(lambda k, b: jm.init(k, b, train=False))(
        jax.random.PRNGKey(123), batch_graphs([g], BucketSpec.
                                              tight_for_batch([g])))


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def test_legacy_cli_matches_jax(tmp_path, monkeypatch):
    import alignn_tpu.data.figshare as jfigshare
    import alignn_tpu_torch.train.trainer as trainer
    from alignn_tpu.cli import legacy as jlegacy
    from alignn_tpu_torch.cli import legacy
    from alignn_tpu_torch.nn.convert import state_dict_from_flax

    cache = tmp_path / "cache"
    cache.mkdir()
    records = _records()
    (cache / "dft_3d.json").write_text(json.dumps(records))
    monkeypatch.setattr(jfigshare, "_CACHE", str(cache))
    monkeypatch.setenv("ALIGNN_TPU_DATA_CACHE", str(cache))
    v = _jax_init(records)
    start = state_dict_from_flax(
        _np_tree(v["params"]), batch_stats=_np_tree(v["batch_stats"]))

    def jax_weights(model, _generator):
        model.load_state_dict(start)
        return model

    monkeypatch.setattr(trainer, "init_parameters", jax_weights)
    out = {}
    for name, cli in (("jax", jlegacy), ("port", legacy)):
        d = tmp_path / name
        d.mkdir()
        cfg = d / "config.json"
        cfg.write_text(json.dumps(CONFIG))
        argv = [str(cfg), "--checkpoint_dir", str(d / "scratch")]
        cli.main(argv + (["--device", "cpu"] if name == "port" else []))
        out[name] = str(d)
    for name in ("metrics.json", "fullconfig.json", "best_model.mpk",
                 "last_model.mpk"):
        assert os.path.exists(os.path.join(out["port"], name)), name
    load = {n: {f: json.load(open(os.path.join(d, f)))
                for f in ("metrics.json", "fullconfig.json")}
            for n, d in out.items()}
    got, ref = load["port"]["metrics.json"], load["jax"]["metrics.json"]
    assert got["epochs_run"] == ref["epochs_run"] == 1
    for key in ("best_val_loss", "test_mae"):
        assert got[key] == pytest.approx(ref[key], rel=1e-5), key
    full = {n: {k: v for k, v in c["fullconfig.json"].items()
                if k != "version"} for n, c in load.items()}
    for name, d in out.items():   # each trained into its own scratch
        assert full[name].pop("output_dir") == os.path.join(d, "scratch")
    assert full["port"] == full["jax"]


def test_load_dataset_cache_and_refusals(tmp_path, monkeypatch):
    """A cache file is read as JAX reads it; without one, a known URL
    raises NotImplementedError naming the decision, no URL JAX's
    ValueError; the presets and the URL table are JAX's."""
    import alignn_tpu.data.figshare as jfigshare
    from alignn_tpu_torch.data import figshare

    monkeypatch.setenv("ALIGNN_TPU_DATA_CACHE", str(tmp_path))
    (tmp_path / "megnet.json").write_text(json.dumps(_records(3)))
    assert figshare.load_dataset("megnet") == \
        jfigshare.load_dataset("megnet", cache_dir=str(tmp_path))
    assert figshare.dataset_cache_path("megnet") == \
        str(tmp_path / "megnet.json")
    with pytest.raises(NotImplementedError,
                       match='"Not ported, by decision"'):
        figshare.load_dataset("dft_3d")
    with pytest.raises(ValueError, match="no known figshare url"):
        figshare.load_dataset("qm9")
    with pytest.raises(ValueError, match="no known figshare url"):
        jfigshare.load_dataset("qm9", cache_dir=str(tmp_path))
    assert figshare.DATASET_URLS == jfigshare.DATASET_URLS
    assert figshare.DATASET_PRESETS == jfigshare.DATASET_PRESETS
