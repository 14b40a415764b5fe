"""alignn_tpu_torch's E/F/S trainer of the force field against alignn_tpu's,
on the CPU.

Split from ``test_torch_port_trainer.py`` (whose folder writer and config
it uses) so that ``--dist loadfile`` can run its three long cases on
another worker than the rest of that file.
"""

import json
import os

import numpy as np
import pytest

from test_torch_port_trainer import _load, write_config, write_folder
from torch_port_threads import _two_threads  # noqa: E402,F401

FF_MODEL = {"name": "alignn_atomwise", "alignn_layers": 1, "gcn_layers": 1,
            "hidden_features": 32, "embedding_features": 16,
            "gradwise_weight": 1.0, "stresswise_weight": 0.1}
FF_VARIANTS = {"knn": {},
               "radius": {"neighbor_strategy": "radius_graph",
                          "cutoff": 5.0},
               "species_baseline": {"per_species_energy_baseline": True}}


@pytest.mark.parametrize("variant", list(FF_VARIANTS))
def test_ff_trainer_matches_jax(tmp_path, variant):
    """The E/F/S trainer against JAX's: ``alignn_atomwise`` 1+1/32 with
    forces and stresses in the loss (gradwise 1, stresswise 0.1), 16
    rocksalt cells in id_prop.json, 2 epochs, l1, from one ``.mpk`` that
    JAX's save_params wrote from a JAX init; on the k-NN graph, the radius
    graph (cutoff 5 A) and with per-species energy baselines.  History:
    epoch 1 within 1e-4 relative, epoch 2 within 1e-3; test energies,
    forces and stresses within 1e-4; the same artifact set, JAX's
    learning-curve plot included."""
    import jax

    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.cli.train import train_for_folder as jtrain
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import build_graph as jbuild
    from alignn_tpu.nn.models import ALIGNNAtomWise as JModel
    from alignn_tpu.nn.models import ALIGNNAtomWiseConfig as JConfig
    from alignn_tpu.train.checkpoint import checkpoint_meta, save_params
    from alignn_tpu_torch.cli.train import train_for_folder

    root = write_folder(tmp_path / "data", 16, seed=11, kind="json")
    config = write_config(tmp_path / "config.json", model=FF_MODEL,
                          **FF_VARIANTS[variant])
    entry = json.load(open(os.path.join(root, "id_prop.json")))[0]
    g = jbuild(JAtoms.from_dict(entry["atoms"]))
    jm = JModel(cfg=JConfig(**{k: v for k, v in FF_MODEL.items()
                               if k != "name"}))
    v = jax.jit(lambda k, b: jm.init(k, b, b.r, train=False))(
        jax.random.PRNGKey(7), jbatch([g], JSpec.tight_for_batch([g])))
    init = str(tmp_path / "init.mpk")
    save_params(init, v["params"], meta=checkpoint_meta())
    out = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    kw = dict(root_dir=root, config_name=config, target_key="total_energy",
              restart_model_path=init)
    jtrain(output_dir=out["jax"], **kw)
    train_for_folder(output_dir=out["port"], device="cpu", **kw)
    for name in ("history_train.json", "history_val.json"):
        got, ref = _load(out["port"], name), _load(out["jax"], name)
        assert len(got) == len(ref) == 2
        for row_g, row_r, rtol in zip(got, ref, (1e-4, 1e-3)):
            np.testing.assert_allclose(row_g, row_r, rtol=rtol, atol=1e-7)
    got, ref = _load(out["port"], "Test_results.json"), \
        _load(out["jax"], "Test_results.json")
    assert [r["id"] for r in got] == [r["id"] for r in ref]
    for key in ("predictions", "pred_grad", "pred_stress"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in ref], rtol=0,
                                   atol=1e-4, err_msg=key)
    assert set(os.listdir(out["jax"])) - set(os.listdir(out["port"])) == \
        set()
    if variant == "species_baseline":
        assert _load(out["port"], "species_baseline.json") == \
            _load(out["jax"], "species_baseline.json")
