"""The model families of alignn_tpu_torch beyond the plain ALIGNN and
ALIGNN-FF models, against alignn_tpu on the CPU.

(a) ``ALIGNN`` and ``ALIGNNAtomWise`` with ``extra_features``: the
train-mode value and the first train step's loss and gradients, sparse
and dense; (b) a folder whose records carry extra features, through
both packages' ``train_for_folder``; (c) eALIGNN's energy, forces and
stress, sparse and dense, with the torque removal on and off, and the
dense layout against the sparse one; (d) its forces on a k-NN graph
against central finite differences (the port of
``tests/test_forces.py::test_ealignn_knearest_fd_force``); (e) its train
step; (f) an ``ealignn_atomwise`` folder run against JAX's trainer;
(g) the Calculator serving eALIGNN, dense against sparse and against
JAX's; (h) ``iCalculator`` against JAX's, with the gap clamp; (i) the
on-device MD and relaxation loops refuse eALIGNN; (j) the two switches
of JAX that the port lacks raise.

1+1 layers, hidden 32, rattled rocksalt cells from numpy seeds; JAX's
weights reach the port through ``nn/convert.py``.  Limits: values 1e-5
x the largest reference value, a first train step's loss 1e-4 relative
and each gradient 1e-3 x its max|grad| + 1e-7 (a bias feeding a
BatchNorm, whose exact gradient is 0 or within the aggregation's 1e-6
eps of it, at the model's largest gradient),
folder histories as ``test_trainer_matches_jax``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_port_trainer import _load, write_config, write_folder
from torch_port_threads import _two_threads  # noqa: E402,F401

CPU = torch.device("cpu")
SMALL = dict(alignn_layers=1, gcn_layers=1, hidden_features=32,
             embedding_features=16)
FX = 3                           # extra features per structure
EAL = dict(name="ealignn_atomwise", **SMALL, stresswise_weight=0.1,
           inner_cutoff=2.5)     # prunes the rocksalt second shell
LIMITS = {"value_rel": 1e-5, "loss_rel": 1e-4, "grad_rel": 1e-3,
          "grad_abs": 1e-7}


def _graphs(n: int = 4, seed: int = 1):
    """n rattled rocksalt k-NN graphs with labels and FX extra features
    drawn from numpy seed `seed`."""
    from alignn_tpu_torch.graph.build import rocksalt_graphs

    graphs = rocksalt_graphs(n, seed=seed, rattle=0.05)
    rng = np.random.default_rng(seed)
    for g in graphs:
        g.extra_features = rng.standard_normal(FX)
    return graphs


@pytest.fixture(scope="module")
def batches():
    """{layout: (port batch, JAX batch)} of four cells, with extras."""
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import GraphData as JGraph
    from alignn_tpu.graph.dense import dense_batch_graphs as jdense
    from alignn_tpu.graph.dense import dense_spec_for_batch as jdspec
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.dense import (dense_batch_graphs,
                                              dense_spec_for_batch)

    graphs = _graphs()
    jgraphs = [JGraph(**vars(g)) for g in graphs]
    kw = dict(target_width=1, extra_width=FX)
    return {
        "sparse": (batch_graphs(graphs, BucketSpec.tight_for_batch(graphs),
                                CPU, **kw),
                   jbatch(jgraphs, JSpec.tight_for_batch(jgraphs),
                          gather_windows=False, **kw)),
        "dense": (dense_batch_graphs(graphs, dense_spec_for_batch(graphs),
                                     CPU, **kw),
                  jdense(jgraphs, jdspec(jgraphs), **kw))}


def _jax_model(cfg: dict):
    from alignn_tpu.config import model_config_from_dict as jcfg
    from alignn_tpu.train.trainer import build_model as jbuild

    return jbuild(jcfg(cfg))


def _jax_init(jm, jb, seed: int = 0) -> dict:
    """JAX variables of model `jm` initialised on batch `jb`."""
    from alignn_tpu.nn.ealignn import eALIGNNAtomWise as JEal
    from alignn_tpu.nn.models import ALIGNNAtomWise as JAtomWise

    if isinstance(jm, JEal):
        args = lambda b: (b, b.frac_coords)          # noqa: E731
    elif isinstance(jm, JAtomWise):
        args = lambda b: (b, b.r)                    # noqa: E731
    else:
        args = lambda b: (b,)                        # noqa: E731
    v = jax.jit(lambda k, b: jm.init(k, *args(b), train=False))(
        jax.random.PRNGKey(seed), jb)
    return jax.tree_util.tree_map(np.array, dict(v))   # writable copies


def _port_model(cfg: dict, variables: dict):
    from alignn_tpu_torch.config import model_config_from_dict
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.train.trainer import build_model

    model = build_model(model_config_from_dict(cfg))
    model.load_state_dict(state_dict_from_flax(
        variables["params"], batch_stats=variables.get("batch_stats")))
    return model


def _step_against_jax(cfg: dict, tb, jb, seed: int = 0) -> dict:
    """JAX's ``_forward_and_loss`` (train mode) and its gradient, and the
    port's first train step from the same weights and batch: the
    predictions of both, and each gradient's distance from JAX's as a
    share of its limit."""
    from flax import core

    from alignn_tpu.train.state import _forward_and_loss as jloss
    from alignn_tpu_torch.nn.convert import state_dict_from_flax
    from alignn_tpu_torch.train.optim import build_optimizer
    from alignn_tpu_torch.train.state import (_forward_and_loss,
                                              create_train_state,
                                              make_train_step)

    jm = _jax_model(cfg)
    v = _jax_init(jm, jb, seed)
    stats = core.freeze(v.get("batch_stats", {}))
    (_l, (jlosses, jres, _s)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss(jm, p, stats, jb, "l1", False, True),
        has_aux=True))(v["params"])
    model = _port_model(cfg, v)
    model.train()
    _losses, res = _forward_and_loss(model, tb, "l1", False, True)
    model.load_state_dict(_port_model(cfg, v).state_dict())  # stats back
    state = create_train_state(model, tb, build_optimizer("adamw", 1e-3,
                                                          0.0))
    _state, losses = make_train_step(model, "l1")(state, tb)
    ref = state_dict_from_flax(jgrads)
    assert set(ref) == {k for k, _p in model.named_parameters()}
    top = max(float(g.abs().max()) for g in ref.values())

    def scale(k):
        # a bias feeding a BatchNorm has an exact gradient of 0: both
        # packages' are rounding noise, held to the model's largest.  The
        # aggregation is a gate-weighted mean, so dst_update's bias reaches
        # the node BatchNorm as a constant shift too (but for the 1e-6
        # share of the denominator's eps)
        bn_fed = cfg["name"] == "alignn" and k.endswith(
            ("linear.bias", "src_update.bias", "dst_update.bias"))
        return top if bn_fed else float(ref[k].abs().max())

    worst = max(float((p.grad - ref[k]).abs().max())
                / (LIMITS["grad_rel"] * scale(k) + LIMITS["grad_abs"])
                for k, p in model.named_parameters())
    return {"jres": jax.device_get(jres), "res": res,
            "jloss": float(jlosses["loss"]), "loss": float(losses["loss"]),
            "grad_worst": worst}


def _close(got, ref, mask, what):
    """Within 1e-5 x the largest reference value."""
    got = got.detach().numpy()[mask]
    ref = np.asarray(ref)[mask]
    np.testing.assert_allclose(got, ref, rtol=0, atol=LIMITS[
        "value_rel"] * np.abs(ref).max(), err_msg=what)


# ---------------------------------------------------------------------------
# (a) extra features: value and train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["sparse", "dense"])
@pytest.mark.parametrize("name", ["alignn", "alignn_atomwise"])
def test_extra_features_match_jax(batches, name, layout):
    """The extra-features head (BatchNorm in ALIGNN, LayerNorm in
    ALIGNNAtomWise): train-mode output, E/F/S for the force field, the
    first step's loss and every gradient, including those of
    ``extra_feature_embedding``, ``fc1``..``fc3``."""
    tb, jb = batches[layout]
    cfg = {"name": name, **SMALL, "extra_features": FX}
    if name == "alignn_atomwise":
        cfg["stresswise_weight"] = 0.1
    r = _step_against_jax(cfg, tb, jb)
    gm, nm = tb.graph_mask.numpy() > 0, tb.node_mask.numpy() > 0
    _close(r["res"]["out"], r["jres"]["out"], gm, "out")
    if name == "alignn_atomwise":
        _close(r["res"]["grad"], r["jres"]["grad"], nm, "forces")
        _close(r["res"]["stresses"], r["jres"]["stresses"], gm, "stress")
    assert abs(r["loss"] - r["jloss"]) <= LIMITS["loss_rel"] * \
        abs(r["jloss"])
    assert r["grad_worst"] <= 1.0


def test_extra_features_reach_the_output(batches):
    """Changing one structure's extra features moves its prediction and
    no other's; a model without them carries a [G, 0] column."""
    from alignn_tpu_torch.config import model_config_from_dict
    from alignn_tpu_torch.nn.models import init_parameters
    from alignn_tpu_torch.train.trainer import build_model

    tb, _jb = batches["sparse"]
    model = init_parameters(build_model(model_config_from_dict(
        {"name": "alignn", **SMALL, "extra_features": FX})),
        torch.Generator().manual_seed(0)).eval()
    assert not hasattr(model, "fc") and tb.extra_features.shape == \
        (tb.graph_mask.shape[0], FX)
    base = model(tb).detach()
    moved = tb.extra_features.clone()
    moved[1] += 1.0
    import dataclasses

    out = model(dataclasses.replace(tb, extra_features=moved)).detach()
    changed = (out - base).abs()[:, 0] > 1e-6
    assert changed.tolist()[:4] == [False, True, False, False]
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs

    graphs = _graphs(2)
    plain = batch_graphs(graphs, BucketSpec.tight_for_batch(graphs), CPU)
    assert tuple(plain.extra_features.shape) == (3, 0)


# ---------------------------------------------------------------------------
# (b), (f) folder runs against JAX's trainer
# ---------------------------------------------------------------------------


def _folder_runs(base, model_block: dict, extras: bool):
    """Both packages' ``train_for_folder`` on 16 rocksalt cells in
    id_prop.json (energy, forces, stresses; with FX extra features each
    if `extras`), 2 epochs, from one ``.mpk`` of a JAX init."""
    from alignn_tpu.cli.train import train_for_folder as jtrain
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.train.checkpoint import checkpoint_meta, save_params
    from alignn_tpu_torch.cli.train import train_for_folder

    root = write_folder(base / "data", 16, seed=12, kind="json")
    path = os.path.join(root, "id_prop.json")
    entries = json.load(open(path))
    rng = np.random.default_rng(12)
    if extras:
        for e in entries:
            e["extra_features"] = rng.standard_normal(FX).tolist()
    with open(path, "w") as f:
        json.dump(entries, f)
    config = write_config(base / "config.json", model=model_block)
    g = _graphs(1)[0]
    from alignn_tpu.graph.build import GraphData as JGraph

    jg = JGraph(**vars(g))
    jb = jbatch([jg], JSpec.tight_for_batch([jg]), target_width=1,
                extra_width=model_block.get("extra_features", 0))
    v = _jax_init(_jax_model(model_block), jb, seed=7)
    init = str(base / "init.mpk")
    save_params(init, v["params"], v.get("batch_stats"),
                meta=checkpoint_meta())
    out = {"jax": str(base / "jax"), "port": str(base / "port")}
    kw = dict(root_dir=root, config_name=config, target_key="total_energy",
              restart_model_path=init)
    jtrain(output_dir=out["jax"], **kw)
    train_for_folder(output_dir=out["port"], device="cpu", **kw)
    return out


def _runs_agree(out, atomwise: bool):
    """Histories: epoch 1 within 1e-4 relative, epoch 2 within 1e-3; test
    predictions (and forces and stresses) within 1e-4.  (A BatchNorm
    model is held to JAX's test predictions otherwise, see
    :func:`test_extra_features_folder_matches_jax`.)"""
    for name in ("history_train.json", "history_val.json"):
        got, ref = _load(out["port"], name), _load(out["jax"], name)
        assert len(got) == len(ref) == 2
        for row_g, row_r, rtol in zip(got, ref, (1e-4, 1e-3)):
            np.testing.assert_allclose(row_g, row_r, rtol=rtol, atol=1e-7)
    got, ref = _load(out["port"], "Test_results.json"), \
        _load(out["jax"], "Test_results.json")
    assert [r["id"] for r in got] == [r["id"] for r in ref]
    np.testing.assert_array_equal([r["target"] for r in got],
                                  [r["target"] for r in ref])
    if not atomwise:
        return
    for key in ("predictions", "pred_grad", "pred_stress"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in ref], atol=1e-4,
                                   err_msg=key)


def test_extra_features_folder_matches_jax(tmp_path):
    """An ALIGNN property model with 3 extra features a structure, read
    from id_prop.json records, trained by both packages: the histories
    agree, and the port, given JAX's final weights (``last_model.mpk``
    with its BatchNorm statistics), predicts JAX's Test_results.json
    within 1e-5 from the structures and their features.  (The two runs'
    own eval-mode predictions are not compared: a bias feeding a
    BatchNorm has a gradient of rounding noise, which AdamW turns into
    steps of the full learning rate, so the running means part by about
    1e-4 after 4 steps.)  The graph cache carries the features."""
    import shutil

    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.data.cache import GraphCache
    from alignn_tpu_torch.zoo import load_model_dir, predict_structures

    out = _folder_runs(tmp_path, {"name": "alignn", **SMALL,
                                  "extra_features": FX}, extras=True)
    _runs_agree(out, atomwise=False)
    last = tmp_path / "jax_last"
    last.mkdir()
    for name in ("config.json", "last_model.mpk"):
        shutil.copy(os.path.join(out["jax"], name), last)
    model, _cfg = load_model_dir(str(last), device="cpu")
    records = {e["jid"]: e for e in json.load(open(
        tmp_path / "data" / "id_prop.json"))}
    rows = _load(out["jax"], "Test_results.json")
    got = predict_structures(
        model, [Atoms.from_dict(records[r["id"]]["atoms"]) for r in rows],
        extra_features=[records[r["id"]]["extra_features"] for r in rows])
    np.testing.assert_allclose(got, [r["predictions"] for r in rows],
                               rtol=0, atol=1e-5)
    cache = GraphCache(os.path.join(out["port"], "graph_cache",
                                    "graphs_train"))
    assert cache[0].extra_features.shape == (FX,)


def test_ealignn_folder_matches_jax(tmp_path):
    """``ealignn_atomwise`` (1+1/32, inner cutoff 2.5 A, forces and
    stresses) trained by both packages from one starting ``.mpk``."""
    out = _folder_runs(tmp_path, EAL, extras=False)
    _runs_agree(out, atomwise=True)


# ---------------------------------------------------------------------------
# (c), (d), (e) eALIGNN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remove_torque", [True, False],
                         ids=["torque_removed", "torque_kept"])
def test_ealignn_efs_matches_jax(batches, remove_torque):
    """E/F/S of eALIGNN against JAX's ``ealignn_forward`` on the sparse and
    the dense batch, and the dense port against the sparse port; the
    inner cutoff prunes about half of the bonds."""
    from alignn_tpu.nn.ealignn import ealignn_forward as jforward
    from alignn_tpu_torch.nn.ealignn import ealignn_forward

    cfg = {**EAL, "remove_torque": remove_torque}
    jm = _jax_model(cfg)
    v = _jax_init(jm, batches["sparse"][1])
    model = _port_model(cfg, v).eval()
    results = {}
    for layout, (tb, jb) in batches.items():
        jres = jax.device_get(jax.jit(
            lambda b: jforward(jm, v, b, train=False))(jb))
        res = ealignn_forward(model, tb)
        gm, nm = tb.graph_mask.numpy() > 0, tb.node_mask.numpy() > 0
        _close(res["out"], jres["out"], gm, f"{layout} out")
        _close(res["grad"], jres["grad"], nm, f"{layout} forces")
        _close(res["stresses"], jres["stresses"], gm, f"{layout} stress")
        keep = res["keep"].numpy()[tb.edge_mask.numpy() > 0]
        assert 0.2 < keep.mean() < 0.8
        results[layout] = (res, gm, nm)
    (sp, gm, nm), (dn, _g, _n) = results["sparse"], results["dense"]
    for key, mask in (("out", gm), ("grad", nm), ("stresses", gm)):
        ref = sp[key].detach().numpy()[mask]
        np.testing.assert_allclose(dn[key].detach().numpy()[mask], ref,
                                   rtol=0, atol=2e-5 * np.abs(ref).max(),
                                   err_msg=key)
    if remove_torque:      # the net torque of each graph is gone
        from alignn_tpu_torch.nn.ealignn import remove_net_torque

        tb = batches["sparse"][0]
        f = sp["grad"].detach()
        again = remove_net_torque(
            torch.einsum("ni,nij->nj", tb.frac_coords,
                         tb.lattice[tb.node_graph]), f, tb.node_graph,
            tb.node_mask, tb.n_nodes)
        assert float((again - f).abs().max()) <= 1e-4 * float(
            f.abs().max())


def test_ealignn_knearest_fd_force():
    """eALIGNN on a k-nearest graph of a 2-atom cell: the recomputed bond
    vectors equal the stored ones (the reverse-edge images), and the
    forces equal central finite differences of the energy in float64
    (step 1e-4 A, within 1e-5 eV/A), the port of the JAX pin."""
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
    from alignn_tpu_torch.graph.build import build_graph
    from alignn_tpu_torch.nn.ealignn import (eALIGNNAtomWise,
                                             eALIGNNAtomWiseConfig,
                                             ealignn_forward)
    from alignn_tpu_torch.nn.models import init_parameters

    cfg = eALIGNNAtomWiseConfig(
        alignn_layers=1, gcn_layers=1, hidden_features=16,
        embedding_features=8, stresswise_weight=0.1, inner_cutoff=4.0,
        remove_torque=False)
    model = init_parameters(eALIGNNAtomWise(cfg), torch.Generator()
                            .manual_seed(0)).double().eval()
    lat = np.eye(3) * 4.0
    a = Atoms(lattice_mat=lat, frac_coords=[[0.02, 0, 0], [0.5, 0.5, 0.5]],
              elements=["Na", "Cl"])
    g = build_graph(a, neighbor_strategy="k-nearest", cutoff=8.0,
                    max_neighbors=12)
    batch = batch_graphs([g], BucketSpec.tight_for_batch([g]), CPU,
                         dtype=torch.float64)
    res = ealignn_forward(model, batch)
    em = batch.edge_mask.numpy() > 0.5
    np.testing.assert_allclose(res["r"].numpy()[em], batch.r.numpy()[em],
                               atol=1e-10)

    def energy(frac):
        with torch.no_grad():
            out = model(batch, torch.as_tensor(frac))
        return float((out["en_out"] * batch.graph_mask).sum())

    frac0 = batch.frac_coords.numpy()
    h = 1e-4
    for atom in range(2):
        for d in range(3):
            plus, minus = frac0.copy(), frac0.copy()
            step = h * np.linalg.inv(lat)[d]     # a cartesian step
            plus[atom] += step
            minus[atom] -= step
            # eALIGNN's forces carry the batch's total node count (2)
            fd = -(energy(plus) - energy(minus)) / (2 * h) * 2
            assert abs(fd - float(res["grad"][atom, d])) <= 1e-5, \
                (atom, d, fd, float(res["grad"][atom, d]))


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_ealignn_train_step_matches_jax(batches, layout):
    """eALIGNN's first E/F/S train step (forces and stress in the loss, so
    the step differentiates through the force backward, the torque
    solve and inv(lattice)): loss and every gradient against JAX's."""
    tb, jb = batches[layout]
    r = _step_against_jax(EAL, tb, jb)
    assert abs(r["loss"] - r["jloss"]) <= LIMITS["loss_rel"] * \
        abs(r["jloss"])
    assert r["grad_worst"] <= 1.0


# ---------------------------------------------------------------------------
# (g) Calculator, (h) iCalculator, (i) refusals
# ---------------------------------------------------------------------------

# a body-centred Na-Cl pair, rattled so that its forces are not noise
NACL = dict(lattice_mat=np.eye(3) * 4.1,
            frac_coords=[[0.04, 0.0, 0.07], [0.5, 0.43, 0.52]],
            elements=["Na", "Cl"])
CALC_CONFIG = {"neighbor_strategy": "k-nearest", "cutoff": 5.0,
               "max_neighbors": 12}


def _rocksalt_cell():
    """The first rattled cell of ``rocksalt_cells(1, seed=1, rattle=0.05)``
    as (lattice, fractional coordinates, elements)."""
    from alignn_tpu_torch.graph.build import rocksalt_cells

    atoms = next(iter(rocksalt_cells(1, seed=1, rattle=0.05)))[0]
    return dict(lattice_mat=atoms.lattice_mat, frac_coords=atoms.frac_coords,
                elements=atoms.elements)


def test_ealignn_calculator_matches_jax():
    """The Calculator serves eALIGNN (1+1/16, JAX-initialised, torque
    removed) on the dense layout and the sparse one for a rattled
    rocksalt cell (mirroring
    ``tests/test_dense.py::test_dense_calculator_ealignn``): dense equals
    sparse, and both equal JAX's Calculator, energy within 1e-5
    relative, forces and stress within 1e-5 x their largest value; the
    stresswise_weight patch rebuilds the eALIGNN model (stress nonzero)
    and leaves the caller's alone."""
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.ff.calculator import Calculator as JCalculator
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import build_graph as jbuild
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator

    cell = _rocksalt_cell()
    cfg = {**EAL, "hidden_features": 16, "embedding_features": 8,
           "stresswise_weight": 0.0}
    jm = _jax_model(cfg)
    jg = jbuild(JAtoms(**cell), cutoff=8.0, max_neighbors=12)
    v = _jax_init(jm, jbatch([jg], JSpec.tight_for_batch([jg])))
    model = _port_model(cfg, v)
    config = {"neighbor_strategy": "k-nearest", "cutoff": 8.0,
              "max_neighbors": 12, "model": cfg}
    out = {}
    for dense in (True, False):
        jres = JCalculator(model=jm, variables=v, config=config,
                           dense=dense).calculate(JAtoms(**cell))
        calc = Calculator(model=model, config=config, dense=dense,
                          device="cpu")
        res = calc.calculate(Atoms(**cell))
        assert bool(calc._spec.dense_D) == dense
        assert model.cfg.stresswise_weight == 0.0      # caller's, kept
        for key in ("energy", "forces", "stress"):
            ref = np.asarray(jres[key])
            np.testing.assert_allclose(res[key], ref, rtol=0, atol=1e-5 *
                                       np.abs(ref).max(),
                                       err_msg=f"{dense} {key}")
        out[dense] = res
    assert np.abs(out[True]["forces"]).max() > 1e-3
    assert np.abs(out[True]["stress"]).max() > 1e-4     # the 0.1 patch
    for key in ("energy", "forces", "stress"):
        np.testing.assert_allclose(out[True][key], out[False][key], rtol=0,
                                   atol=1e-5 * np.abs(out[False][key]).max())


def test_icalculator_matches_jax(tmp_path):
    """iCalculator with a 1+1/16 force field and a property model
    (ALIGNNAtomWise, atomwise head 2, additional head 4, one bias pushed
    negative under a "gap" name) loaded from a model directory by both
    packages: E/F/S equal the plain Calculator's, charges, magmoms and
    the named properties within 1e-5 of JAX's (1e-5 x the largest for
    the per-atom columns), the gap clamped to 0."""
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.ff.calculator import iCalculator as JiCalculator
    from alignn_tpu.graph.batch import BucketSpec as JSpec
    from alignn_tpu.graph.batch import batch_graphs as jbatch
    from alignn_tpu.graph.build import build_graph as jbuild
    from alignn_tpu.train.checkpoint import save_params
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff import DEFAULT_IPROPS
    from alignn_tpu_torch.ff.calculator import Calculator, iCalculator

    tiny = dict(alignn_layers=1, gcn_layers=1, hidden_features=16,
                embedding_features=8)
    ff_cfg = {"name": "alignn_atomwise", **tiny}
    prop_cfg = {"name": "alignn_atomwise", **tiny,
                "atomwise_output_features": 2,
                "additional_output_features": 4}
    jg = jbuild(JAtoms(**NACL), cutoff=5.0, max_neighbors=12)
    jb = jbatch([jg], JSpec.tight_for_batch([jg]))
    jff = _jax_model(ff_cfg)
    v_ff = _jax_init(jff, jb)
    v_prop = _jax_init(_jax_model(prop_cfg), jb, seed=1)
    v_prop["params"]["fc_additional_output"]["bias"][2] = -5.0
    prop_dir = tmp_path / "prop"
    prop_dir.mkdir()
    with open(prop_dir / "config.json", "w") as f:
        json.dump({**CALC_CONFIG, "model": prop_cfg}, f)
    save_params(str(prop_dir / "best_model.mpk"), v_prop["params"])
    props = ["p1", "p2", "gap_x", "p4"]
    config = {**CALC_CONFIG, "model": ff_cfg}
    jres = JiCalculator(model=jff, variables=v_ff, config=config,
                        prop_path=str(prop_dir), props=props).calculate(
        JAtoms(**NACL))
    model = _port_model(ff_cfg, v_ff)
    ic = iCalculator(model=model, config=config, prop_path=str(prop_dir),
                     props=props, device="cpu")
    res = ic.calculate(Atoms(**NACL))
    plain = Calculator(model=model, config=config, stress_wt=0.05,
                       device="cpu").calculate(Atoms(**NACL))
    for key in ("energy", "forces", "stress"):
        np.testing.assert_array_equal(res[key], plain[key])
        ref = np.asarray(jres[key])
        np.testing.assert_allclose(res[key], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=key)
    for key in ("charges", "magmoms"):
        assert len(res[key]) == 2
        np.testing.assert_allclose(res[key], jres[key], rtol=0, atol=1e-5 *
                                   np.abs(jres[key]).max(), err_msg=key)
    for name in props:
        assert res[name] == pytest.approx(jres[name], rel=1e-5, abs=1e-6)
    assert res["gap_x"] == 0.0 == jres["gap_x"]
    raw = ic._prop_calc.model.fc_additional_output.bias[2].item()
    assert raw == -5.0
    assert len(DEFAULT_IPROPS) == 22 and ic.props == props


def test_device_loops_refuse_ealignn():
    """run_md_jit and batch_relax hand the model bond vectors, as JAX's
    do; given eALIGNN they raise a TypeError instead of reading them as
    fractional coordinates."""
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.md_jit import run_md_jit
    from alignn_tpu_torch.ff.relax_jit import batch_relax
    from alignn_tpu_torch.nn.ealignn import (eALIGNNAtomWise,
                                             eALIGNNAtomWiseConfig)

    model = eALIGNNAtomWise(eALIGNNAtomWiseConfig(**{
        k: v for k, v in EAL.items() if k != "name"}))
    atoms = Atoms(**NACL)
    with pytest.raises(TypeError, match="ALIGNNAtomWise"):
        run_md_jit(model, atoms, steps=1, device="cpu")
    with pytest.raises(TypeError, match="ALIGNNAtomWise"):
        batch_relax(model, [atoms], max_steps=1, device="cpu")
