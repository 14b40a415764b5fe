"""Reference-format ``.pt`` checkpoints in alignn_tpu_torch, against
alignn_tpu, on the CPU.

The tests build module skeletons with the reference implementation's
attribute names (``atom_embedding.layer.{0,1}``, Sequential embeddings
with the RBF at index 0, EGGC ``bn_nodes``/``bn_edges``, extra-features
``fc1``/``fc2`` MLPLayers), draw their weights from torch seeds and save
them with ``torch.save``: (a) ``convert_torch_checkpoint`` gives the
trees JAX's gives, array for array, for a nested ALIGNNAtomWise, a flat
eALIGNN, extra-features heads and a DDP ``module.`` prefix, and
``merge_converted`` reports what JAX's reports; (b) ``load_model_dir``
on a directory holding only a ``.pt`` serves the energy JAX serves from
it, caches ``converted_model.mpk`` and converts again when the ``.pt``
is newer; (c) an eALIGNN ``.pt`` converted with the zoo's nested layout
keeps its initial trunk in both packages.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from torch import nn
from torch_port_threads import _two_threads  # noqa: E402,F401

SMALL = dict(alignn_layers=1, gcn_layers=1, hidden_features=32,
             embedding_features=16)
NACL = dict(lattice_mat=np.eye(3) * 4.1,
            frac_coords=[[0.01, 0.0, 0.02], [0.5, 0.49, 0.5]],
            elements=["Na", "Cl"])


class MLPLayer(nn.Module):
    """The reference's MLPLayer: ``layer = Sequential(Linear, Norm,
    SiLU)``."""

    def __init__(self, fin, fout, norm_cls):
        super().__init__()
        self.layer = nn.Sequential(nn.Linear(fin, fout), norm_cls(fout),
                                   nn.SiLU())


class RBF(nn.Module):
    """The RBF at index 0 of an embedding Sequential (no parameters)."""


class EGGC(nn.Module):
    def __init__(self, f, norm_cls):
        super().__init__()
        for name in ("src_gate", "dst_gate", "edge_gate", "src_update",
                     "dst_update"):
            setattr(self, name, nn.Linear(f, f))
        self.bn_nodes = norm_cls(f)
        self.bn_edges = norm_cls(f)


class ALIGNNConv(nn.Module):
    def __init__(self, f, norm_cls):
        super().__init__()
        self.node_update = EGGC(f, norm_cls)
        self.edge_update = EGGC(f, norm_cls)


class ReferenceModel(nn.Module):
    """Named as the reference's models.  `heads` lists the output heads
    (``fc``, ``fc_atomwise`` [hidden, 2], ``fc_additional_output``
    [hidden, 3]); `extra` > 0 adds the extra-features stack."""

    def __init__(self, hidden, embedding, layers, norm_cls, heads, extra):
        super().__init__()
        self.atom_embedding = MLPLayer(92, hidden, norm_cls)
        self.edge_embedding = nn.Sequential(
            RBF(), MLPLayer(80, embedding, norm_cls),
            MLPLayer(embedding, hidden, norm_cls))
        self.angle_embedding = nn.Sequential(
            RBF(), MLPLayer(40, embedding, norm_cls),
            MLPLayer(embedding, hidden, norm_cls))
        self.alignn_layers = nn.ModuleList(
            [ALIGNNConv(hidden, norm_cls) for _ in range(layers)])
        self.gcn_layers = nn.ModuleList(
            [EGGC(hidden, norm_cls) for _ in range(layers)])
        widths = {"fc": 1, "fc_atomwise": 2, "fc_additional_output": 3}
        for name in heads:
            setattr(self, name, nn.Linear(hidden, widths[name]))
        if extra:
            width = hidden + extra
            self.extra_feature_embedding = MLPLayer(extra, extra, norm_cls)
            self.fc1 = MLPLayer(width, width, norm_cls)
            self.fc2 = MLPLayer(width, width, norm_cls)
            self.fc3 = nn.Linear(width, 1)


def reference_skeleton(hidden=32, embedding=16, layers=1, norm="layernorm",
                       heads=("fc",), extra=0, seed=0) -> ReferenceModel:
    """A :class:`ReferenceModel` with its weights and norm statistics
    drawn from `seed`."""
    torch.manual_seed(seed)
    norm_cls = nn.LayerNorm if norm == "layernorm" else nn.BatchNorm1d
    model = ReferenceModel(hidden, embedding, layers, norm_cls, heads,
                           extra)
    with torch.no_grad():     # norms away from their (1, 0) start
        for m in model.modules():
            if isinstance(m, norm_cls):
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.2, 0.2)
                if norm_cls is nn.BatchNorm1d:
                    m.running_mean.uniform_(-0.3, 0.3)
                    m.running_var.uniform_(0.5, 1.5)
    return model


def _trees_equal(got, ref):
    from flax import core

    ref = jax.tree_util.tree_map(np.asarray, core.unfreeze(ref))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


CASES = {
    # name: (skeleton kwargs, layout, how the file holds it)
    "nested_atomwise": (dict(heads=("fc", "fc_atomwise",
                                    "fc_additional_output")),
                        "nested", "state_dict"),
    "flat_ealignn": (dict(), "flat", "model_key"),
    "fc_mlps": (dict(extra=4, heads=(), norm="batchnorm"), "nested",
                "module"),
    "module_prefix": (dict(norm="batchnorm"), "nested", "ddp"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_torch_checkpoint_matches_jax(tmp_path, case):
    """The port's (params, batch_stats) equal JAX's array for array, in
    dtype and shape, for a checkpoint saved as a state dict, as
    ``{"model": state dict}``, as the module itself and with DDP's
    ``module.`` prefix; the 0-d bias a log link leaves reads as [1]."""
    from alignn_tpu.train.checkpoint import convert_torch_checkpoint as jconv
    from alignn_tpu_torch.train.checkpoint import convert_torch_checkpoint

    kw, layout, how = CASES[case]
    ref = reference_skeleton(**kw)
    sd = ref.state_dict()
    if "fc" in kw.get("heads", ("fc",)):
        sd["fc.bias"] = torch.tensor(0.25)     # the log link's 0-d bias
    obj = {"state_dict": sd, "model_key": {"model": sd, "epoch": 3},
           "module": ref,
           "ddp": {f"module.{k}": v for k, v in sd.items()}}[how]
    path = str(tmp_path / "best_model.pt")
    torch.save(obj, path)
    params, stats = convert_torch_checkpoint(path, layout=layout)
    jparams, jstats = jconv(path, layout=layout)
    _trees_equal(params, jparams)
    _trees_equal(stats, jstats)
    assert bool(stats) == (kw.get("norm") == "batchnorm")
    if layout == "flat":
        assert "atom_embedding" in params and "alignn_layers_0" in params
    else:
        assert set(params) >= {"embeddings", "trunk"}
    if kw.get("extra"):
        np.testing.assert_array_equal(
            params["fc1"]["linear"]["kernel"],
            ref.fc1.layer[0].weight.detach().numpy().T)


@pytest.mark.parametrize("model_name", ["alignn", "alignn_atomwise",
                                        "ealignn_atomwise"])
def test_merge_converted_reports_as_jax(tmp_path, model_name):
    """Laid over each package's own model tree, a reference checkpoint of
    the same shape covers it all (nested ALIGNN and ALIGNNAtomWise, flat
    eALIGNN) with the same report as JAX's; a wrong width is reported as
    mismatched and keeps the template value."""
    from alignn_tpu.train.checkpoint import convert_torch_checkpoint as jconv
    from alignn_tpu.train.checkpoint import merge_converted as jmerge
    from alignn_tpu_torch.config import model_config_from_dict
    from alignn_tpu_torch.nn.convert import flax_from_module
    from alignn_tpu_torch.train.checkpoint import (convert_torch_checkpoint,
                                                   merge_converted)
    from alignn_tpu_torch.train.trainer import build_model

    norm = "batchnorm" if model_name == "alignn" else "layernorm"
    layout = "flat" if model_name == "ealignn_atomwise" else "nested"
    ref = reference_skeleton(norm=norm)
    sd = ref.state_dict()
    sd["gcn_layers.0.src_gate.bias"] = torch.zeros(7)    # a wrong width
    path = str(tmp_path / "m.pt")
    torch.save(sd, path)
    model = build_model(model_config_from_dict({"name": model_name,
                                                **SMALL}))
    params, stats = flax_from_module(model)
    cparams, cstats = convert_torch_checkpoint(path, layout=layout)
    merged, report = merge_converted(params, cparams)
    _jmerged, jreport = jmerge(params, jconv(path, layout=layout)[0])
    assert {k: sorted(v) for k, v in report.items()} == \
        {k: sorted(v) for k, v in jreport.items()}
    assert report["missing"] == [] and report["unused"] == []
    bad = ("gcn_layers_0", "src_gate", "bias")
    assert report["mismatched"] == [
        "/".join((("trunk",) if layout == "nested" else ()) + bad)]
    node = merged["trunk"] if layout == "nested" else merged
    np.testing.assert_array_equal(
        node["gcn_layers_0"]["src_gate"]["bias"],
        model.state_dict()[".".join((("trunk",) if layout == "nested"
                                     else ()) + bad)].numpy())
    np.testing.assert_array_equal(
        node["gcn_layers_0"]["src_gate"]["kernel"],
        ref.gcn_layers[0].src_gate.weight.detach().numpy().T)
    if norm == "batchnorm":
        merged_bs, bs_report = merge_converted(stats, cstats)
        assert bs_report["missing"] == []


def _write_model_dir(root, model_name: str, skeleton_kw: dict) -> str:
    os.makedirs(root, exist_ok=True)
    cfg = {"neighbor_strategy": "k-nearest", "cutoff": 5.0,
           "max_neighbors": 12, "atom_features": "cgcnn",
           "model": {"name": model_name, **SMALL,
                     "stresswise_weight": 0.1, "inner_cutoff": 2.5}}
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(cfg, f)
    torch.save(reference_skeleton(**skeleton_kw).state_dict(),
               os.path.join(root, "best_model.pt"))
    return str(root)


def test_load_model_dir_pt_matches_jax(tmp_path, capsys):
    """A directory with config.json and a reference ``best_model.pt`` of
    a 1+1/32 ALIGNNAtomWise: the port's Calculator and JAX's (both loading
    the directory) give the same energy (1e-5 relative) and forces (1e-5
    x max|F|); the port writes ``converted_model.mpk``, which the next
    load reads, and a newer ``.pt`` is converted again."""
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.ff.calculator import Calculator as JCalculator
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.zoo import load_model_dir

    d = _write_model_dir(tmp_path / "ff", "alignn_atomwise", {})
    jres = JCalculator(path=d).calculate(JAtoms(**NACL))
    os.remove(os.path.join(d, "converted_model.mpk"))    # JAX's cache
    res = Calculator(path=d, device="cpu").calculate(Atoms(**NACL))
    assert "not in checkpoint" not in capsys.readouterr().out
    np.testing.assert_allclose(res["energy"], jres["energy"], rtol=1e-5)
    np.testing.assert_allclose(res["forces"], jres["forces"], rtol=0,
                               atol=1e-5 * np.abs(jres["forces"]).max())
    cache = os.path.join(d, "converted_model.mpk")
    assert os.path.exists(cache)
    again = Calculator(path=d, device="cpu").calculate(Atoms(**NACL))
    assert again["energy"] == res["energy"]
    # a replaced .pt (newer than the cache) is converted again
    torch.save(reference_skeleton(seed=5).state_dict(),
               os.path.join(d, "best_model.pt"))
    os.utime(os.path.join(d, "best_model.pt"),
             (os.path.getmtime(cache) + 10,) * 2)
    model, _cfg = load_model_dir(d, device="cpu")
    np.testing.assert_array_equal(
        model.embeddings.atom_embedding.linear.weight.detach().numpy(),
        reference_skeleton(seed=5).atom_embedding.layer[0].weight
        .detach().numpy())


def test_ealignn_pt_keeps_init_as_jax(tmp_path, capsys):
    """JAX's zoo converts a ``.pt`` with the nested layout whatever the
    model, so an eALIGNN checkpoint's embeddings and trunk find no place
    in eALIGNN's flat tree and keep the initial weights; its top-level
    ``fc`` loads.  The port keeps that behaviour: both packages report
    the same count of parameters kept at init."""
    from alignn_tpu.zoo import load_model_dir as jload
    from alignn_tpu_torch.zoo import load_model_dir

    # seed 3: the port draws its initial weights from seed 0 with the law
    # of nn.Linear, so a seed-0 skeleton would hold the same numbers
    d = _write_model_dir(tmp_path / "eal", "ealignn_atomwise", {"seed": 3})
    _jm, jv, _ = jload(d)
    jout = capsys.readouterr().out
    os.remove(os.path.join(d, "converted_model.mpk"))
    model, _cfg = load_model_dir(d, device="cpu")
    out = capsys.readouterr().out
    count = [ln.split()[1] for ln in out.splitlines() if "[zoo]" in ln]
    assert count and count == [ln.split()[1] for ln in jout.splitlines()
                                if "[zoo]" in ln]
    ref = reference_skeleton(seed=3)
    np.testing.assert_array_equal(model.fc.weight.detach().numpy(),
                                  ref.fc.weight.detach().numpy())
    np.testing.assert_array_equal(np.asarray(jv["params"]["fc"]["kernel"]),
                                  ref.fc.weight.detach().numpy().T)
    assert not np.allclose(
        model.atom_embedding.linear.weight.detach().numpy(),
        ref.atom_embedding.layer[0].weight.detach().numpy())


def test_save_converted_checkpoint_reads_in_jax(tmp_path):
    """``save_converted_checkpoint`` writes the conversion as a weights
    file that JAX's ``load_params_with_meta`` reads: the same trees as
    JAX's own conversion, batch_stats included, and the provenance stamp
    naming the ``.pt``."""
    from alignn_tpu.train.checkpoint import convert_torch_checkpoint as jconv
    from alignn_tpu.train.checkpoint import load_params_with_meta as jload
    from alignn_tpu_torch.train.checkpoint import save_converted_checkpoint

    pt = str(tmp_path / "best_model.pt")
    torch.save(reference_skeleton(norm="batchnorm").state_dict(), pt)
    out = save_converted_checkpoint(pt, str(tmp_path / "converted.mpk"))
    params, stats, meta = jload(out)
    jparams, jstats = jconv(pt)
    _trees_equal(jax.tree_util.tree_map(np.asarray, dict(params)), jparams)
    _trees_equal(jax.tree_util.tree_map(np.asarray, dict(stats)), jstats)
    assert meta["converted_from"] == "best_model.pt"
    assert meta["feature_table"]["atom_features"] == "cgcnn"
