"""The plain reference against the program's CPU path at small sizes."""

import pytest
import torch

from benchcells import SMALL_MODEL, run_small
from reference import graph as rgraph
from reference import model as rmodel
from traffic import prototypes, si_supercell


def program_graph(s, canonize):
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.graph.build import build_graph

    atoms = Atoms(lattice_mat=s["lattice"], frac_coords=s["frac"],
                  elements=s["elements"])
    return build_graph(atoms, neighbor_strategy="k-nearest", cutoff=8.0,
                       max_neighbors=12, use_canonize=canonize)


def reference_graph(s, canonize):
    table = rmodel.elements()
    z = [table[e]["z"] for e in s["elements"]]
    return rgraph.build(z, s["frac"], s["lattice"], 8.0, 12, canonize)


SI = si_supercell.md_system({"element": "Si", "lattice_A": 5.43,
                             "repeat": [2, 2, 1], "rattle_A": 0.03}, 7)
PROTOS = prototypes.training_set({"n_train": 12, "n_val": 4}, 7)


@pytest.mark.parametrize("canonize", [False, True])
@pytest.mark.parametrize("k", range(len(PROTOS) + 1))
def test_graphs_are_the_programs(k, canonize):
    """Same directed edges, duplicates counted, on rattled Si and on the
    prototype crystals (whose periodic images tie at the k-th shell)."""
    s = SI if k == len(PROTOS) else PROTOS[k]
    g_ref, g_prog = reference_graph(s, canonize), program_graph(s, canonize)
    assert rgraph.edges_differ(g_ref, g_prog) == 0
    assert g_ref.counts == (g_prog.num_nodes, g_prog.num_edges,
                            g_prog.num_lg_edges)


def _model_cfg(prop: bool) -> dict:
    from harness import spec

    name = "alignn_jarvis_prop" if prop else "alignnff_mlearn_si"
    cfg = spec.config_of(spec.benchmark(), name)["model"]
    return {**cfg, **SMALL_MODEL}


def _program_batch(structures, canonize):
    from alignn_tpu_torch.data.loader import worst_case_spec
    from alignn_tpu_torch.graph.batch import batch_graphs

    gs = [program_graph(s, canonize) for s in structures]
    return batch_graphs(gs, worst_case_spec(gs, len(gs)),
                        torch.device("cpu"))


def test_property_model_outputs_are_the_programs():
    from alignn_tpu_torch.nn.models import ALIGNN, ALIGNNConfig

    from harness.weights import load_into

    cfg = _model_cfg(True)
    params = rmodel.init_params(cfg, True, torch.Generator().manual_seed(1),
                                "cpu")
    model = ALIGNN(ALIGNNConfig.from_dict(cfg))
    load_into(model, params)
    model.train()    # batch statistics, as a training step normalises
    batch = _program_batch(PROTOS[:8], True)
    b = rmodel.batch_tensors([reference_graph(s, True) for s in PROTOS[:8]],
                             "cpu")
    with torch.no_grad():
        prog = model(batch)[:8, 0]
        ref = rmodel.forward(params, cfg, b, b["r"], property_model=True)[0]
    # f32 sums in another order: a few ulps of outputs of order 1
    torch.testing.assert_close(prog, ref[:, 0], rtol=0, atol=2e-5)


@pytest.mark.parametrize("canonize", [False, True])
def test_force_field_energy_and_forces_are_the_programs(canonize):
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig,
                                            atomwise_forward)

    from harness.weights import load_into

    cfg = _model_cfg(False)
    params = rmodel.init_params(cfg, False,
                                torch.Generator().manual_seed(2), "cpu")
    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig.from_dict(cfg))
    load_into(model, params)
    cells = [si_supercell.md_system({"element": "Si", "lattice_A": 5.43,
                                     "repeat": [1, 1, 1], "rattle_A": 0.1},
                                    s) for s in (3, 4)]
    batch = _program_batch(cells, canonize)
    res = atomwise_forward(model.eval(), batch)
    b = rmodel.batch_tensors([reference_graph(s, canonize) for s in cells],
                             "cpu")
    out, _e, forces = rmodel.energy_forces(params, cfg, b, b["r"])
    n = b["feats"].shape[0]
    torch.testing.assert_close(res["out"][:2, 0].detach(), out.detach(),
                               rtol=0, atol=2e-5)
    torch.testing.assert_close(res["grad"][:n].detach(), forces.detach(),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", ["ff_md_si512", "ff_train_si64",
                                  "prop_train_jarvis"])
def test_a_small_run_is_correct(name):
    result, outcome = run_small(name)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("seed", [11, 2**33 + 5])
def test_md_witnesses_the_program_fault(seed):
    """The potential as published (``use_canonize`` false): the program's
    MD builds canonised graphs all the same, and the reference's graph
    differs from the one the window's first chunk ran on."""
    result, _outcome = run_small("ff_md_si512", seed=seed, canonize=False)
    assert result["checks"]["graph_edges_differ"]["value"] > 0
    assert result["correct"] is False
