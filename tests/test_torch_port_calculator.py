"""The slice end to end: the port's Calculator on the committed Si
potential against alignn_tpu's Calculator, on the CPU.

Both run f32 over 4+4 layers at full width with sums in another order
(and the JAX side may take its C++ neighbour search, which orders tied
edges differently), so the bounds are looser than the small model's.
"""

import os

import numpy as np
import pytest
from torch_port_threads import _two_threads  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SI_DIR = os.path.join(REPO, "docs", "mlearn_r4", "Si")
DIAMOND = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                    [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                    [0.5, 0.5, 0], [0.75, 0.75, 0.25]])


def _rattled(seed=0):
    rng = np.random.default_rng(seed)
    lat = np.eye(3) * 5.43
    cart = DIAMOND @ lat + rng.normal(0.0, 0.05, (8, 3))
    return lat, cart @ np.linalg.inv(lat)


@pytest.fixture(scope="module")
def results():
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.ff.calculator import Calculator as JCalculator
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator

    lat, frac = _rattled()
    jr = JCalculator(path=SI_DIR).calculate(
        JAtoms(lattice_mat=lat, frac_coords=frac, elements=["Si"] * 8))
    calc = Calculator(path=SI_DIR, device="cpu")
    tr = calc.calculate(
        Atoms(lattice_mat=lat, frac_coords=frac, elements=["Si"] * 8))
    return jr, tr, calc


def test_energy_per_atom(results):
    jr, tr, _calc = results
    assert abs(tr["energy"] - jr["energy"]) / 8 < 1e-4


def test_forces(results):
    jr, tr, _calc = results
    assert tr["forces"].shape == (8, 3)
    np.testing.assert_allclose(tr["forces"], jr["forces"], rtol=0,
                               atol=5e-4)
    assert np.abs(tr["forces"]).max() > 0.05     # the rattle is felt
    assert np.abs(tr["forces"].sum(axis=0)).max() < 1e-4


def test_stress(results):
    jr, tr, calc = results
    np.testing.assert_allclose(tr["stress"], jr["stress"], rtol=0,
                               atol=1e-5)
    # the stresswise_weight 0 -> 0.1 patch makes the stress non-zero
    assert calc.model.cfg.stresswise_weight == 0.1
    assert np.abs(tr["stress"]).max() > 1e-3


def test_bucket_is_reused_and_grown(results):
    from alignn_tpu_torch.chem.atoms import Atoms

    _jr, _tr, calc = results
    lat, frac = _rattled(seed=1)
    spec = calc._spec
    calc.calculate(Atoms(lattice_mat=lat, frac_coords=frac,
                         elements=["Si"] * 8))
    assert calc._spec is spec
    big = Atoms(lattice_mat=lat, frac_coords=DIAMOND,
                elements=["Si"] * 8).make_supercell([1, 1, 2])
    res = calc.calculate(big)
    assert calc._spec.n_nodes > spec.n_nodes or \
        calc._spec.n_edges > spec.n_edges
    assert res["forces"].shape == (16, 3)


def test_radius_skin_reuse_gives_the_fresh_graph():
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator
    from alignn_tpu_torch.graph.build import build_graph
    from alignn_tpu_torch.nn.models import (ALIGNNAtomWise,
                                            ALIGNNAtomWiseConfig)

    model = ALIGNNAtomWise(ALIGNNAtomWiseConfig(
        alignn_layers=1, gcn_layers=1, hidden_features=16,
        embedding_features=8))
    calc = Calculator(model=model, device="cpu", skin=0.4,
                      config={"neighbor_strategy": "radius_graph",
                              "cutoff": 4.0})
    lat = np.eye(3) * 5.43
    rng = np.random.default_rng(2)
    frac = DIAMOND + 0.05   # away from the cell boundary: no wrap
    for step in range(3):
        atoms = Atoms(lattice_mat=lat, frac_coords=frac,
                      elements=["Si"] * 8)
        g = calc.graph_for(atoms)
        fresh = build_graph(atoms, neighbor_strategy="radius_graph",
                            cutoff=4.0)
        key = lambda gr: sorted(zip(gr.src, gr.dst,  # noqa: E731
                                    map(tuple, gr.images)))
        assert key(g) == key(fresh), step
        assert g.num_lg_edges == fresh.num_lg_edges
        if step:
            assert calc._nl_graph is cached   # reused, not rebuilt
        cached = calc._nl_graph
        frac = frac + rng.normal(0.0, 0.005, frac.shape)  # < skin / 2
