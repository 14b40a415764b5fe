"""The committed radius-graph and envelope-weighted potentials: the port's
Calculator against alignn_tpu's, on the CPU.

Five potentials at full width (4+4/256, Cu_envelope 2+4/256), each on an
8-atom cell of its element rattled by 0.05 A (numpy seed 0): the three
envelope-weighted potentials of round 5 (``docs/mlearn_r5/{Si,Ge,Cu}_
envelope``, radius 4.5 A, weights from the smooth envelope at the graph
cutoff), the radius potential without weights (``Si_radius_full``) and the
k-NN ``docs/mlearn_r4/Ge``.  Both sides build their graphs with the numpy
neighbour search, so they sum the same edges in the same order; they
still differ in f32 rounding, hence the serving limits: energy 1e-4
eV/atom, forces 5e-4 eV/A, stress 1e-5 eV/A^3, and |sum F| <= 1e-4.
"""

import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIAMOND = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                    [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                    [0.5, 0.5, 0], [0.75, 0.75, 0.25]])
FCC = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
POTENTIALS = {  # directory: (element, lattice, fractional coordinates)
    "mlearn_r5/Si_envelope": ("Si", np.eye(3) * 5.43, DIAMOND),
    "mlearn_r5/Ge_envelope": ("Ge", np.eye(3) * 5.66, DIAMOND),
    "mlearn_r5/Cu_envelope": ("Cu", np.diag([7.22, 3.61, 3.61]),
                              np.concatenate([FCC * [0.5, 1, 1],
                                              FCC * [0.5, 1, 1]
                                              + [0.5, 0, 0]])),
    "mlearn_r5/Si_radius_full": ("Si", np.eye(3) * 5.43, DIAMOND),
    "mlearn_r4/Ge": ("Ge", np.eye(3) * 5.66, DIAMOND),
}
LIMITS = {"energy_per_atom": 1e-4, "forces": 5e-4, "stress": 1e-5,
          "sum_forces": 1e-4}


def _cell(lattice, frac):
    """The cell rattled by N(0, 0.05 A) per coordinate (seed 0)."""
    cart = frac @ lattice + np.random.default_rng(0).normal(
        0.0, 0.05, frac.shape)
    return cart @ np.linalg.inv(lattice)


@pytest.fixture(scope="module", params=sorted(POTENTIALS))
def results(request):
    """(JAX result, port result, port Calculator) of one potential."""
    import alignn_tpu.native
    import alignn_tpu_torch.native
    from alignn_tpu.chem.atoms import Atoms as JAtoms
    from alignn_tpu.ff.calculator import Calculator as JCalculator
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.calculator import Calculator

    element, lattice, frac = POTENTIALS[request.param]
    frac = _cell(lattice, frac)
    path = os.path.join(REPO, "docs", request.param)
    with pytest.MonkeyPatch.context() as mp:
        # a C++ cell list orders tied pairs otherwise than the numpy
        # search: both packages take the numpy search here
        for mod in (alignn_tpu.native, alignn_tpu_torch.native):
            mp.setattr(mod, "periodic_pairs_native", lambda *a, **k: None)
        jr = JCalculator(path=path).calculate(JAtoms(
            lattice_mat=lattice, frac_coords=frac,
            elements=[element] * len(frac)))
        calc = Calculator(path=path, device="cpu")
        tr = calc.calculate(Atoms(lattice_mat=lattice, frac_coords=frac,
                                  elements=[element] * len(frac)))
    return jr, tr, calc


def test_energy_per_atom(results):
    jr, tr, _calc = results
    n = len(tr["forces"])
    assert abs(tr["energy"] - jr["energy"]) / n < LIMITS["energy_per_atom"]


def test_forces(results):
    jr, tr, _calc = results
    assert tr["forces"].shape == (8, 3)
    np.testing.assert_allclose(tr["forces"], jr["forces"], rtol=0,
                               atol=LIMITS["forces"])
    assert np.abs(tr["forces"]).max() > 0.05     # the rattle is felt


def test_forces_sum_to_zero(results):
    _jr, tr, _calc = results
    assert np.abs(tr["forces"].sum(axis=0)).max() <= LIMITS["sum_forces"]


def test_stress(results):
    jr, tr, _calc = results
    np.testing.assert_allclose(tr["stress"], jr["stress"], rtol=0,
                               atol=LIMITS["stress"])
    assert np.abs(tr["stress"]).max() > 1e-3


def test_configuration_is_served_as_configured(results):
    """The envelope potentials run their soft weights (sparse layout,
    eps 1e-3), the others the plain gated aggregation."""
    _jr, _tr, calc = results
    cfg = calc.model.cfg
    assert calc._spec.dense_D == 0
    assert cfg.envelope_edge_weights == (cfg.envelope_cutoff > 0)
    assert calc.neighbor_strategy in ("radius_graph", "k-nearest")
