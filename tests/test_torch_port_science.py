"""Science pins of the committed envelope-weighted Si potential, through
the port on the CPU.

The pins of ``tests/test_envelope_potential.py`` with its bounds, through
``alignn_tpu_torch.ff.calculator.Calculator(path="docs/mlearn_r5/
Si_envelope", device="cpu")`` at full width (4+4 layers, 256 hidden,
radius 4.5 A) and the port's relax, tasks and phonons modules:
a0 5.480 +- 0.01 A after FIRE with the cell, B 88.6 +- 8 GPa from the E-V
curve, Gamma phonons of the 2-atom cell in a 2x2x2 supercell (delta
0.02, through the Verlet skin reuse) with optical 14.9 +- 1.5 THz and
acoustic below 0.2, and a vacancy formation energy in 1.5-4.5 eV.  One
module-scoped Calculator; the k-NN potential's pins are in
``tests/test_torch_port_science_knn.py``.
"""

import os

import numpy as np
import pytest

MODEL_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "mlearn_r5", "Si_envelope")
DIAMOND = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                    [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                    [0.5, 0.5, 0], [0.75, 0.75, 0.25]])



@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads while this module runs: the suite runs its
    files in parallel workers, whose default thread counts would
    oversubscribe the host's cores."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def calc():
    from alignn_tpu_torch.ff.calculator import Calculator

    return Calculator(path=MODEL_DIR, device="cpu")


def _diamond(a):
    from alignn_tpu_torch.chem.atoms import Atoms

    return Atoms(lattice_mat=np.eye(3) * a, frac_coords=DIAMOND,
                 elements=["Si"] * 8)


def _primitive(a0):
    from alignn_tpu_torch.chem.atoms import Atoms

    lat = np.array([[0, a0 / 2, a0 / 2], [a0 / 2, 0, a0 / 2],
                    [a0 / 2, a0 / 2, 0]])
    return Atoms(lattice_mat=lat,
                 frac_coords=np.array([[0.0, 0.0, 0.0], [0.25, 0.25, 0.25]]),
                 elements=["Si", "Si"])


@pytest.fixture(scope="module")
def relaxed(calc):
    from alignn_tpu_torch.ff.relax import fire_relax

    return fire_relax(calc, _diamond(5.43), fmax=0.01, steps=200,
                      optimize_lattice=True)


def test_lattice_constant(relaxed):
    rel, _e_rel, steps = relaxed
    a0 = float(np.cbrt(abs(np.linalg.det(rel.lattice_mat))))
    assert a0 == pytest.approx(5.480, abs=0.01)
    assert abs(a0 - 5.469) / 5.469 < 0.01
    assert steps < 200


def test_bulk_modulus_matches_pbe(calc, relaxed):
    from alignn_tpu_torch.ff.tasks import ev_curve

    ev = ev_curve(calc, relaxed[0], relax_first=False,
                  dx=np.arange(-0.02, 0.0201, 0.005))
    eos = ev["eos"]
    assert eos["residual"] < 5e-3
    assert eos["B_GPa"] == pytest.approx(88.6, abs=8.0)
    assert 2.0 < eos["Bp"] < 6.0
    bm = ev["eos_birch_murnaghan"]
    assert bm["B_GPa"] == pytest.approx(eos["B_GPa"], abs=5.0)


def test_gamma_phonons_with_skin_reuse(calc, relaxed):
    from alignn_tpu_torch.ff.phonons import (force_constants,
                                             phonon_frequencies)

    a0 = float(np.cbrt(abs(np.linalg.det(relaxed[0].lattice_mat))))
    fcdata = force_constants(calc, _primitive(a0), supercell=(2, 2, 2),
                             delta=0.02)
    f = phonon_frequencies(fcdata, np.zeros(3))
    assert np.abs(f[:3]).max() < 0.2
    assert np.ptp(f[3:]) < 0.3
    assert f[3:].mean() == pytest.approx(14.9, abs=1.5)


def test_vacancy_formation_positive_and_sane(calc, relaxed):
    from alignn_tpu_torch.chem.atoms import Atoms

    sc = relaxed[0].make_supercell((2, 2, 2))
    e_bulk = calc.get_potential_energy(sc)
    vac = Atoms(lattice_mat=sc.lattice_mat,
                frac_coords=np.delete(sc.frac_coords, 0, axis=0),
                elements=["Si"] * (sc.num_atoms - 1))
    ef = calc.get_potential_energy(vac) - e_bulk + e_bulk / sc.num_atoms
    assert 1.5 < ef < 4.5, ef
