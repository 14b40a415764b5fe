"""Science pins of the committed k-NN Si potential, through the port on
the CPU.

The pins of ``tests/test_trained_potential.py`` with its bounds, through
``alignn_tpu_torch.ff.calculator.Calculator(path="docs/mlearn_r4/Si",
device="cpu")`` at full width (4+4 layers, 256 hidden, 12-NN within 8 A):
a0 5.510 +- 0.01 A and -5.414 +- 0.02 eV/atom after FIRE with the cell,
B in 45-110 GPa from the E-V curve, Gamma phonons of the 2-atom cell in
a 2x2x2 supercell (delta 0.02) with acoustic below 0.5 THz and a
triply degenerate optical branch in 12-17 THz, and the diamond energy of
the f32 training run (-5.3774 +- 2e-3 eV/atom).  One module-scoped
Calculator.
"""

import os

import numpy as np
import pytest

MODEL_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "mlearn_r4", "Si")
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


@pytest.fixture(scope="module")
def relaxed(calc):
    from alignn_tpu_torch.ff.relax import fire_relax

    return fire_relax(calc, _diamond(5.43), fmax=0.01, steps=200,
                      optimize_lattice=True)


def test_relaxed_lattice_constant(relaxed):
    rel, e_rel, steps = relaxed
    a0 = float(np.cbrt(abs(np.linalg.det(rel.lattice_mat))))
    assert a0 == pytest.approx(5.510, abs=0.01)
    assert abs(a0 - 5.469) / 5.469 < 0.02
    assert e_rel / 8 == pytest.approx(-5.414, abs=0.02)
    assert steps < 200


def test_bulk_modulus_from_eos(calc, relaxed):
    from alignn_tpu_torch.ff.tasks import ev_curve

    ev = ev_curve(calc, relaxed[0], relax_first=False,
                  dx=np.arange(-0.015, 0.0151, 0.005))
    eos = ev["eos"]
    assert eos["residual"] < 2e-3
    assert 45 < eos["B_GPa"] < 110


def test_gamma_phonons(calc, relaxed):
    from alignn_tpu_torch.chem.atoms import Atoms
    from alignn_tpu_torch.ff.phonons import (force_constants,
                                             phonon_frequencies)

    a0 = float(np.cbrt(abs(np.linalg.det(relaxed[0].lattice_mat))))
    lat = np.array([[0, a0 / 2, a0 / 2], [a0 / 2, 0, a0 / 2],
                    [a0 / 2, a0 / 2, 0]])
    prim = Atoms(lattice_mat=lat,
                 frac_coords=np.array([[0.0, 0.0, 0.0], [0.25, 0.25, 0.25]]),
                 elements=["Si", "Si"])
    fcdata = force_constants(calc, prim, supercell=(2, 2, 2), delta=0.02)
    f = phonon_frequencies(fcdata, np.zeros(3))
    assert np.abs(f[:3]).max() < 0.5
    assert f[3:].min() > 12.0 and f[3:].max() < 17.0
    assert np.ptp(f[3:]) < 0.5


def test_committed_energy_reproduces_f32_training(calc):
    e = calc.get_potential_energy(_diamond(5.43))
    assert e / 8 == pytest.approx(-5.3774, abs=2e-3)
