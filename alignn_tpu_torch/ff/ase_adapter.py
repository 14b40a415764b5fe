"""ASE ``Calculator`` adapter — drop-in for the reference calculator.

Counterpart of ``alignn_tpu/ff/ase_adapter.py`` over the port's
Calculator.  The reference's ``AlignnAtomwiseCalculator`` subclasses
``ase.calculators.calculator.Calculator`` (`alignn/ff/calculators.py:
170-372`).  ASE is not a dependency of this package, so the core engine
is the framework-owned :class:`alignn_tpu_torch.ff.calculator.Calculator`; this
module provides the actual ASE subclass for environments where ASE IS
installed, so reference users can switch with one import:

    from alignn_tpu_torch.ff.ase_adapter import AlignnAtomWiseCalculator
    atoms.calc = AlignnAtomWiseCalculator(path=model_dir)
    atoms.get_potential_energy(); atoms.get_forces(); atoms.get_stress()

All the core knobs (`intensive`, `force_multiplier`,
`force_mult_natoms`, `stress_wt`, bucket reuse, Verlet-skin reuse,
dense/sparse auto-routing, `device`) pass through.  Without ASE, importing
this module succeeds; instantiating the class raises ImportError with
the install hint (tested with a forged ASE in tests/test_torch_port_ff.py).
"""

from __future__ import annotations

import numpy as np

try:
    from ase.calculators.calculator import Calculator as _ASEBase
    from ase.calculators.calculator import all_changes as _all_changes

    HAVE_ASE = True
except ImportError:  # pragma: no cover — exercised via the forged ASE
    HAVE_ASE = False
    _all_changes = ["positions", "numbers", "cell", "pbc"]

    class _ASEBase:  # minimal stand-in so the subclass can be DEFINED
        def __init__(self, **kwargs):
            self.results = {}

        def calculate(self, atoms=None, properties=None,
                      system_changes=None):
            if atoms is not None:
                self.atoms = atoms


class AlignnAtomWiseCalculator(_ASEBase):
    """ASE-facing wrapper around the framework Calculator engine.

    Parameters mirror the reference (ff/calculators.py:170-208) plus
    this framework's execution knobs; extra kwargs go to ASE's base.
    """

    implemented_properties = ["energy", "free_energy", "forces",
                              "stress"]

    def __init__(self, path=None, model=None,
                 config=None, intensive: bool = True,
                 force_multiplier: float = 1.0,
                 force_mult_natoms: bool = False,
                 stress_wt: float = 1.0, bucket_slack: float = 1.3,
                 skin: float = 0.3, dense=None, device=None,
                 **ase_kwargs):
        if not HAVE_ASE:
            raise ImportError(
                "ase is not installed; `pip install ase` for the ASE "
                "adapter, or use alignn_tpu_torch.ff.calculator.Calculator "
                "(the framework-native engine) directly")
        super().__init__(**ase_kwargs)
        from alignn_tpu_torch.ff.calculator import Calculator

        self._core = Calculator(
            path=path, model=model, config=config,
            intensive=intensive, force_multiplier=force_multiplier,
            force_mult_natoms=force_mult_natoms, stress_wt=stress_wt,
            bucket_slack=bucket_slack, skin=skin, dense=dense,
            device=device)

    def calculate(self, atoms=None, properties=("energy",),
                  system_changes=_all_changes):
        super().calculate(atoms, properties, system_changes)
        from alignn_tpu_torch.chem.atoms import Atoms

        core_atoms = Atoms(
            lattice_mat=np.asarray(atoms.cell),
            frac_coords=np.asarray(atoms.get_scaled_positions()),
            elements=list(atoms.get_chemical_symbols()))
        out = self._core.calculate(core_atoms)
        self.results = {
            "energy": float(out["energy"]),
            "free_energy": float(out["energy"]),
            "forces": np.asarray(out["forces"]),
            "stress": np.asarray(out["stress"]),  # Voigt-6, eV/A^3
        }
        return self.results
