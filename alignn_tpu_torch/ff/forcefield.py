"""ForceField: one object tying calculator + dynamics + tasks.

Counterpart of ``alignn_tpu/ff/forcefield.py`` over the port's
:class:`~alignn_tpu_torch.ff.calculator.Calculator`, which runs on
``cuda`` unless ``device="cpu"`` is passed.  A model directory is
required: nothing is downloaded.  API-parity equivalent of reference
`ForceField` (`alignn/ff/ff.py:271-617`) with the same task vocabulary as
`run_alignn_ff.py`: unrelaxed_energy, optimize_atoms, NVE/NVT/NPT MD,
ev_curve, vacancy_formation, surface_energy, interface energy, phonons.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from alignn_tpu_torch.chem.atoms import Atoms, dumpjson
from alignn_tpu_torch.ff.calculator import Calculator
from alignn_tpu_torch.ff.md import run_md
from alignn_tpu_torch.ff.relax import relax as _relax
from alignn_tpu_torch.ff import tasks as _tasks
from alignn_tpu_torch.ff import phonons as _phonons


class ForceField:
    """Drive relaxation / MD / analysis with a trained model.

    Reference ff/ff.py:271-340 constructor semantics: structure +
    model path (+ logging directory).  `device` is the Calculator's
    (``cuda`` unless ``"cpu"`` is passed).
    """

    def __init__(self, atoms: Atoms, model_path: Optional[str] = None,
                 calculator: Optional[Calculator] = None,
                 logfile: str = "alignn_ff.log",
                 dirname: str = ".", stress_wt: float = 1.0,
                 device=None):
        if calculator is None and model_path is None:
            raise ValueError(
                "pass a model directory `model_path` or a `calculator` "
                "(the default FF model would need a download)")
        self.atoms = atoms
        self.dirname = dirname
        os.makedirs(dirname, exist_ok=True)
        self.logfile = os.path.join(dirname, logfile)
        self.calc = calculator or Calculator(path=model_path,
                                             stress_wt=stress_wt,
                                             device=device)

    def _log(self, msg: str):
        with open(self.logfile, "a") as f:
            f.write(msg + "\n")

    def unrelaxed_atoms(self) -> float:
        """Single-point energy (run_alignn_ff.py task unrelaxed_energy)."""
        e = self.calc.get_potential_energy(self.atoms)
        self._log(f"unrelaxed energy {e}")
        return e

    def optimize_atoms(self, fmax: float = 0.05, steps: int = 200,
                       optimize_lattice: bool = True,
                       optimizer: str = "FIRE",
                       trajectory: Optional[str] = "opt.traj.json"):
        """Relaxation (reference optimize_atoms, ff/ff.py:373-417).

        `optimizer`: "FIRE" (default, reference default), "LBFGS" or
        "MDMin".
        """
        traj: list = []
        atoms, energy, n = _relax(
            self.calc, self.atoms, optimizer=optimizer,
            fmax=fmax, steps=steps,
            optimize_lattice=optimize_lattice, trajectory=traj,
            logger=lambda i, e, f: self._log(
                f"{optimizer} step {i} E {e:.6f} fmax {f:.4f}"))
        if trajectory:
            dumpjson(traj, os.path.join(self.dirname, trajectory))
        self.atoms = atoms
        return atoms, energy

    # -- MD ensembles (reference ff/ff.py:419-617) --------------------------

    def run_nve_velocity_verlet(self, steps=100, timestep_fs=1.0,
                                initial_temperature_K=300.0, **kw):
        return self._md("nve", steps, timestep_fs,
                        initial_temperature_K=initial_temperature_K, **kw)

    def run_nvt_langevin(self, steps=100, timestep_fs=1.0,
                         temperature_K=300.0, **kw):
        return self._md("nvt_langevin", steps, timestep_fs,
                        temperature_K=temperature_K, **kw)

    def run_nvt_andersen(self, steps=100, timestep_fs=1.0,
                         temperature_K=300.0, **kw):
        return self._md("nvt_andersen", steps, timestep_fs,
                        temperature_K=temperature_K, **kw)

    def run_nvt_berendsen(self, steps=100, timestep_fs=1.0,
                          temperature_K=300.0, **kw):
        return self._md("nvt_berendsen", steps, timestep_fs,
                        temperature_K=temperature_K, **kw)

    def run_npt_berendsen(self, steps=100, timestep_fs=1.0,
                          temperature_K=300.0, pressure_GPa=0.0, **kw):
        return self._md("npt_berendsen", steps, timestep_fs,
                        temperature_K=temperature_K,
                        pressure_GPa=pressure_GPa, **kw)

    def run_nvt_nose_hoover(self, steps=100, timestep_fs=1.0,
                            temperature_K=300.0, **kw):
        return self._md("nvt_nose_hoover", steps, timestep_fs,
                        temperature_K=temperature_K, **kw)

    def run_npt_nose_hoover(self, steps=100, timestep_fs=1.0,
                            temperature_K=300.0, pressure_GPa=0.0, **kw):
        return self._md("npt_nose_hoover", steps, timestep_fs,
                        temperature_K=temperature_K,
                        pressure_GPa=pressure_GPa, **kw)

    def run_md_on_device(self, ensemble: str = "nve", steps: int = 1000,
                         timestep_fs: float = 1.0, chunk_steps: int = 50,
                         **kw):
        """On-device MD chunks (:mod:`alignn_tpu_torch.ff.md_jit`): each
        chunk's step captured once as a CUDA graph and replayed, one
        host fetch per chunk; on the Calculator's device."""
        from alignn_tpu_torch.ff.md_jit import run_md_jit

        atoms, log = run_md_jit(
            self.calc.model, self.atoms,
            steps=steps, timestep_fs=timestep_fs, ensemble=ensemble,
            cutoff=self.calc.cutoff,
            max_neighbors=self.calc.max_neighbors,
            neighbor_strategy=self.calc.neighbor_strategy,
            # inherit the calculator's featurization + layout — a model
            # trained on non-cgcnn features would otherwise get wrong
            # (or wrong-width) node features here
            atom_features=kw.pop("atom_features",
                                 self.calc.atom_features),
            dense=kw.pop("dense", self.calc.dense),
            chunk_steps=chunk_steps, device=kw.pop("device",
                                                   self.calc.device), **kw)
        for row in log.rows:
            self._log(json.dumps({"ensemble": f"{ensemble}_jit", **row}))
        self.atoms = atoms
        return atoms, log

    def _md(self, ensemble, steps, timestep_fs, **kw):
        traj: list = []
        state, log = run_md(self.calc, self.atoms, ensemble=ensemble,
                            steps=steps, timestep_fs=timestep_fs,
                            trajectory=traj, **kw)
        for row in log.rows:
            self._log(json.dumps({"ensemble": ensemble, **row}))
        dumpjson(traj, os.path.join(self.dirname, f"{ensemble}.traj.json"))
        self.atoms = state.atoms
        return state.atoms, log

    # -- analysis tasks -----------------------------------------------------

    def ev_curve(self, **kw) -> Dict:
        out = _tasks.ev_curve(self.calc, self.atoms, **kw)
        dumpjson({k: v for k, v in out.items() if k != "fcdata"},
                 os.path.join(self.dirname, "ev_curve.json"))
        return out

    def vacancy_formation(self, **kw):
        out = _tasks.vacancy_formation(self.calc, self.atoms, **kw)
        dumpjson(out, os.path.join(self.dirname, "vacancy.json"))
        return out

    def surface_energy(self, **kw):
        out = _tasks.surface_energy(self.calc, self.atoms, **kw)
        dumpjson(out, os.path.join(self.dirname, "surface.json"))
        return out

    def interface_energy(self, substrate: Atoms, **kw):
        out = _tasks.get_interface_energy(self.calc, self.atoms,
                                          substrate, **kw)
        dumpjson(out, os.path.join(self.dirname, "interface.json"))
        return out

    def phonons3(self, supercell=(2, 2, 2), export_fc3: bool = True,
                 **kw) -> Dict:
        """Third-order FC + thermal conductivity (reference phonons3,
        ff/ff.py:1271-1334 — see ff/phonons3.py for the owned-vs-modeled
        physics split).  Also writes ``fc3.hdf5`` in phono3py's compact
        layout so an exact RTA run needs only a phono3py install."""
        from alignn_tpu_torch.ff import phonons3 as _ph3

        out = _ph3.thermal_conductivity(self.calc, self.atoms,
                                        supercell=supercell, **kw)
        if export_fc3:
            fcdata = _ph3.third_order_fc(self.calc, self.atoms,
                                         supercell=supercell)
            out["fc3_path"] = _ph3.export_fc3(
                fcdata, os.path.join(self.dirname, "fc3.hdf5"),
                sc_atoms=self.atoms.make_supercell(supercell))
        dumpjson(out, os.path.join(self.dirname, "thermal_conductivity.json"))
        return out

    def phonons(self, supercell=(2, 2, 2), **kw) -> Dict:
        out = _phonons.phonon_band_structure(self.calc, self.atoms,
                                             supercell=supercell, **kw)
        if "fcdata" in out:
            # phonopy-readable fc2 alongside the bands (text format);
            # export BEFORE the json dump so phonon_bands.json carries
            # the path (phonons3 writes fc3_path the same way)
            out["force_constants_path"] = _phonons.export_force_constants(
                out["fcdata"],
                os.path.join(self.dirname, "FORCE_CONSTANTS"))
        dumpjson({k: v for k, v in out.items() if k != "fcdata"},
                 os.path.join(self.dirname, "phonon_bands.json"))
        return out
