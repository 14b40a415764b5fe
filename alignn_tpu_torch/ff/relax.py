"""Structure relaxation: FIRE, L-BFGS and MDMin + unit-cell filter.

Counterpart of ``alignn_tpu/ff/relax.py``, numpy over any calculator with
a ``calculate(atoms)`` method (the port's :class:`~alignn_tpu_torch.ff.
calculator.Calculator`).

Framework-owned replacement for the ASE optimizers the reference drives
in `ForceField.optimize_atoms` (`alignn/ff/ff.py:373-417`, default FIRE,
optional `ExpCellFilter` lattice relaxation).  FIRE (Bitzek et al., PRL
97, 170201 (2006)) with ASE-default parameters; cell DOF via ASE's
UnitCellFilter formulation (deformation gradient scaled by a cell
factor, generalized cell force = virial / cell_factor).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from alignn_tpu_torch.chem.atoms import Atoms


@dataclass
class FireParams:
    dt: float = 0.1
    dtmax: float = 1.0
    nmin: int = 5
    finc: float = 1.1
    fdec: float = 0.5
    astart: float = 0.1
    fa: float = 0.99
    maxstep: float = 0.2


class _DofSystem:
    """[atom positions | deformation gradient] DOF (UnitCellFilter)."""

    def __init__(self, calc, atoms: Atoms, optimize_lattice: bool,
                 scalar_pressure: float):
        self.calc = calc
        self.optimize_lattice = optimize_lattice
        self.pressure = scalar_pressure
        self.cell0 = atoms.lattice_mat.copy()
        self.defgrad = np.eye(3)
        self.frac = atoms.frac_coords.copy()
        self.elements = list(atoms.elements)
        self.n = atoms.num_atoms
        self.cell_factor = float(max(self.n, 1))

    def atoms(self) -> Atoms:
        cell = self.defgrad @ self.cell0
        return Atoms(lattice_mat=cell, frac_coords=self.frac,
                     elements=self.elements)

    def energy_and_forces(self):
        a = self.atoms()
        res = self.calc.calculate(a)
        f_at = res["forces"]
        if not self.optimize_lattice:
            return res["energy"], f_at, a
        stress = res["stress_3x3"] + self.pressure * np.eye(3)
        virial = -a.volume * stress  # eV, generalized force on defgrad
        f_cell = virial / self.cell_factor
        return res["energy"], np.concatenate([f_at, f_cell], axis=0), a

    def displace(self, dr: np.ndarray):
        a = self.atoms()
        cart = a.cart_coords + dr[: self.n]
        if self.optimize_lattice:
            self.defgrad = self.defgrad + dr[self.n:] / self.cell_factor
        cell = self.defgrad @ self.cell0
        self.frac = cart @ np.linalg.inv(cell)


def _final_state(sys, steps: int, trajectory, logger):
    """Steps exhausted: evaluate, LOG, and return the final displaced
    structure — the returned atoms/energy must match the trajectory's
    last frame."""
    energy, forces, a = sys.energy_and_forces()
    fnorm = float(np.sqrt((forces ** 2).sum(axis=1).max()))
    if logger is not None:
        logger(steps, energy, fnorm)
    if trajectory is not None:
        trajectory.append({"energy": float(energy), "fmax": fnorm,
                           "atoms": a.to_dict()})
    return a, float(energy), steps


def fire_relax(calc, atoms: Atoms, fmax: float = 0.05, steps: int = 200,
               optimize_lattice: bool = False,
               scalar_pressure: float = 0.0,
               params: Optional[FireParams] = None,
               trajectory: Optional[list] = None,
               logger=None) -> Tuple[Atoms, float, int]:
    """Relax `atoms` until max |F| < fmax; returns (atoms, energy, steps).

    With `optimize_lattice`, positions and the cell are co-optimized
    (reference ExpCellFilter path, ff/ff.py:400-401).
    """
    p = params or FireParams()
    sys = _DofSystem(calc, atoms, optimize_lattice, scalar_pressure)
    ndof = sys.n + (3 if optimize_lattice else 0)
    v = np.zeros((ndof, 3))
    dt = p.dt
    alpha = p.astart
    n_pos = 0
    energy = np.inf

    for it in range(steps):
        energy, forces, a = sys.energy_and_forces()
        fnorm = float(np.sqrt((forces ** 2).sum(axis=1).max()))
        if logger is not None:
            logger(it, energy, fnorm)
        if trajectory is not None:
            trajectory.append({"energy": float(energy), "fmax": fnorm,
                               "atoms": a.to_dict()})
        if fnorm < fmax:
            return a, float(energy), it
        # ASE FIRE ordering: the power/adjustment block is SKIPPED on
        # the first step (v is None there — v=0 would otherwise take
        # the downhill branch and halve dt before any motion), and the
        # Nsteps>Nmin check precedes the increment
        if it > 0:
            power = float((forces * v).sum())
            if power > 0:
                vnorm = np.linalg.norm(v)
                fn = max(np.linalg.norm(forces), 1e-12)
                v = (1 - alpha) * v + alpha * forces * (vnorm / fn)
                if n_pos > p.nmin:
                    dt = min(dt * p.finc, p.dtmax)
                    alpha *= p.fa
                n_pos += 1
            else:
                v[:] = 0.0
                dt *= p.fdec
                alpha = p.astart
                n_pos = 0
        v = v + dt * forces
        dr = dt * v
        # ASE clips by the GLOBAL |dr| norm, not the largest per-atom
        # step
        normdr = float(np.sqrt((dr ** 2).sum()))
        if normdr > p.maxstep:
            dr = dr * (p.maxstep / normdr)
        sys.displace(dr)
    return _final_state(sys, steps, trajectory, logger)


def lbfgs_relax(calc, atoms: Atoms, fmax: float = 0.05, steps: int = 200,
                optimize_lattice: bool = False,
                scalar_pressure: float = 0.0,
                memory: int = 25, maxstep: float = 0.2,
                alpha: float = 70.0,
                trajectory: Optional[list] = None,
                logger=None) -> Tuple[Atoms, float, int]:
    """L-BFGS relaxation (ASE LBFGS semantics: H0 = 1/alpha, no line
    search, per-step displacement clipped to `maxstep`).

    Shares the UnitCellFilter DOF system with FIRE so
    `optimize_lattice` co-relaxes the cell.
    """
    sys = _DofSystem(calc, atoms, optimize_lattice, scalar_pressure)
    s_list, y_list, rho_list = [], [], []
    prev_g = None
    prev_dr = None
    energy = np.inf

    for it in range(steps):
        energy, forces, a = sys.energy_and_forces()
        fnorm = float(np.sqrt((forces ** 2).sum(axis=1).max()))
        if logger is not None:
            logger(it, energy, fnorm)
        if trajectory is not None:
            trajectory.append({"energy": float(energy), "fmax": fnorm,
                               "atoms": a.to_dict()})
        if fnorm < fmax:
            return a, float(energy), it

        g = -forces.reshape(-1)  # gradient
        if prev_g is not None:
            s = prev_dr.reshape(-1)  # x_k - x_{k-1}
            y = g - prev_g
            ys = float(y @ s)
            if ys > 1e-10:
                s_list.append(s)
                y_list.append(y)
                rho_list.append(1.0 / ys)
                if len(s_list) > memory:
                    s_list.pop(0)
                    y_list.pop(0)
                    rho_list.pop(0)

        # two-loop recursion
        q = g.copy()
        alphas = []
        for s, y, rho in zip(reversed(s_list), reversed(y_list),
                             reversed(rho_list)):
            a_i = rho * (s @ q)
            alphas.append(a_i)
            q -= a_i * y
        q *= 1.0 / alpha  # H0 = 1/alpha * I (ASE default alpha=70)
        for (s, y, rho), a_i in zip(zip(s_list, y_list, rho_list),
                                    reversed(alphas)):
            b_i = rho * (y @ q)
            q += (a_i - b_i) * s
        dr = (-q).reshape(-1, 3)
        maxd = float(np.sqrt((dr ** 2).sum(axis=1).max()))
        if maxd > maxstep:
            dr = dr * (maxstep / max(maxd, 1e-12))

        sys.displace(dr)
        prev_g = g
        prev_dr = dr
    return _final_state(sys, steps, trajectory, logger)


def mdmin_relax(calc, atoms: Atoms, fmax: float = 0.05, steps: int = 200,
                optimize_lattice: bool = False,
                scalar_pressure: float = 0.0,
                dt: float = 0.2, maxstep: float = 0.2,
                trajectory: Optional[list] = None,
                logger=None) -> Tuple[Atoms, float, int]:
    """MDMin (ASE semantics): velocity Verlet with the velocity
    projected onto the force direction, zeroed when anti-parallel."""
    sys = _DofSystem(calc, atoms, optimize_lattice, scalar_pressure)
    ndof = sys.n + (3 if optimize_lattice else 0)
    v = np.zeros((ndof, 3))
    energy = np.inf
    for it in range(steps):
        energy, forces, a = sys.energy_and_forces()
        fnorm = float(np.sqrt((forces ** 2).sum(axis=1).max()))
        if logger is not None:
            logger(it, energy, fnorm)
        if trajectory is not None:
            trajectory.append({"energy": float(energy), "fmax": fnorm,
                               "atoms": a.to_dict()})
        if fnorm < fmax:
            return a, float(energy), it
        # ASE MDMin splitting: half-kick, project/zero, half-kick (the
        # projection test is SKIPPED on the first step where v is None)
        if it > 0:
            v = v + 0.5 * dt * forces
            power = float((v * forces).sum())
            if power > 0:
                v = forces * power / max(float((forces ** 2).sum()),
                                         1e-12)
            else:
                v[:] = 0.0
        v = v + 0.5 * dt * forces
        dr = dt * v
        maxd = float(np.sqrt((dr ** 2).sum(axis=1).max()))
        if maxd > maxstep:
            dr = dr * (maxstep / max(maxd, 1e-12))
        sys.displace(dr)
    return _final_state(sys, steps, trajectory, logger)


OPTIMIZERS = {"fire": fire_relax, "lbfgs": lbfgs_relax,
              "mdmin": mdmin_relax}


def relax(calc, atoms: Atoms, optimizer: str = "fire", **kwargs):
    """Dispatch by optimizer name (reference ff.py:373-417 interface)."""
    try:
        fn = OPTIMIZERS[optimizer.lower()]
    except KeyError:
        raise ValueError(
            f"unknown optimizer {optimizer!r}; have {sorted(OPTIMIZERS)}")
    return fn(calc, atoms, **kwargs)
