"""Molecular dynamics: NVE / NVT (Langevin, Berendsen) / NPT (Berendsen).

Counterpart of ``alignn_tpu/ff/md.py``: the host loop over a calculator's
``calculate`` calls, with numpy's RNG, so that the same seed gives the
JAX package's trajectory.

Framework-owned replacement for the ASE dynamics the reference drives in
`ForceField` (`alignn/ff/ff.py:419-617`: VelocityVerlet NVE, Langevin /
Andersen / Berendsen NVT, Berendsen / Nose-Hoover NPT), with the same
task names exposed by the FF CLI (reference run_alignn_ff.py:100-257).

Units: eV / Angstrom / amu; time input in fs.  Internal time unit
t0 = sqrt(amu A^2 / eV) = 10.1805 fs (ASE convention: units.fs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from alignn_tpu_torch.chem.atoms import Atoms, atomic_masses

FS = 1.0 / 10.180505  # fs -> internal time units (ASE units.fs)
KB = 8.617333262e-5  # eV / K


@dataclass
class MDState:
    atoms: Atoms
    velocities: np.ndarray  # [N, 3] Angstrom / t0
    masses: np.ndarray      # [N] amu

    @property
    def kinetic_energy(self) -> float:
        return float(0.5 * (self.masses[:, None]
                            * self.velocities ** 2).sum())

    @property
    def temperature(self) -> float:
        n = self.atoms.num_atoms
        return 2.0 * self.kinetic_energy / (3.0 * n * KB)


def maxwell_boltzmann_velocities(atoms: Atoms, temperature_K: float,
                                 seed: int = 0) -> np.ndarray:
    """Initial velocities at `temperature_K`, COM-motion removed."""
    rng = np.random.default_rng(seed)
    m = atomic_masses()[atoms.atomic_numbers]
    sigma = np.sqrt(KB * temperature_K / m)[:, None]
    v = rng.standard_normal((atoms.num_atoms, 3)) * sigma
    v -= (m[:, None] * v).sum(axis=0) / m.sum()
    return v


@dataclass
class MDLog:
    """Per-interval MD observables (reference MDLogger attach,
    ff/ff.py:311-322)."""

    rows: List[Dict[str, float]] = field(default_factory=list)

    def append(self, step, time_fs, epot, ekin, temp):
        self.rows.append({"step": step, "time_fs": time_fs,
                          "epot": epot, "ekin": ekin,
                          "etot": epot + ekin, "T": temp})


def run_md(calc, atoms: Atoms,
           ensemble: str = "nve",
           steps: int = 100,
           timestep_fs: float = 1.0,
           temperature_K: float = 300.0,
           pressure_GPa: float = 0.0,
           taut_fs: Optional[float] = None,
           taup_fs: Optional[float] = None,
           friction: float = 0.02,
           compressibility_GPa: float = 5e-3,
           initial_temperature_K: Optional[float] = None,
           seed: int = 0,
           log_interval: int = 10,
           trajectory: Optional[list] = None,
           callback: Optional[Callable] = None):
    """Run MD; returns (final MDState, MDLog).

    ensembles: nve | nvt_langevin | nvt_andersen | nvt_berendsen |
    nvt_nose_hoover | npt_berendsen | npt_nose_hoover (reference task
    names, run_alignn_ff.py:100-257 driving ASE VelocityVerlet /
    Langevin / Andersen / NVTBerendsen / NPTBerendsen / NPT).

    Andersen and Nose-Hoover are integrators of their own:
    - Andersen: velocity Verlet + per-atom Maxwell-Boltzmann collision
      resampling with probability `friction * dt` per step (ASE
      Andersen(andersen_prob) semantics).
    - Nose-Hoover NVT: single-thermostat NH with Q = 3 N kB T tau_t^2
      (ASE ttime convention); the extended Hamiltonian
      E + KE + Q xi^2 / 2 + 3 N kB T eta is conserved
      (tests/test_ff.py::test_nose_hoover_conserves_extended_hamiltonian).
    - npt_nose_hoover: NH thermostat + isotropic MTK-style cell
      barostat on the model stress.
    """
    ensemble = ensemble.lower()
    if ensemble == "npt":
        ensemble = "npt_berendsen"
    known = ("nve", "nvt_langevin", "nvt_andersen", "nvt_berendsen",
             "nvt_nose_hoover", "npt_berendsen", "npt_nose_hoover")
    if ensemble not in known:
        raise ValueError(f"unknown ensemble {ensemble!r}; expected one "
                         f"of {known} (a typo would otherwise silently "
                         f"run unthermostatted NVE)")
    dt = timestep_fs * FS
    taut = (taut_fs or 100.0 * timestep_fs) * FS
    taup = (taup_fs or 1000.0 * timestep_fs) * FS
    rng = np.random.default_rng(seed + 1)

    m = atomic_masses()[atoms.atomic_numbers].astype(np.float64)
    t_init = initial_temperature_K if initial_temperature_K is not None \
        else temperature_K
    state = MDState(
        atoms=atoms,
        velocities=maxwell_boltzmann_velocities(atoms, t_init, seed),
        masses=m)
    log = MDLog()

    res = calc.calculate(state.atoms)
    forces = res["forces"]
    epot = res["energy"]

    n_atoms = atoms.num_atoms
    g_dof = 3.0 * n_atoms
    nh = ensemble in ("nvt_nose_hoover", "npt_nose_hoover")
    # NH thermostat mass Q = g kB T ttime^2 (ASE NPT ttime convention)
    q_nh = g_dof * KB * max(temperature_K, 1e-12) * taut ** 2
    xi = 0.0       # thermostat velocity
    eta = 0.0      # integral of xi (for the conserved quantity)
    # isotropic barostat mass (MTK-style), in the same unit system
    w_bar = (g_dof + 3.0) * KB * max(temperature_K, 1e-12) * taup ** 2
    p_eps = 0.0

    for step in range(steps):
        v = state.velocities

        # barostats act at step START on the previous evaluation's
        # stress (ASE NPTBerendsen.scale_positions_and_cell ordering) --
        # one force evaluation per step, not two
        if ensemble == "npt_berendsen":
            from alignn_tpu_torch.nn.models import EV_A3_TO_GPA

            stress = res["stress_3x3"] * EV_A3_TO_GPA  # eV/A^3 -> GPa
            p_inst = float(-np.trace(stress) / 3.0)
            base = 1.0 - (dt / taup) * compressibility_GPa \
                * (pressure_GPa - p_inst)
            # clamp BEFORE the cube root: a tight barostat far from
            # equilibrium can drive the base negative (complex mu)
            mu = float(np.clip(max(base, 1e-6) ** (1.0 / 3.0),
                               0.99, 1.01))
            state = MDState(atoms=Atoms(
                lattice_mat=state.atoms.lattice_mat * mu,
                frac_coords=state.atoms.frac_coords,
                elements=state.atoms.elements),
                velocities=v, masses=m)
        elif ensemble == "npt_nose_hoover":
            # isotropic MTK-style barostat: d(p_eps)/dt =
            # 3V (P_int - P_ext) + kinetic correction; cell scales by
            # exp(dt p_eps / W).  (Reference drives ASE's NPT class,
            # ff/ff.py:556-575 -- same physics, simplified isotropic.)
            p_ext = pressure_GPa / 160.21766208  # GPa -> eV/A^3
            vol = float(state.atoms.volume)
            p_int = float(-np.trace(res["stress_3x3"]) / 3.0)
            ke = float(0.5 * (m[:, None] * v ** 2).sum())
            dp = 3.0 * vol * (p_int - p_ext) + 2.0 * ke * 3.0 / g_dof
            p_eps = p_eps + dt * dp
            mu = float(np.exp(dt * p_eps / w_bar))
            mu = min(max(mu, 0.99), 1.01)  # stability clamp per step
            state = MDState(atoms=Atoms(
                lattice_mat=state.atoms.lattice_mat * mu,
                frac_coords=state.atoms.frac_coords,
                elements=state.atoms.elements),
                velocities=v, masses=m)

        a_t = forces / m[:, None]

        if ensemble == "nvt_langevin":
            # ASE-style Langevin (BAOAB-ish splitting, sufficient for FF
            # sampling parity): deterministic VV + OU collision kick
            gamma = friction / FS  # friction given in 1/fs
            c1 = np.exp(-gamma * dt)
            sigma = np.sqrt(KB * temperature_K / m)[:, None] * np.sqrt(
                1 - c1 ** 2)
            v = c1 * v + sigma * rng.standard_normal(v.shape)

        if nh:
            # Nose-Hoover velocity Verlet (Frenkel & Smit splitting):
            # half-kick includes the thermostat friction term
            v_half = v + 0.5 * dt * (a_t - xi * v)
        else:
            v_half = v + 0.5 * dt * a_t
        cart = state.atoms.cart_coords + dt * v_half
        new_atoms = state.atoms.with_positions(cart_coords=cart)

        if nh:
            ke_half = float(0.5 * (m[:, None] * v_half ** 2).sum())
            xi = xi + dt / q_nh * (2.0 * ke_half
                                   - g_dof * KB * temperature_K)
            eta = eta + dt * xi

        res = calc.calculate(new_atoms)
        forces = res["forces"]
        epot = res["energy"]
        if nh:
            v = (v_half + 0.5 * dt * forces / m[:, None]) \
                / (1.0 + 0.5 * dt * xi)
        else:
            v = v_half + 0.5 * dt * (forces / m[:, None])

        if ensemble == "nvt_andersen":
            # ASE Andersen: each atom suffers a heat-bath collision with
            # probability `friction * dt` per step (friction in 1/fs),
            # its velocity resampled from the Maxwell-Boltzmann dist.
            prob = min(friction * timestep_fs, 1.0)
            hit = rng.random(n_atoms) < prob
            if hit.any():
                sigma = np.sqrt(KB * temperature_K / m[hit])[:, None]
                v = v.copy()
                v[hit] = sigma * rng.standard_normal((int(hit.sum()), 3))
                # ASE Andersen fixcm parity: collisions inject net
                # momentum; restore zero COM momentum so it cannot
                # random-walk (and bias the measured temperature)
                v = v - (m[:, None] * v).sum(axis=0) / m.sum()

        if ensemble in ("nvt_berendsen", "npt_berendsen"):
            state_T = 2.0 * float(
                0.5 * (m[:, None] * v ** 2).sum()) / (
                3.0 * new_atoms.num_atoms * KB)
            lam = np.sqrt(max(
                1.0 + (dt / taut) * (temperature_K / max(state_T, 1e-12)
                                     - 1.0), 1e-12))
            v = v * lam

        state = MDState(atoms=new_atoms, velocities=v, masses=m)
        if step % log_interval == 0 or step == steps - 1:
            row_extra = {}
            if nh:
                # extended Hamiltonian (conserved for nvt_nose_hoover)
                row_extra["h_ext"] = (
                    float(epot) + state.kinetic_energy
                    + 0.5 * q_nh * xi ** 2
                    + g_dof * KB * temperature_K * eta)
            # the state has been integrated (step+1) times -- log the
            # matching time (ASE MDLogger: time = nsteps_done * dt)
            log.append(step + 1, (step + 1) * timestep_fs, float(epot),
                       state.kinetic_energy, state.temperature)
            if row_extra:
                log.rows[-1].update(row_extra)
            if trajectory is not None:
                trajectory.append(new_atoms.to_dict())
        if callback is not None:
            callback(step, state, epot, forces)
    return state, log
