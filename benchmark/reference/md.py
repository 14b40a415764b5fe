"""Velocity-Verlet MD with the plain reference force field.

Units are eV, Angstrom and amu; one internal time unit is
sqrt(amu A^2 / eV) = 10.1805 fs (CODATA).  The initial velocities are
the Maxwell-Boltzmann draw the program documents for ``run_md_jit``:
numpy's ``default_rng(seed)``, ``standard_normal((N, 3))`` times
sqrt(k_B T / m), the centre-of-mass velocity removed.  Within a chunk the
neighbour list is frozen (the graph of the chunk's first positions) and
the bond vectors follow the atoms, as the program's chunks do.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import graph as rgraph
from reference import model as rmodel

KB = 8.617333262e-5                      # eV / K
_AMU, _EV = 1.66053906660e-27, 1.602176634e-19
FS = 1e-15 / math.sqrt(_AMU * 1e-20 / _EV)   # 1 fs in internal units


def mb_velocities(masses: np.ndarray, temperature_K: float,
                  seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(KB * temperature_K / masses)[:, None]
    v = rng.standard_normal((len(masses), 3)) * sigma
    v -= (masses[:, None] * v).sum(axis=0) / masses.sum()
    return v


def verlet_chunk(params, cfg: dict, g: rgraph.Graph, vel0: np.ndarray,
                 timestep_fs: float, steps: int, device,
                 dtype=torch.float32):
    """Run `steps` NVE steps from the graph's positions and `vel0` with
    the graph's edges frozen; returns (epot [steps], ekin [steps], final
    cartesian positions [N, 3]) as numpy."""
    b = rmodel.batch_tensors([g], device, dtype)
    lat = torch.as_tensor(g.lattice, dtype=dtype, device=device)
    inv_lat = torch.as_tensor(np.linalg.inv(g.lattice), dtype=dtype,
                              device=device)
    images = torch.as_tensor(g.images, dtype=dtype, device=device)
    m = torch.as_tensor(rmodel.masses(g.z), dtype=dtype, device=device)
    frac = torch.as_tensor(g.frac, dtype=dtype, device=device)
    vel = torch.as_tensor(vel0, dtype=dtype, device=device)
    dt = timestep_fs * FS

    def forces_at(fr):
        cart = fr @ lat
        r = cart[b["dst"]] + images @ lat - cart[b["src"]]
        _out, energy, forces = rmodel.energy_forces(params, cfg, b, r)
        return energy.detach(), forces.detach()

    _e, f = forces_at(frac)
    epots, ekins = [], []
    for _ in range(steps):
        v_half = vel + 0.5 * dt * f / m[:, None]
        frac = (frac @ lat + dt * v_half) @ inv_lat
        e, f = forces_at(frac)
        vel = v_half + 0.5 * dt * f / m[:, None]
        epots.append(e)
        ekins.append(0.5 * (m[:, None] * vel ** 2).sum())
    cart = (frac @ lat).cpu().double().numpy()
    return (torch.stack(epots).cpu().double().numpy(),
            torch.stack(ekins).cpu().double().numpy(), cart)


def position_gap(cart_a: np.ndarray, cart_b: np.ndarray,
                 lattice: np.ndarray) -> float:
    """Largest distance between matching atoms, by the nearest image."""
    inv = np.linalg.inv(lattice)
    d = (cart_a - cart_b) @ inv
    d -= np.rint(d)
    return float(np.linalg.norm(d @ lattice, axis=1).max())
