"""Phonons via finite-displacement force constants (phonopy-lite).

Counterpart of ``alignn_tpu/ff/phonons.py`` (numpy).

Framework-owned replacement for the reference's phonopy/phono3py paths
(`alignn/ff/ff.py:1119-1334` `phonons`/`phonons3`, `:1337-1430`
`ase_phonon`): neither phonopy nor ASE exists in this environment, so
force constants, dynamical matrices, band structures and thermal
properties are computed natively.

Method: displace each atom of the primitive cell by +/-delta in x/y/z
inside an N1xN2xN3 supercell, get model forces, central-difference the
force-constant matrix Phi[(0,i,a),(R,j,b)] = -dF_{R,j,b}/du_{0,i,a};
acoustic sum rule enforced; D(q) built by lattice Fourier sum.

Units: Phi in eV/A^2, masses amu -> omega in sqrt(eV/(amu A^2))
= 1/t0 = 15.6330 THz (x 33.356 -> cm^-1).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from alignn_tpu_torch.chem.atoms import Atoms, atomic_masses

OMEGA_TO_THZ = 15.633302  # sqrt(eV/(amu A^2)) -> THz
THZ_TO_CM = 33.356410
KB = 8.617333262e-5  # eV/K


def force_constants(calc, atoms: Atoms, supercell=(2, 2, 2),
                    delta: float = 0.01,
                    symmetric: bool = True) -> Dict:
    """Finite-displacement FCs on a supercell.

    Returns dict with `fc` [n_prim, 3, n_super, 3], the supercell
    `cells` (integer images per supercell atom), `prim_map` (supercell
    atom -> primitive index), and the relaxed supercell.
    """
    n_prim = atoms.num_atoms
    sc_dims = np.asarray(supercell, dtype=np.int64)
    sc = atoms.make_supercell(supercell)
    n_super = sc.num_atoms
    n_cells = int(np.prod(sc_dims))

    # make_supercell orders as [cell_image, prim_atom] blocks
    # (alignn_tpu_torch.chem.atoms.Atoms.make_supercell): image major.
    images = np.stack(np.meshgrid(
        np.arange(sc_dims[0]), np.arange(sc_dims[1]),
        np.arange(sc_dims[2]), indexing="ij"), axis=-1).reshape(-1, 3)
    prim_map = np.tile(np.arange(n_prim), n_cells)
    cell_map = np.repeat(np.arange(n_cells), n_prim)

    fc = np.zeros((n_prim, 3, n_super, 3))
    cart0 = sc.cart_coords
    for i in range(n_prim):
        # displace atom i of the (0,0,0) cell == supercell index i
        # (cell 0 is the first block)
        for a in range(3):
            fp = fm = None
            for sign in (+1, -1):
                cart = cart0.copy()
                cart[i, a] += sign * delta
                disp = sc.with_positions(cart_coords=cart)
                f = calc.get_forces(disp)
                if sign > 0:
                    fp = f
                else:
                    fm = f
            dfdu = (fp - fm) / (2 * delta)  # [n_super, 3]
            fc[i, a] = -dfdu
    if symmetric:
        # acoustic sum rule: self-term = -sum of all others
        for i in range(n_prim):
            for a in range(3):
                for b in range(3):
                    total = fc[i, a, :, b].sum()
                    fc[i, a, i, b] -= total
    return {"fc": fc, "images": images, "prim_map": prim_map,
            "cell_map": cell_map, "supercell": sc_dims,
            "prim_atoms": atoms}


def export_force_constants(fcdata: Dict, path: str) -> str:
    """Write fc2 in phonopy's text ``FORCE_CONSTANTS`` format.

    Compact (n_prim x n_super) layout — the format phonopy reads with
    ``force_constants.is_compact_fc``-style headers: first line
    ``n_prim n_super``, then for each (i, j) a ``i j`` index line
    (1-based) followed by the 3x3 block in eV/A^2.  Lets a
    phonopy-equipped machine consume this framework's FD force
    constants directly (reference's phonon path is phonopy,
    ff/ff.py:1119-1269).
    """
    fc = np.asarray(fcdata["fc"])  # [n_prim, 3, n_super, 3]
    n_prim, _, n_super, _ = fc.shape
    with open(path, "w") as f:
        f.write(f"{n_prim} {n_super}\n")
        for i in range(n_prim):
            for j in range(n_super):
                f.write(f"{i + 1:4d} {j + 1:4d}\n")
                for a in range(3):
                    f.write("  %20.15f %20.15f %20.15f\n"
                            % tuple(fc[i, a, j, :]))
    return path


def dynamical_matrix(fcdata: Dict, q_frac: np.ndarray) -> np.ndarray:
    """D(q) [3n, 3n] for q in fractional coords of the primitive recip."""
    atoms = fcdata["prim_atoms"]
    fc = fcdata["fc"]
    images = fcdata["images"]
    prim_map = fcdata["prim_map"]
    cell_map = fcdata["cell_map"]
    n = atoms.num_atoms
    m = atomic_masses()[atoms.atomic_numbers]
    d = np.zeros((3 * n, 3 * n), dtype=np.complex128)
    phases = np.exp(2j * np.pi * (images @ np.asarray(q_frac)))  # [n_cells]
    for s in range(fc.shape[2]):
        j = prim_map[s]
        ph = phases[cell_map[s]]
        for i in range(n):
            d[3 * i:3 * i + 3, 3 * j:3 * j + 3] += (
                fc[i, :, s, :] * ph / np.sqrt(m[i] * m[j]))
    return 0.5 * (d + d.conj().T)


def phonon_frequencies(fcdata: Dict, q_frac: np.ndarray) -> np.ndarray:
    """Frequencies at q in THz (negative = imaginary)."""
    d = dynamical_matrix(fcdata, q_frac)
    w2 = np.linalg.eigvalsh(d)
    return np.sign(w2) * np.sqrt(np.abs(w2)) * OMEGA_TO_THZ


def phonon_band_structure(calc, atoms: Atoms, supercell=(2, 2, 2),
                          delta: float = 0.01,
                          path: Optional[Sequence] = None,
                          npoints: int = 20) -> Dict:
    """Frequencies along a q-path (reference `phonons`, ff/ff.py:1119).

    Default path: Gamma -> X(0.5,0,0) -> M(0.5,0.5,0) ->
    Gamma -> R(0.5,0.5,0.5).
    """
    fcdata = force_constants(calc, atoms, supercell, delta)
    if path is None:
        path = [("G", [0, 0, 0]), ("X", [0.5, 0, 0]),
                ("M", [0.5, 0.5, 0]), ("G", [0, 0, 0]),
                ("R", [0.5, 0.5, 0.5])]
    qs, labels, freqs, dists = [], [], [], []
    dist = 0.0
    # segment lengths in CARTESIAN reciprocal space (q_cart = q_frac @ B,
    # B = 2 pi inv(lat).T): fractional norms would distort the band-plot
    # x-axis for any non-cubic cell
    recip = 2.0 * np.pi * np.linalg.inv(
        np.asarray(fcdata["prim_atoms"].lattice_mat,
                   dtype=np.float64)).T
    for seg in range(len(path) - 1):
        q0 = np.asarray(path[seg][1], dtype=np.float64)
        q1 = np.asarray(path[seg + 1][1], dtype=np.float64)
        seg_len = float(np.linalg.norm((q1 - q0) @ recip))
        for t in np.linspace(0, 1, npoints, endpoint=(seg == len(path) - 2)):
            q = q0 + (q1 - q0) * t
            qs.append(q.tolist())
            freqs.append(phonon_frequencies(fcdata, q).tolist())
            dists.append(dist + seg_len * t)
        dist += seg_len
        labels.append((path[seg][0], float(dists[-npoints])))
    labels.append((path[-1][0], float(dists[-1])))
    return {"qpoints": qs, "distances": dists, "frequencies_THz": freqs,
            "labels": labels, "fcdata": fcdata}


def phonon_dos(fcdata: Dict, mesh=(8, 8, 8), sigma_THz: float = 0.25,
               npts: int = 200) -> Dict:
    """Gaussian-smeared phonon DOS on a Monkhorst-Pack mesh."""
    mesh = np.asarray(mesh)
    qs = np.stack(np.meshgrid(*[(np.arange(m) + 0.5) / m - 0.5
                                for m in mesh], indexing="ij"),
                  axis=-1).reshape(-1, 3)
    all_f = np.concatenate([phonon_frequencies(fcdata, q) for q in qs])
    grid = np.linspace(min(all_f.min(), 0) - 1, all_f.max() + 1, npts)
    dos = np.zeros_like(grid)
    for f in all_f:
        dos += np.exp(-((grid - f) ** 2) / (2 * sigma_THz ** 2))
    dos /= (len(qs) * np.sqrt(2 * np.pi) * sigma_THz)
    return {"frequencies_THz": grid.tolist(), "dos": dos.tolist(),
            "all_freqs": all_f.tolist()}


def thermal_properties(fcdata: Dict, temperatures: Sequence[float],
                       mesh=(8, 8, 8)) -> Dict:
    """Harmonic free energy / entropy / Cv vs T (phonopy parity outputs).

    F = sum_q,nu [ hbar w/2 + kT ln(1 - e^{-hbar w/kT}) ] / N_q
    """
    mesh = np.asarray(mesh)
    qs = np.stack(np.meshgrid(*[(np.arange(m) + 0.5) / m - 0.5
                                for m in mesh], indexing="ij"),
                  axis=-1).reshape(-1, 3)
    freqs = np.concatenate([phonon_frequencies(fcdata, q) for q in qs])
    freqs = freqs[freqs > 1e-3]  # THz; drop acoustic zeros/imaginary
    # h nu[eV] = 4.135667696e-15 eV*s * nu[Hz] = 4.1357e-3 * nu[THz]
    hbar_w = freqs * 4.135667696e-3
    nq = len(qs)
    out = {"temperatures": list(map(float, temperatures)),
           "free_energy_eV": [], "entropy_eV_K": [], "Cv_eV_K": []}
    for t in temperatures:
        if t <= 0:
            f = float(np.sum(hbar_w / 2) / nq)
            out["free_energy_eV"].append(f)
            out["entropy_eV_K"].append(0.0)
            out["Cv_eV_K"].append(0.0)
            continue
        x = hbar_w / (KB * t)
        f = float(np.sum(hbar_w / 2 + KB * t * np.log1p(-np.exp(-x))) / nq)
        s = float(np.sum(KB * (x / np.expm1(x) - np.log1p(-np.exp(-x))))
                  / nq)
        cv = float(np.sum(KB * x ** 2 * np.exp(x) / np.expm1(x) ** 2) / nq)
        out["free_energy_eV"].append(f)
        out["entropy_eV_K"].append(s)
        out["Cv_eV_K"].append(cv)
    return out
