"""Third-order force constants + thermal conductivity (phonons3).

Counterpart of ``alignn_tpu/ff/phonons3.py`` and of the reference's
`phonons3` (reference `alignn/ff/ff.py:1271-1334`), a thin phono3py
wrapper: generate displaced supercells, evaluate model forces, produce
fc3, run RTA kappa.  The package does not depend on phono3py, so this
module owns the physics it can own exactly and models the rest:

- :func:`third_order_fc` — REAL fc3 by central finite differences of
  forces under displacement pairs (the same data phono3py fits), with
  drift-force removal like the reference loop (ff.py:1317-1321) and a
  pair-distance cutoff to bound the number of force calls.
- :func:`mode_gruneisen` — Grüneisen parameters by finite-difference of
  the harmonic frequencies under hydrostatic strain (thermodynamic
  definition gamma = -dln(omega)/dln(V)).
- :func:`thermal_conductivity` — kappa(T) via the Slack model using the
  computed Debye temperature and Grüneisen parameter.  This is a
  physics-grade ESTIMATE, not phono3py's full RTA integration; the fc3
  tensor is exposed so a phono3py-equipped environment can run the exact
  pipeline.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from alignn_tpu_torch.chem.atoms import Atoms, atomic_masses
from alignn_tpu_torch.ff.phonons import (
    force_constants,
    phonon_dos,
    phonon_frequencies,
)

KB = 8.617333262e-5          # eV / K
KB_SI = 1.380649e-23         # J / K
HBAR_SI = 1.054571817e-34    # J s
AMU = 1.66053906660e-27      # kg
THZ = 1e12

# numpy >= 2 names it trapezoid, numpy 1 trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def third_order_fc(calc, atoms: Atoms, supercell=(2, 2, 2),
                   distance: float = 0.03,
                   pair_cutoff: float = 3.5) -> Dict:
    """fc3[iα, jβ, kγ] = -∂F_kγ / (∂u_iα ∂u_jβ), central differences.

    i runs over the first primitive cell's atoms in the supercell (the
    phono3py convention); j over supercell atoms within `pair_cutoff`
    Angstrom of i; k over all supercell atoms.  4 force evaluations per
    (iα, jβ) pair.
    """
    sc = atoms.make_supercell(supercell)
    n = sc.num_atoms
    n_prim = atoms.num_atoms
    cart0 = sc.cart_coords
    h = distance

    def forces_at(disp: np.ndarray) -> np.ndarray:
        a = sc.with_positions(cart_coords=cart0 + disp)
        f = calc.calculate(a)["forces"]
        return f - f.mean(axis=0, keepdims=True)  # drift removal

    # pair list within cutoff (minimum-image in the supercell)
    lat = sc.lattice_mat
    inv = np.linalg.inv(lat)
    fc3 = np.zeros((n_prim, 3, n, 3, n, 3))
    pairs = []
    for i in range(n_prim):
        for j in range(n):
            d = cart0[j] - cart0[i]
            fr = d @ inv
            fr -= np.round(fr)
            if np.linalg.norm(fr @ lat) <= pair_cutoff:
                pairs.append((i, j))

    for i, j in pairs:
        for a in range(3):
            for b in range(3):
                dpp = np.zeros((n, 3)); dpp[i, a] += h; dpp[j, b] += h
                dpm = np.zeros((n, 3)); dpm[i, a] += h; dpm[j, b] -= h
                dmp = np.zeros((n, 3)); dmp[i, a] -= h; dmp[j, b] += h
                dmm = np.zeros((n, 3)); dmm[i, a] -= h; dmm[j, b] -= h
                d2f = (forces_at(dpp) - forces_at(dpm)
                       - forces_at(dmp) + forces_at(dmm)) / (4 * h * h)
                fc3[i, a, j, b] = -d2f  # [n, 3]
    return {"fc3": fc3, "pairs": pairs, "supercell": tuple(supercell),
            "n_prim": n_prim, "n_super": n, "distance": distance,
            "n_force_calls": 36 * len(pairs)}


def export_fc3(fcdata: Dict, path: str, sc_atoms: Atoms = None) -> str:
    """Write fc3 in phono3py's compact ``fc3.hdf5`` layout.

    phono3py reads ``fc3.hdf5`` containing dataset ``fc3`` of shape
    ``(n_patom, n_satom, n_satom, 3, 3, 3)`` in eV/Angstrom^3 plus
    ``p2s_map`` (primitive-atom indices into the supercell) — the
    compact form produced by ``phono3py --cf3`` workflows.  Conventions
    matched here:

    - index meaning: fc3[i, j, k, a, b, c] = d^3 E / du_ia du_jb du_kc
      (our FD computes -d^2 F_kc / du_ia du_jb, the same tensor);
    - supercell atom ordering: this package's ``make_supercell`` orders
      atoms [cell_image, prim_atom] with cell (0,0,0) FIRST, so
      p2s_map = arange(n_prim) (pinned by ff/phonons.py:46-52);
    - translational ASR over the third index holds by construction
      (forces are drift-removed before differencing, the analogue of
      reference ff.py:1317-1321);
    - entries for j outside `pair_cutoff` are zero (cutoff-truncated
      fc3, phono3py's cutoff-pair semantics).

    If ``path`` ends in ``.npz`` (or h5py is unavailable) the same
    arrays are written as a numpy archive with identical keys, which a
    phono3py-equipped machine converts with four lines of h5py.
    Supercell geometry rides along for provenance when ``sc_atoms`` is
    given.
    """
    fc3 = np.ascontiguousarray(
        np.transpose(fcdata["fc3"], (0, 2, 4, 1, 3, 5)))
    p2s_map = np.arange(fcdata["n_prim"], dtype=np.int64)
    extras = {}
    if sc_atoms is not None:
        extras["supercell_lattice"] = np.asarray(sc_atoms.lattice_mat)
        extras["supercell_frac_coords"] = np.asarray(sc_atoms.frac_coords)
        extras["supercell_numbers"] = np.asarray(sc_atoms.atomic_numbers)
    if not path.endswith(".npz"):
        try:
            import h5py
        except Exception:
            path = path.rsplit(".", 1)[0] + ".npz"
        else:
            with h5py.File(path, "w") as f:
                f.create_dataset("fc3", data=fc3, compression="gzip")
                f.create_dataset("p2s_map", data=p2s_map)
                f.create_dataset(
                    "version", data=np.bytes_("alignn_tpu-fd-compact"))
                for k, v in extras.items():
                    f.create_dataset(k, data=v)
            return path
    np.savez_compressed(path, fc3=fc3, p2s_map=p2s_map, **extras)
    return path


def mode_gruneisen(calc, atoms: Atoms, supercell=(2, 2, 2),
                   q_points: np.ndarray = None,
                   dvol: float = 0.01) -> Dict:
    """gamma_qs = -d ln(omega_qs) / d ln(V) by two-volume differences."""
    if q_points is None:
        q_points = np.array([[0.1, 0, 0], [0.25, 0.25, 0],
                             [0.5, 0.5, 0.5], [0.25, 0, 0]])
    scale_p = (1 + dvol) ** (1 / 3)
    scale_m = (1 - dvol) ** (1 / 3)
    freqs = {}
    for tag, s in (("p", scale_p), ("m", scale_m)):
        a = Atoms(lattice_mat=atoms.lattice_mat * s,
                  frac_coords=atoms.frac_coords, elements=atoms.elements)
        fc = force_constants(calc, a, supercell=supercell)
        freqs[tag] = np.stack([np.abs(phonon_frequencies(fc, q))
                               for q in q_points])
    wp, wm = freqs["p"], freqs["m"]
    ok = (wp > 1e-3) & (wm > 1e-3)
    gam = np.zeros_like(wp)
    gam[ok] = -(np.log(wp[ok]) - np.log(wm[ok])) / (2 * dvol)
    return {"gruneisen": gam, "mean_abs_gruneisen":
            float(np.abs(gam[ok]).mean()) if ok.any() else 0.0,
            "q_points": q_points}


def debye_temperature(fcdata: Dict, mesh=(6, 6, 6)) -> float:
    """Theta_D from the mean phonon frequency of the DOS:
    Theta_D = (h nu_D) / kB with nu_D^3 proportional to <nu^2>^{3/2}
    (moment-based Debye fit)."""
    out = phonon_dos(fcdata, mesh=mesh)
    grid = np.asarray(out["frequencies_THz"])
    dos = np.maximum(np.asarray(out["dos"]), 0)
    # only real (positive-frequency) modes carry heat
    dos = np.where(grid > 0, dos, 0.0)
    norm = _trapezoid(dos, grid)
    if norm <= 0:
        return 0.0
    nu2 = _trapezoid(dos * grid ** 2, grid) / norm  # THz^2
    nu_d = np.sqrt(5.0 / 3.0 * nu2)  # Debye fit: <nu^2> = 3/5 nu_D^2
    return float(HBAR_SI * 2 * np.pi * nu_d * THZ / KB_SI)


def thermal_conductivity(calc, atoms: Atoms, supercell=(2, 2, 2),
                         temperatures: Sequence[float] = tuple(
                             range(100, 1001, 100)),
                         mesh=(6, 6, 6)) -> Dict:
    """kappa(T) via the Slack model with computed Theta_D and gamma.

    kappa = A M_avg theta_a^3 delta n^(1/3) / (gamma^2 T) with the
    ACOUSTIC Debye temperature theta_a = Theta_D * n^(-1/3) (Slack 1973;
    Morelli & Slack 2006) — :func:`debye_temperature` returns the
    full-spectrum Theta_D, so the n factors combine to
    kappa = A M Theta_D^3 delta / (gamma^2 T n^(2/3)).  A = 3.1e-6
    (kappa in W/mK, M in amu, delta in Angstrom).  Grüneisen comes from
    :func:`mode_gruneisen` (finite volume differences of the REAL
    harmonic spectrum of the model) — see module docstring for the
    relation to phono3py's RTA.
    """
    fc = force_constants(calc, atoms, supercell=supercell)
    theta_d = debye_temperature(fc, mesh=mesh)
    gru = mode_gruneisen(calc, atoms, supercell=supercell)
    gamma = max(gru["mean_abs_gruneisen"], 0.05)

    n_atoms = atoms.num_atoms
    m_avg = float(atomic_masses()[atoms.atomic_numbers].mean())
    delta = float((atoms.volume / n_atoms) ** (1.0 / 3.0))
    a_const = 3.1e-6
    temps = np.asarray(list(temperatures), dtype=np.float64)
    kappa = np.where(
        temps > 0,
        a_const * m_avg * theta_d ** 3 * delta
        / (n_atoms ** (2.0 / 3.0) * gamma ** 2 * np.maximum(temps, 1.0)),
        0.0)
    return {"temperatures": temps.tolist(), "kappa_w_mk": kappa.tolist(),
            "theta_d_K": theta_d, "gruneisen": gamma,
            "model": "slack"}
