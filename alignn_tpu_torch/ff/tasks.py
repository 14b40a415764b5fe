"""Materials analysis tasks: E-V curve/EOS, vacancy, surfaces, interfaces.

Counterpart of ``alignn_tpu/ff/tasks.py`` (numpy and scipy).

Framework-owned equivalents of the reference's analysis functions
(`alignn/ff/ff.py`): `ev_curve` + EOS fit (:762-805), `vacancy_formation`
(:808-897), `surface_energy` (:900-981), `get_interface_energy`
(:984-1116, simplified stacking without the Zur lattice-match search).
The reference delegates slab/defect generation to jarvis-tools; the
constructions here are self-contained.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from alignn_tpu_torch.chem.atoms import Atoms
from alignn_tpu_torch.ff.relax import fire_relax
from alignn_tpu_torch.nn.models import EV_A3_TO_GPA
EV_A2_TO_JM2 = 16.021766208  # eV/A^2 -> J/m^2


# ---------------------------------------------------------------------------
# E-V curve + equation of state
# ---------------------------------------------------------------------------


def fit_murnaghan(volumes: np.ndarray, energies: np.ndarray
                  ) -> Dict[str, float]:
    """Murnaghan EOS fit; returns E0, V0, B (GPa), Bp.

    Same physics as the fit used by reference ev_curve (ff/ff.py:791-800,
    via jarvis); seeded from a parabolic pre-fit.
    """
    from scipy.optimize import least_squares

    v = np.asarray(volumes, dtype=np.float64)
    e = np.asarray(energies, dtype=np.float64)
    p = np.polyfit(v, e, 2)
    v0 = float(np.clip(-p[1] / (2 * p[0]) if p[0] != 0 else np.median(v),
                       0.5 * v.min(), 2.0 * v.max()))
    e0 = float(np.polyval(p, v0))
    b0 = float(np.clip(2 * abs(p[0]) * v0, 1e-4, 1e4))
    bp = 4.0

    def murn(x):
        e0_, b0_, bp_, v0_ = x
        r = v0_ / v
        return (e0_ + b0_ * v / bp_ * (r ** bp_ / (bp_ - 1) + 1)
                - v0_ * b0_ / (bp_ - 1)) - e

    lo = [e.min() - 10 * np.ptp(e) - 1, 1e-6, 1.1, 0.5 * v.min()]
    hi = [e.max() + 10 * np.ptp(e) + 1, 1e5, 12.0, 2.0 * v.max()]
    sol = least_squares(murn, [np.clip(e0, lo[0], hi[0]), b0, bp, v0],
                        bounds=(lo, hi))
    e0_, b0_, bp_, v0_ = sol.x
    return {"E0": float(e0_), "V0": float(v0_),
            "B_GPa": float(b0_ * EV_A3_TO_GPA), "Bp": float(bp_),
            "residual": float(np.sqrt(np.mean(sol.fun ** 2)))}


def fit_birch_murnaghan(volumes: np.ndarray, energies: np.ndarray
                        ) -> Dict[str, float]:
    """3rd-order Birch-Murnaghan EOS fit; returns E0, V0, B (GPa), Bp.

    Complements :func:`fit_murnaghan`: the BM form is polynomial in the
    Eulerian strain f = ((V0/V)^(2/3) - 1)/2, which conditions better
    on shallow/noisy ML-potential curves where the Murnaghan Bp tends
    to pin at its bound."""
    from scipy.optimize import least_squares

    v = np.asarray(volumes, dtype=np.float64)
    e = np.asarray(energies, dtype=np.float64)
    p = np.polyfit(v, e, 2)
    v0 = float(np.clip(-p[1] / (2 * p[0]) if p[0] != 0 else np.median(v),
                       0.5 * v.min(), 2.0 * v.max()))
    e0 = float(np.polyval(p, v0))
    b0 = float(np.clip(2 * abs(p[0]) * v0, 1e-4, 1e4))

    def bm(x):
        e0_, b0_, bp_, v0_ = x
        eta = (v0_ / v) ** (2.0 / 3.0)
        f = 0.5 * (eta - 1.0)
        return (e0_ + 4.5 * b0_ * v0_ * f ** 2
                * (1.0 + (bp_ - 4.0) * f)) - e

    lo = [e.min() - 10 * np.ptp(e) - 1, 1e-6, 0.5, 0.5 * v.min()]
    hi = [e.max() + 10 * np.ptp(e) + 1, 1e5, 12.0, 2.0 * v.max()]
    sol = least_squares(bm, [np.clip(e0, lo[0], hi[0]), b0, 4.0, v0],
                        bounds=(lo, hi))
    e0_, b0_, bp_, v0_ = sol.x
    return {"E0": float(e0_), "V0": float(v0_),
            "B_GPa": float(b0_ * EV_A3_TO_GPA), "Bp": float(bp_),
            "residual": float(np.sqrt(np.mean(sol.fun ** 2)))}


def ev_curve(calc, atoms: Atoms,
             dx: Optional[Sequence[float]] = None,
             relax_first: bool = True,
             fmax: float = 0.05, steps: int = 200) -> Dict:
    """Energy-volume curve by isotropic cell scaling + Murnaghan fit.

    Reference ff/ff.py:762-805 (default strain grid ±5% in 1% steps).
    """
    if dx is None:
        dx = np.arange(-0.05, 0.06, 0.01)
    if relax_first:
        atoms, _e, _n = fire_relax(calc, atoms, fmax=fmax, steps=steps,
                                   optimize_lattice=True)
    volumes, energies = [], []
    for strain in dx:
        s = (1 + strain)
        scaled = Atoms(lattice_mat=atoms.lattice_mat * s,
                       frac_coords=atoms.frac_coords,
                       elements=atoms.elements)
        e = calc.get_potential_energy(scaled)
        volumes.append(scaled.volume)
        energies.append(e)
    eos = fit_murnaghan(np.array(volumes), np.array(energies))
    eos_bm = fit_birch_murnaghan(np.array(volumes), np.array(energies))
    return {"volumes": volumes, "energies": energies, "eos": eos,
            "eos_birch_murnaghan": eos_bm, "kv": eos["B_GPa"]}


# ---------------------------------------------------------------------------
# vacancy formation
# ---------------------------------------------------------------------------


def generate_vacancies(atoms: Atoms, supercell=(2, 2, 2)
                       ) -> List[Tuple[str, Atoms]]:
    """One vacancy structure per distinct element (Wyckoff-lite dedup)."""
    sc = atoms.make_supercell(supercell)
    seen = set()
    out = []
    for i, el in enumerate(sc.elements):
        if el in seen:
            continue
        seen.add(el)
        frac = np.delete(sc.frac_coords, i, axis=0)
        elems = [e for j, e in enumerate(sc.elements) if j != i]
        out.append((el, Atoms(lattice_mat=sc.lattice_mat,
                              frac_coords=frac, elements=elems)))
    return out


def vacancy_formation(calc, atoms: Atoms, supercell=(2, 2, 2),
                      fmax: float = 0.05, steps: int = 200,
                      chem_pot: Optional[Dict[str, float]] = None
                      ) -> List[Dict]:
    """E_f = E_defect - E_bulk + mu(removed); reference ff/ff.py:808-897.

    Without chemical potentials, mu defaults to E_bulk/N_bulk of the
    element's own reference (here: bulk per-atom energy), matching the
    reference's unary default.
    """
    sc = atoms.make_supercell(supercell)
    _sc_rel, e_bulk, _ = fire_relax(calc, sc, fmax=fmax, steps=steps)
    n_bulk = sc.num_atoms
    results = []
    for el, vac in generate_vacancies(atoms, supercell):
        _v, e_vac, _ = fire_relax(calc, vac, fmax=fmax, steps=steps)
        mu = (chem_pot or {}).get(el, e_bulk / n_bulk)
        ef = e_vac - e_bulk + mu
        results.append({"element": el, "E_vacancy": float(e_vac),
                        "E_bulk": float(e_bulk), "mu": float(mu),
                        "E_formation": float(ef)})
    return results


# ---------------------------------------------------------------------------
# surfaces
# ---------------------------------------------------------------------------


def _ext_gcd(a: int, b: int) -> Tuple[int, int, int]:
    if b == 0:
        return a, 1, 0
    g, x, y = _ext_gcd(b, a % b)
    return g, y, x - (a // b) * y


def make_slab(atoms: Atoms, miller: Tuple[int, int, int] = (1, 1, 1),
              layers: int = 3, vacuum: float = 18.0) -> Atoms:
    """Slab with `miller` surface normal to c, vacuum added.

    Basis-change algorithm (two in-plane integer vectors solving
    h*x + k*y + l*z = 0 plus a completing vector) as used by standard
    surface constructions; replaces the jarvis Surface class the reference
    calls at ff/ff.py:900-981.
    """
    h, k, l = miller
    if (h, k, l) == (0, 0, 0):
        raise ValueError("invalid miller index (0,0,0)")
    # two in-plane vectors + completing vector (unimodular basis)
    if h == 0 and k == 0:
        v1, v2, v3 = np.array([1, 0, 0]), np.array([0, 1, 0]), \
            np.array([0, 0, 1 if l > 0 else -1])
    elif h == 0 and l == 0:
        v1, v2, v3 = np.array([0, 0, 1]), np.array([1, 0, 0]), \
            np.array([0, 1 if k > 0 else -1, 0])
    elif k == 0 and l == 0:
        v1, v2, v3 = np.array([0, 1, 0]), np.array([0, 0, 1]), \
            np.array([1 if h > 0 else -1, 0, 0])
    else:
        g, p, q = _ext_gcd(h, k)
        v1 = np.array([k // g, -h // g, 0])
        gg, r, s = _ext_gcd(g, l)
        v2 = np.array([p * (l // gg), q * (l // gg), -(g // gg)])
        v3 = np.array([p * r, q * r, s])
    basis = np.array([v1, v2, v3], dtype=np.int64)
    if np.linalg.det(basis.astype(np.float64) @ atoms.lattice_mat) < 0:
        basis[0] = -basis[0]

    # fill the transformed cell via the general integer-matrix
    # supercell (corner-derived image bounds + fill-count VERIFICATION
    # — a fixed +-2 image search silently dropped atoms for Miller
    # indices like (3,2,1), making surface energies wrong)
    unit = atoms.make_supercell_matrix(basis)

    slab = unit.make_supercell((1, 1, layers))
    # add vacuum along c
    lat = slab.lattice_mat.copy()
    c_norm = np.linalg.norm(lat[2])
    c_hat = lat[2] / c_norm
    new_c = lat[2] + c_hat * vacuum
    cart = slab.cart_coords
    lat2 = np.array([lat[0], lat[1], new_c])
    return Atoms(lattice_mat=lat2, frac_coords=cart @ np.linalg.inv(lat2),
                 elements=slab.elements)


def surface_energy(calc, atoms: Atoms,
                   miller: Tuple[int, int, int] = (1, 1, 1),
                   layers: int = 3, vacuum: float = 18.0,
                   fmax: float = 0.05, steps: int = 200) -> Dict:
    """gamma = (E_slab - n_slab * E_bulk/atom) / (2 A)  [J/m^2].

    Reference ff/ff.py:900-981.
    """
    _b, e_bulk, _ = fire_relax(calc, atoms, fmax=fmax, steps=steps)
    e_bulk_per_atom = e_bulk / atoms.num_atoms
    slab = make_slab(atoms, miller=miller, layers=layers, vacuum=vacuum)
    _s, e_slab, _ = fire_relax(calc, slab, fmax=fmax, steps=steps)
    a_vec, b_vec = slab.lattice_mat[0], slab.lattice_mat[1]
    area = float(np.linalg.norm(np.cross(a_vec, b_vec)))
    gamma = (e_slab - slab.num_atoms * e_bulk_per_atom) / (2 * area)
    return {"miller": list(miller),
            "surface_energy_J_m2": float(gamma * EV_A2_TO_JM2),
            "E_slab": float(e_slab), "E_bulk_per_atom": e_bulk_per_atom,
            "area_A2": area, "n_slab": slab.num_atoms}


# ---------------------------------------------------------------------------
# interfaces (simplified stacking)
# ---------------------------------------------------------------------------


def get_interface_energy(calc, film: Atoms, substrate: Atoms,
                         film_miller=(0, 0, 1), subs_miller=(0, 0, 1),
                         film_layers: int = 2, subs_layers: int = 2,
                         separation: float = 2.5, vacuum: float = 18.0,
                         fmax: float = 0.05, steps: int = 100,
                         max_area: float = 400.0,
                         max_length_tol: float = 0.03,
                         max_angle_tol: float = 0.01) -> Dict:
    """Stack film slab on substrate slab; W_ad per area.

    Performs Zur & McGill lattice matching (ff/zur.py) like the
    reference (`ff/ff.py:984-1116` via jarvis ZSLGenerator): both slabs
    expand to the lowest-area commensurate superlattices within the
    length/angle tolerances, then the film takes only the small residual
    strain.  If no match exists within `max_area`, falls back to the
    direct strained stacking and flags it.
    """
    from alignn_tpu_torch.ff.zur import best_match

    f_slab = make_slab(film, film_miller, film_layers, vacuum=0.0)
    s_slab = make_slab(substrate, subs_miller, subs_layers, vacuum=0.0)

    match = best_match(f_slab.lattice_mat[:2], s_slab.lattice_mat[:2],
                       max_area=max_area, max_length_tol=max_length_tol,
                       max_angle_tol=max_angle_tol)
    zur_info: Dict = {"zur_matched": match is not None}
    if match is not None:
        def to3(t2):
            p = np.eye(3, dtype=np.int64)
            p[:2, :2] = t2
            return p

        f_slab = f_slab.make_supercell_matrix(to3(match.film_transform))
        s_slab = s_slab.make_supercell_matrix(
            to3(match.substrate_transform))
        zur_info.update({
            "zur_area_A2": match.area,
            "zur_mean_abs_strain": match.mean_abs_strain,
            "film_transform": match.film_transform.tolist(),
            "substrate_transform": match.substrate_transform.tolist()})
    lat_s = s_slab.lattice_mat
    # strain film in-plane onto substrate a/b
    lat_f = f_slab.lattice_mat
    frac_f = f_slab.frac_coords
    c_s = np.linalg.norm(lat_s[2])
    c_f = np.linalg.norm(lat_f[2])
    c_hat = lat_s[2] / c_s
    total_c = c_s + separation + c_f + vacuum
    lat_i = np.array([lat_s[0], lat_s[1], c_hat * total_c])
    subs_cart = s_slab.cart_coords
    film_cart = frac_f @ np.array([lat_s[0], lat_s[1],
                                   lat_f[2]])  # strained in-plane
    film_cart = film_cart + c_hat * (c_s + separation)
    cart = np.concatenate([subs_cart, film_cart], axis=0)
    elems = list(s_slab.elements) + list(f_slab.elements)
    iface = Atoms(lattice_mat=lat_i,
                  frac_coords=cart @ np.linalg.inv(lat_i), elements=elems)
    _i, e_iface, _ = fire_relax(calc, iface, fmax=fmax, steps=steps)
    e_f = calc.get_potential_energy(f_slab)
    e_s = calc.get_potential_energy(s_slab)
    area = float(np.linalg.norm(np.cross(lat_s[0], lat_s[1])))
    w_ad = (e_f + e_s - e_iface) / area
    return {"W_adhesion_J_m2": float(w_ad * EV_A2_TO_JM2),
            "E_interface": float(e_iface), "E_film": float(e_f),
            "E_substrate": float(e_s), "area_A2": area,
            "interface": iface.to_dict(), **zur_info}
