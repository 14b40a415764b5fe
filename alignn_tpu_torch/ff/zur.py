"""Zur & McGill lattice matching for epitaxial interfaces.

Counterpart of ``alignn_tpu/ff/zur.py``.  Implements the
superlattice-matching algorithm of A. Zur and T. C. McGill, J. Appl.
Phys. 55, 378 (1984), which the reference drives through jarvis-tools'
ZSLGenerator in `get_interface_energy` (reference `alignn/ff/ff.py:
984-1116`).

Given the 2-D surface lattices of film and substrate (the a/b rows of
their slab cells), enumerate integer superlattice transformations
  T = [[i, j], [0, k]]  (Hermite normal form, det = n)
for both lattices over all area multiples (n_film, n_sub) with
n_film * A_film ~= n_sub * A_sub, Lagrange-reduce each candidate
superlattice, and accept pairs whose reduced vectors match within
`max_length_tol` (relative length) and `max_angle_tol` (relative
angle).  The lowest-area match wins — the film then needs only a small
residual strain onto the substrate superlattice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class ZurMatch:
    film_transform: np.ndarray       # [2, 2] int
    substrate_transform: np.ndarray  # [2, 2] int
    film_sl: np.ndarray              # [2, 3] film superlattice vectors
    substrate_sl: np.ndarray         # [2, 3] substrate superlattice vecs
    area: float                      # substrate superlattice area (A^2)
    strain: np.ndarray               # [2, 2] in-plane strain on the film
    mean_abs_strain: float


def _reduce_vectors(u: np.ndarray, v: np.ndarray):
    """Lagrange-Gauss reduction of a 2-D lattice basis (Zur Eq. 2.5).

    Returns (u', v', M) with u' shortest, |v'| >= |u'|, and the 2x2
    integer matrix M such that [u'; v'] = M @ [u; v].
    """
    m = np.eye(2, dtype=np.int64)
    u = u.astype(np.float64).copy()
    v = v.astype(np.float64).copy()
    for _ in range(100):
        if np.dot(u, v) < 0:
            v = -v
            m[1] = -m[1]
            continue
        if np.linalg.norm(u) > np.linalg.norm(v):
            u, v = v, u
            m = m[::-1].copy()
            continue
        if np.linalg.norm(v) > np.linalg.norm(v - u):
            v = v - u
            m[1] = m[1] - m[0]
            continue
        break
    return u, v, m


def _hnf_transforms(n: int) -> List[np.ndarray]:
    """All 2x2 Hermite-normal-form integer matrices with determinant n."""
    out = []
    for i in range(1, n + 1):
        if n % i:
            continue
        k = n // i
        for j in range(k):
            out.append(np.array([[i, j], [0, k]], dtype=np.int64))
    return out


def zur_matches(film_ab: np.ndarray, sub_ab: np.ndarray,
                max_area: float = 400.0,
                max_length_tol: float = 0.03,
                max_angle_tol: float = 0.01,
                max_results: int = 10) -> List[ZurMatch]:
    """Enumerate matching superlattices, sorted by (area, strain).

    `film_ab` / `sub_ab`: [2, 3] in-plane lattice vectors.
    """
    a_film = float(np.linalg.norm(np.cross(film_ab[0], film_ab[1])))
    a_sub = float(np.linalg.norm(np.cross(sub_ab[0], sub_ab[1])))
    matches: List[ZurMatch] = []

    max_n_sub = max(int(max_area / a_sub), 1)
    for n_sub in range(1, max_n_sub + 1):
        area = n_sub * a_sub
        # candidate film multiples bracketing the area ratio (Zur/ZSL
        # enumerates all pairs within tolerance; floor AND ceil cover
        # the near-half-integer ratios a single round() would miss)
        ratio = area / a_film
        # EVERY film multiple inside the area tolerance window (not just
        # floor/ceil of the ratio: small film cells admit several)
        area_tol = 2 * max_length_tol + max_length_tol ** 2
        lo = max(int(np.ceil(ratio * (1 - area_tol))), 1)
        hi = max(int(np.floor(ratio * (1 + area_tol))), 1)
        n_films = [n for n in range(lo, hi + 1)
                   if abs(n * a_film - area) / area <= area_tol]
        if not n_films:
            continue
        # substrate candidates depend only on n_sub — hoist out of the
        # film-transform loop (was O(#tf * #ts) reductions)
        sub_cands = []
        for ts in _hnf_transforms(n_sub):
            s_sl = ts.astype(np.float64) @ sub_ab
            su, sv, ms = _reduce_vectors(s_sl[0], s_sl[1])
            sub_cands.append((ts, su, sv, ms))
        for tf in (t for n in n_films for t in _hnf_transforms(n)):
            f_sl = tf.astype(np.float64) @ film_ab
            fu, fv, mf = _reduce_vectors(f_sl[0], f_sl[1])
            for ts, su, sv, ms in sub_cands:
                lu_f, lv_f = np.linalg.norm(fu), np.linalg.norm(fv)
                lu_s, lv_s = np.linalg.norm(su), np.linalg.norm(sv)
                if abs(lu_f - lu_s) / lu_s > max_length_tol:
                    continue
                if abs(lv_f - lv_s) / lv_s > max_length_tol:
                    continue
                cos_f = np.dot(fu, fv) / (lu_f * lv_f)
                cos_s = np.dot(su, sv) / (lu_s * lv_s)
                ang_f = np.arccos(np.clip(cos_f, -1, 1))
                ang_s = np.arccos(np.clip(cos_s, -1, 1))
                if abs(ang_f - ang_s) / max(ang_s, 1e-9) > max_angle_tol:
                    continue
                # in-plane strain mapping film superlattice -> substrate
                f2 = np.stack([fu, fv])
                s2 = np.stack([su, sv])
                gf = f2 @ f2.T  # metric tensors
                gs = s2 @ s2.T
                # principal stretches^2 = eigvals of the PENCIL
                # det(gs - lambda gf) = 0 (gf^-1 gs is non-symmetric for
                # anisotropic film bases; naive symmetrization perturbs
                # the stretches).  Solve via gf^-1/2 gs gf^-1/2.
                wf, vf = np.linalg.eigh(gf)
                gf_isqrt = vf @ np.diag(
                    1.0 / np.sqrt(np.maximum(wf, 1e-18))) @ vf.T
                w, vec = np.linalg.eigh(gf_isqrt @ gs @ gf_isqrt)
                sqrt_m = vec @ np.diag(np.sqrt(np.maximum(w, 0))) @ vec.T
                strain = sqrt_m - np.eye(2)
                matches.append(ZurMatch(
                    film_transform=mf @ tf,
                    substrate_transform=ms @ ts,
                    film_sl=f2, substrate_sl=s2, area=area,
                    strain=strain,
                    mean_abs_strain=float(np.abs(strain).mean())))
        if matches:
            break  # Zur: smallest matching area wins
    matches.sort(key=lambda m: (m.area, m.mean_abs_strain))
    return matches[:max_results]


def best_match(film_ab: np.ndarray, sub_ab: np.ndarray,
               **kwargs) -> Optional[ZurMatch]:
    ms = zur_matches(film_ab, sub_ab, **kwargs)
    return ms[0] if ms else None
