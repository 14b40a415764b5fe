"""Per-species reference-energy baseline (least-squares elemental offsets).

A copy of ``alignn_tpu/data/baseline.py`` (numpy only).  A multi-element
total-energy dataset (the combined mlearn ``all`` set: per-atom energies
spanning ~9 eV/atom between elements) trains badly against raw targets:
the inter-element offsets dominate the graph-level loss.  The fix fits
per-species reference energies mu_s by least squares on the TRAIN split,

    t_i  ~=  sum_s x_is * mu_s          (x_is = composition fraction)

trains the model on the residuals t_i - sum_s x_is mu_s, and adds the
composition term back at predict time.  MAE in residual space equals MAE
in original space, so reported metrics stay comparable.

The graph-level target is taken as an energy per atom (the mlearn
convention).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np


def composition_fractions(elements: Sequence[str]) -> Dict[str, float]:
    """Element -> fraction of the structure's atoms."""
    n = max(len(elements), 1)
    out: Dict[str, float] = {}
    for el in elements:
        out[el] = out.get(el, 0.0) + 1.0 / n
    return out


def fit_species_baseline(records: Sequence[dict],
                         ridge: float = 1e-8) -> Dict[str, float]:
    """Least-squares elemental offsets from per-atom scalar targets.

    `records` are id_prop rows ({"atoms": {..., "elements": [...]},
    "target": scalar per-atom energy}); pass the TRAIN split only.
    Tiny ridge keeps the normal equations well-posed when an element
    appears only in identical compositions.
    """
    species: List[str] = sorted(
        {el for r in records for el in r["atoms"]["elements"]})
    idx = {el: j for j, el in enumerate(species)}
    a = np.zeros((len(records), len(species)))
    t = np.zeros(len(records))
    for i, r in enumerate(records):
        for el, x in composition_fractions(
                r["atoms"]["elements"]).items():
            a[i, idx[el]] = x
        tv = np.asarray(r["target"], dtype=np.float64).reshape(-1)
        if tv.size != 1:
            raise ValueError(
                "per_species_energy_baseline needs a scalar graph "
                f"target; got width {tv.size}")
        t[i] = tv[0]
    ata = a.T @ a + ridge * np.eye(len(species))
    mu = np.linalg.solve(ata, a.T @ t)
    return {el: float(mu[idx[el]]) for el in species}


def baseline_per_atom(elements: Sequence[str],
                      mu: Mapping[str, float]) -> float:
    """sum_s x_s mu_s for one structure (0 contribution for unseen
    species — the model's residual head carries them alone)."""
    return float(sum(x * mu.get(el, 0.0) for el, x in
                     composition_fractions(elements).items()))


def residualize_records(records: Sequence[dict],
                        mu: Mapping[str, float]) -> List[dict]:
    """New record list with target -> target - baseline (copy; input
    rows untouched)."""
    out = []
    for r in records:
        b = baseline_per_atom(r["atoms"]["elements"], mu)
        t = np.asarray(r["target"], dtype=np.float64).reshape(-1)[0]
        out.append({**r, "target": float(t - b)})
    return out
