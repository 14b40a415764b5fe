"""Diamond-silicon supercells from the seed: one rattled MD system, or a
labelled training set of strained, rattled cells with vacancies.

Every structure is drawn from ``numpy.random.default_rng`` of a seed
sequence (the run's seed, a stream number), so one seed gives one set of
inputs, and every seed gives the same sizes.
"""

from __future__ import annotations

import numpy as np

DIAMOND = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0, 0.5, 0.5],
                    [0.25, 0.75, 0.75], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                    [0.5, 0.5, 0], [0.75, 0.75, 0.25]])


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, stream]))


def supercell(a: float, repeat) -> tuple:
    """(fractional coordinates [8 n, 3], lattice [3, 3]) of the diamond
    conventional cell repeated `repeat` times."""
    reps = np.stack(np.meshgrid(*[np.arange(k) for k in repeat],
                                indexing="ij"), -1).reshape(-1, 3)
    frac = (DIAMOND[None, :, :] + reps[:, None, :]).reshape(-1, 3) \
        / np.asarray(repeat)
    return frac, np.eye(3) * a * np.asarray(repeat)


def md_system(p: dict, seed: int) -> dict:
    """The MD system: the supercell rattled by ``rattle_A`` (normal, per
    component, in Angstrom)."""
    rng = rng_for(seed, 0)
    frac, lat = supercell(p["lattice_A"], p["repeat"])
    cart = frac @ lat + p["rattle_A"] * rng.standard_normal(frac.shape)
    frac = (cart @ np.linalg.inv(lat)) % 1.0
    return {"frac": frac, "lattice": lat,
            "elements": [p["element"]] * len(frac)}


def training_set(p: dict, seed: int) -> list:
    """``n_train + n_val`` labelled cells: lattice strain U(-s, s) per
    axis, a rattle whose scale is drawn from U(lo, hi), every
    ``vacancy_every``-th cell without one atom; labels: energy per atom
    N(mu, sigma), forces ``force_scale`` N(0, 1), stress ``stress_scale``
    N(0, 1) symmetrised."""
    rng = rng_for(seed, 1)
    base, lat0 = supercell(p["lattice_A"], p["repeat"])
    out = []
    for k in range(p["n_train"] + p["n_val"]):
        lat = lat0 * (1 + rng.uniform(-p["strain"], p["strain"], 3))[:, None]
        scale = rng.uniform(*p["rattle_A"])
        cart = base @ lat + scale * rng.standard_normal(base.shape)
        frac = (cart @ np.linalg.inv(lat)) % 1.0
        if k % p["vacancy_every"] == p["vacancy_every"] - 1:
            frac = np.delete(frac, rng.integers(len(frac)), axis=0)
        n = len(frac)
        mu, sigma = p["energy_per_atom"]
        s = rng.standard_normal((3, 3)) * p["stress_scale"]
        out.append({"frac": frac, "lattice": lat,
                    "elements": [p["element"]] * n,
                    "target": float(mu + sigma * rng.standard_normal()),
                    "forces": p["force_scale"] * rng.standard_normal((n, 3)),
                    "stress": (s + s.T) / 2})
    return out
