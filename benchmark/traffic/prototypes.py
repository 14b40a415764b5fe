"""Crystals from common prototypes, for property-model training.

A fixed plan of (prototype, supercell) pairs gives every seed the same
structure sizes: 2-64 atoms, most of them 2-16, as in JARVIS-DFT 3D.  The
seed draws the order, the elements (from the cgcnn table, noble gases
left out), the nearest-neighbour distance U(2.0, 3.0) A that sets each
lattice, a 0.02 A rattle and a target N(-1, 1) (eV/atom, formation-energy
like).
"""

from __future__ import annotations

import math

import numpy as np

from reference.model import elements
from traffic.si_supercell import rng_for

S3 = math.sqrt(3.0)
FCC = np.array([[0, 1, 1], [1, 0, 1], [1, 1, 0]]) / 2.0
# name: (sites as (species slot, frac), lattice(a), a per unit of d_nn)
PROTOTYPES = {
    "cscl": ([(0, (0, 0, 0)), (1, (.5, .5, .5))], lambda a: np.eye(3) * a,
             2 / S3),
    "rocksalt": ([(0, (0, 0, 0)), (1, (.5, .5, .5))], lambda a: FCC * a,
                 2.0),
    "zincblende": ([(0, (0, 0, 0)), (1, (.25, .25, .25))],
                   lambda a: FCC * a, 4 / S3),
    "fluorite": ([(0, (0, 0, 0)), (1, (.25, .25, .25)),
                  (1, (.75, .75, .75))], lambda a: FCC * a, 4 / S3),
    "wurtzite": ([(0, (1 / 3, 2 / 3, 0)), (0, (2 / 3, 1 / 3, .5)),
                  (1, (1 / 3, 2 / 3, .375)), (1, (2 / 3, 1 / 3, .875))],
                 lambda a: np.array([[a, 0, 0], [-a / 2, a * S3 / 2, 0],
                                     [0, 0, a * 1.633]]),
                 1 / math.sqrt(3 / 8)),
    "perovskite": ([(0, (0, 0, 0)), (1, (.5, .5, .5)), (2, (.5, .5, 0)),
                    (2, (.5, 0, .5)), (2, (0, .5, .5))],
                   lambda a: np.eye(3) * a, 2.0),
    "rutile": ([(0, (0, 0, 0)), (0, (.5, .5, .5)), (1, (.305, .305, 0)),
                (1, (.695, .695, 0)), (1, (.805, .195, .5)),
                (1, (.195, .805, .5))],
               lambda a: np.diag([a, a, 0.64 * a]),
               1 / (0.305 * math.sqrt(2))),
}
# supercells and the share of structures each takes
REPEATS = [((1, 1, 1), 0.50), ((2, 1, 1), 0.25), ((2, 2, 1), 0.16),
           ((2, 2, 2), 0.08), ((2, 2, 4), 0.01)]
NOBLE = {"He", "Ne", "Ar", "Kr", "Xe", "Rn"}


def plan(n: int) -> list:
    """`n` (prototype, repeat) pairs, the same for every seed."""
    combos = []
    for rep, share in REPEATS:
        protos = [p for p in PROTOTYPES
                  if len(PROTOTYPES[p][0]) * math.prod(rep) <= 64]
        k = round(n * share)
        combos += [(protos[i % len(protos)], rep) for i in range(k)]
    combos = combos[:n]
    while len(combos) < n:
        combos.append((list(PROTOTYPES)[len(combos) % 7], (1, 1, 1)))
    return combos


def make(proto: str, rep, rng, pool) -> dict:
    sites, lattice_of, per_d = PROTOTYPES[proto]
    species = rng.choice(pool, size=3, replace=False)
    a = per_d * rng.uniform(2.0, 3.0)
    lat = lattice_of(a) * np.asarray(rep)[:, None]
    cells = np.stack(np.meshgrid(*[np.arange(k) for k in rep],
                                 indexing="ij"), -1).reshape(-1, 3)
    frac = np.array([(np.asarray(f) + c) / np.asarray(rep)
                     for c in cells for _s, f in sites])
    els = [str(species[s]) for _c in cells for s, _f in sites]
    cart = frac @ lat + 0.02 * rng.standard_normal(frac.shape)
    return {"frac": (cart @ np.linalg.inv(lat)) % 1.0, "lattice": lat,
            "elements": els, "target": float(rng.normal(-1.0, 1.0))}


def training_set(p: dict, seed: int) -> list:
    table = elements()
    pool = np.array(sorted(e for e in table if e not in NOBLE
                           and table[e]["z"] <= 83))
    out = []
    for stream, n in ((1, p["n_train"]), (2, p["n_val"])):
        rng = rng_for(seed, stream)
        combos = plan(n)
        for i in rng.permutation(n):
            out.append(make(*combos[i], rng, pool))
    return out
