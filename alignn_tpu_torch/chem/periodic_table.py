"""Periodic-table data owned by the framework.

The PyTorch port keeps its own copy of the JAX package's
``alignn_tpu/chem/periodic_table.py`` (pure data and numpy), so that it
imports nothing of that package.

The reference (usnistgov/alignn) delegates element data to jarvis-tools
(`jarvis.core.specie`, used from `alignn/graphs.py:10`).  jarvis-tools is an
external dependency; this framework owns its element tables so the chemistry
layer has no third-party requirements.  Values are standard published data
(Pauling electronegativity, Cordero covalent radii, NIST ionization
energies/electron affinities); electron configurations are generated from the
Aufbau rule with the usual exceptions.
"""

from __future__ import annotations

import functools

import numpy as np

MAX_Z = 103

SYMBOLS = [
    "X",  # placeholder for Z=0
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
    "Md", "No", "Lr",
]

Z_FROM_SYMBOL = {s: z for z, s in enumerate(SYMBOLS)}

# Pauling electronegativity (0.0 where undefined, e.g. noble gases w/o data).
_X = [0.0,
    2.20, 0.00, 0.98, 1.57, 2.04, 2.55, 3.04, 3.44, 3.98, 0.00,
    0.93, 1.31, 1.61, 1.90, 2.19, 2.58, 3.16, 0.00, 0.82, 1.00,
    1.36, 1.54, 1.63, 1.66, 1.55, 1.83, 1.88, 1.91, 1.90, 1.65,
    1.81, 2.01, 2.18, 2.55, 2.96, 3.00, 0.82, 0.95, 1.22, 1.33,
    1.60, 2.16, 1.90, 2.20, 2.28, 2.20, 1.93, 1.69, 1.78, 1.96,
    2.05, 2.10, 2.66, 2.60, 0.79, 0.89, 1.10, 1.12, 1.13, 1.14,
    1.13, 1.17, 1.20, 1.20, 1.10, 1.22, 1.23, 1.24, 1.25, 1.10,
    1.27, 1.30, 1.50, 2.36, 1.90, 2.20, 2.20, 2.28, 2.54, 2.00,
    1.62, 2.33, 2.02, 2.00, 2.20, 0.00, 0.70, 0.90, 1.10, 1.30,
    1.50, 1.38, 1.36, 1.28, 1.30, 1.30, 1.30, 1.30, 1.30, 1.30,
    1.30, 1.30, 1.30,
]

# Covalent radius in Angstrom (Cordero et al., 2008; fallbacks for actinides).
_COV_RAD = [0.0,
    0.31, 0.28, 1.28, 0.96, 0.84, 0.76, 0.71, 0.66, 0.57, 0.58,
    1.66, 1.41, 1.21, 1.11, 1.07, 1.05, 1.02, 1.06, 2.03, 1.76,
    1.70, 1.60, 1.53, 1.39, 1.39, 1.32, 1.26, 1.24, 1.32, 1.22,
    1.22, 1.20, 1.19, 1.20, 1.20, 1.16, 2.20, 1.95, 1.90, 1.75,
    1.64, 1.54, 1.47, 1.46, 1.42, 1.39, 1.45, 1.44, 1.42, 1.39,
    1.39, 1.38, 1.39, 1.40, 2.44, 2.15, 2.07, 2.04, 2.03, 2.01,
    1.99, 1.98, 1.98, 1.96, 1.94, 1.92, 1.92, 1.89, 1.90, 1.87,
    1.87, 1.75, 1.70, 1.62, 1.51, 1.44, 1.41, 1.36, 1.36, 1.32,
    1.45, 1.46, 1.48, 1.40, 1.50, 1.50, 2.60, 2.21, 2.15, 2.06,
    2.00, 1.96, 1.90, 1.87, 1.80, 1.69, 1.70, 1.70, 1.70, 1.70,
    1.70, 1.70, 1.70,
]

# First ionization energy (eV).
_ION_EN = [0.0,
    13.598, 24.587, 5.392, 9.323, 8.298, 11.260, 14.534, 13.618, 17.423, 21.565,
    5.139, 7.646, 5.986, 8.152, 10.487, 10.360, 12.968, 15.760, 4.341, 6.113,
    6.561, 6.828, 6.746, 6.767, 7.434, 7.902, 7.881, 7.640, 7.726, 9.394,
    5.999, 7.899, 9.789, 9.752, 11.814, 14.000, 4.177, 5.695, 6.217, 6.634,
    6.759, 7.092, 7.280, 7.360, 7.459, 8.337, 7.576, 8.994, 5.786, 7.344,
    8.608, 9.010, 10.451, 12.130, 3.894, 5.212, 5.577, 5.539, 5.473, 5.525,
    5.582, 5.644, 5.670, 6.150, 5.864, 5.939, 6.022, 6.108, 6.184, 6.254,
    5.426, 6.825, 7.550, 7.864, 7.834, 8.438, 8.967, 8.959, 9.226, 10.438,
    6.108, 7.417, 7.286, 8.414, 9.318, 10.749, 4.073, 5.278, 5.170, 6.307,
    5.890, 6.194, 6.266, 6.026, 5.974, 5.991, 6.198, 6.282, 6.420, 6.500,
    6.580, 6.650, 4.900,
]

# Electron affinity (eV; 0 where unbound / unknown).
_ELEC_AFF = [0.0,
    0.754, 0.000, 0.618, 0.000, 0.280, 1.262, 0.000, 1.461, 3.401, 0.000,
    0.548, 0.000, 0.433, 1.390, 0.746, 2.077, 3.613, 0.000, 0.501, 0.025,
    0.188, 0.079, 0.525, 0.666, 0.000, 0.151, 0.662, 1.156, 1.235, 0.000,
    0.430, 1.233, 0.804, 2.021, 3.364, 0.000, 0.486, 0.048, 0.307, 0.426,
    0.893, 0.748, 0.550, 1.050, 1.137, 0.562, 1.302, 0.000, 0.300, 1.112,
    1.046, 1.971, 3.059, 0.000, 0.472, 0.145, 0.470, 0.065, 0.096, 0.097,
    0.129, 0.162, 0.116, 0.137, 0.156, 0.352, 0.338, 0.312, 1.029, 0.020,
    0.346, 0.017, 0.322, 0.816, 0.150, 1.100, 1.564, 2.128, 2.309, 0.000,
    0.200, 0.364, 0.942, 1.900, 2.800, 0.000, 0.460, 0.100, 0.350, 0.600,
    0.550, 0.530, 0.480, 0.000, 0.100, 0.280, 0.000, 0.000, 0.000, 0.000,
    0.000, 0.000, 0.000,
]

# Aufbau filling order: (n, l) tuples.
_AUFBAU = [
    (1, 0), (2, 0), (2, 1), (3, 0), (3, 1), (4, 0), (3, 2), (4, 1),
    (5, 0), (4, 2), (5, 1), (6, 0), (4, 3), (5, 2), (6, 1), (7, 0),
    (5, 3), (6, 2), (7, 1),
]

# Exceptions to Aufbau: Z -> {(n, l): occupancy override applied after filling}
# expressed as transfers from the outer s shell into d/f shells.
_CONFIG_EXCEPTIONS = {
    24: [((4, 0), (3, 2))],            # Cr: 3d5 4s1
    29: [((4, 0), (3, 2))],            # Cu: 3d10 4s1
    41: [((5, 0), (4, 2))],            # Nb: 4d4 5s1
    42: [((5, 0), (4, 2))],            # Mo: 4d5 5s1
    44: [((5, 0), (4, 2))],            # Ru: 4d7 5s1
    45: [((5, 0), (4, 2))],            # Rh: 4d8 5s1
    46: [((5, 0), (4, 2)), ((5, 0), (4, 2))],  # Pd: 4d10 5s0
    47: [((5, 0), (4, 2))],            # Ag: 4d10 5s1
    57: [((4, 3), (5, 2))],            # La: 5d1 4f0
    58: [((4, 3), (5, 2))],            # Ce: 4f1 5d1
    64: [((4, 3), (5, 2))],            # Gd: 4f7 5d1
    78: [((6, 0), (5, 2))],            # Pt: 5d9 6s1
    79: [((6, 0), (5, 2))],            # Au: 5d10 6s1
    89: [((5, 3), (6, 2))],            # Ac: 6d1 5f0
    90: [((5, 3), (6, 2)), ((5, 3), (6, 2))],  # Th: 6d2 5f0
    91: [((5, 3), (6, 2))],            # Pa: 5f2 6d1
    92: [((5, 3), (6, 2))],            # U : 5f3 6d1
    93: [((5, 3), (6, 2))],            # Np: 5f4 6d1
    96: [((5, 3), (6, 2))],            # Cm: 5f7 6d1
    103: [((6, 2), (7, 1))],           # Lr: 7p1
}


@functools.lru_cache(maxsize=None)
def electron_config(z: int) -> dict:
    """Return {(n, l): occupancy} ground-state electron configuration."""
    occ: dict = {}
    remaining = z
    for (n, l) in _AUFBAU:
        cap = 2 * (2 * l + 1)
        take = min(cap, remaining)
        if take > 0:
            occ[(n, l)] = take
        remaining -= take
        if remaining <= 0:
            break
    for (src, dst) in _CONFIG_EXCEPTIONS.get(z, []):
        if occ.get(src, 0) > 0:
            occ[src] = occ.get(src, 0) - 1
            occ[dst] = occ.get(dst, 0) + 1
            if occ[src] == 0:
                del occ[src]
    return occ


@functools.lru_cache(maxsize=None)
def valence_counts(z: int) -> tuple:
    """(ns, np, nd, nf) valence electron counts.

    ns/np: outermost shell s/p electrons; nd: (n-1)d; nf: (n-2)f --
    mirroring the semantics of jarvis-tools' nsvalence/npvalence/
    ndvalence/nfvalence used by the reference `alignn/graphs.py:655-667`.
    """
    occ = electron_config(z)
    if not occ:
        return (0, 0, 0, 0)
    nmax = max(n for (n, _l) in occ)
    ns = occ.get((nmax, 0), 0)
    npp = occ.get((nmax, 1), 0)
    nd = occ.get((nmax - 1, 2), 0)
    nf = occ.get((nmax - 2, 3), 0)
    return (ns, npp, nd, nf)


@functools.lru_cache(maxsize=None)
def period_group_block(z: int) -> tuple:
    """(period, group, block) for element Z, computed positionally.

    group: IUPAC 1-18; lanthanides/actinides assigned group 3.
    block: 0=s 1=p 2=d 3=f.
    """
    if z == 1:
        return (1, 1, 0)
    if z == 2:
        return (1, 18, 0)
    period_starts = [0, 1, 3, 11, 19, 37, 55, 87]  # Z of first element
    period = max(p for p, start in enumerate(period_starts) if z >= start)
    pos = z - period_starts[period] + 1  # 1-based position within period
    if period in (2, 3):
        if pos <= 2:
            return (period, pos, 0)
        return (period, pos + 10, 1)
    if period in (4, 5):
        if pos <= 2:
            return (period, pos, 0)
        if pos <= 12:
            return (period, pos, 2)
        return (period, pos, 1)
    # periods 6, 7: 14 f-block elements inserted after position 2
    if pos <= 2:
        return (period, pos, 0)
    if pos <= 16:  # La..Yb / Ac..No
        return (period, 3, 3)
    dpos = pos - 14  # collapse the f-block insert
    if dpos <= 12:  # Lu..Hg / Lr..
        return (period, dpos, 2)
    return (period, dpos, 1)


def _build_basic_table() -> np.ndarray:
    """Rows indexed by Z: [Z, group, period, X, rad, ns, np, nd, nf, IE, EA].

    Column order mirrors the reference's 'basic' feature list
    (`alignn/graphs.py:655-667`): Z, coulmn, row, X, atom_rad, nsvalence,
    npvalence, ndvalence, nfvalence, first_ion_en, elec_aff.
    """
    table = np.zeros((MAX_Z + 1, 11), dtype=np.float64)
    for z in range(1, MAX_Z + 1):
        period, group, _block = period_group_block(z)
        ns, npp, nd, nf = valence_counts(z)
        table[z] = [
            z, group, period, _X[z], _COV_RAD[z] * 100.0,
            ns, npp, nd, nf, _ION_EN[z], _ELEC_AFF[z],
        ]
    return table


BASIC_TABLE = _build_basic_table()

BLOCK_TABLE = np.zeros((MAX_Z + 1,), dtype=np.int64)
for _z in range(1, MAX_Z + 1):
    BLOCK_TABLE[_z] = period_group_block(_z)[2]


def atomic_number(symbol: str) -> int:
    """Atomic number for an element symbol."""
    return Z_FROM_SYMBOL[symbol]
