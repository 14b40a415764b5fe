"""Per-element node features (counterpart of ``alignn_tpu/chem/features.py``).

The cgcnn 92-wide one-hot table, built from this package's copy of the
periodic-table data.  Checkpoints stamp the sha256 of the table they were
trained against (:func:`feature_table_provenance`); the port's table is
byte-equal to the JAX package's built-in one.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np

from alignn_tpu_torch.chem import periodic_table as pt

FEATURESET_SIZE = {"cgcnn": 92}


def _one_hot(index: int, size: int) -> np.ndarray:
    v = np.zeros(size, dtype=np.float64)
    if 0 <= index < size:
        v[index] = 1.0
    return v


def _bin_one_hot(value: float, lo: float, hi: float, bins: int) -> np.ndarray:
    """One-hot of which of `bins` equal-width [lo, hi] bins `value` falls in."""
    idx = int(np.floor((value - lo) / (hi - lo) * bins))
    return _one_hot(min(max(idx, 0), bins - 1), bins)


def _cgcnn_row(z: int) -> np.ndarray:
    period, group, block = pt.period_group_block(z)
    row = pt.BASIC_TABLE[z]
    x = row[3]           # electronegativity
    rad = row[4]         # covalent radius, pm
    valence = int(row[5]) + int(row[6]) + int(row[7]) + int(row[8])
    ion_en = row[9]
    elec_aff = row[10]
    # atomic volume proxy from covalent radius (Angstrom^3)
    vol = 4.0 / 3.0 * np.pi * (rad / 100.0) ** 3
    return np.concatenate([
        _one_hot(group - 1, 18),
        _one_hot(period - 1, 7),
        _bin_one_hot(x, 0.5, 4.0, 10),
        _bin_one_hot(rad, 25.0, 250.0, 10),
        _one_hot(min(valence, 12) - 1, 12),
        _bin_one_hot(ion_en, 3.0, 25.0, 10),
        _bin_one_hot(elec_aff, -0.5, 3.7, 10),
        _one_hot(block, 4),
        _bin_one_hot(np.log10(max(vol, 1e-3)), -0.5, 2.0, 11),
    ])


@functools.lru_cache(maxsize=None)
def _cgcnn_table() -> np.ndarray:
    table = np.zeros((pt.MAX_Z + 1, FEATURESET_SIZE["cgcnn"]),
                     dtype=np.float32)
    for z in range(1, pt.MAX_Z + 1):
        table[z] = _cgcnn_row(z)
    table.setflags(write=False)
    return table


def attribute_lookup_table(atom_features: str = "cgcnn") -> np.ndarray:
    """[MAX_Z+1, F] read-only lookup table indexed by atomic number."""
    if atom_features not in FEATURESET_SIZE:
        raise ValueError(f"unsupported atom_features: {atom_features!r} "
                         f"(the port has {sorted(FEATURESET_SIZE)})")
    return _cgcnn_table()


def feature_table_provenance(atom_features: str = "cgcnn") -> dict:
    """{atom_features, source, sha256-of-table-bytes} for checkpoint stamps."""
    table = attribute_lookup_table(atom_features)
    return {
        "atom_features": atom_features,
        "source": "builtin",
        "sha256": hashlib.sha256(
            np.ascontiguousarray(table).tobytes()).hexdigest(),
    }
