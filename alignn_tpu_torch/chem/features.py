"""Per-element node features (counterpart of ``alignn_tpu/chem/features.py``).

Four tables indexed by atomic number, built from this package's copy of
the periodic-table data: ``basic`` (11 raw properties), ``atomic_number``
(1), ``cgcnn`` (the 92-wide CGCNN one-hot binning) and ``cfid`` (438, the
JAX package's deterministic same-width substitute for jarvis's CFID
descriptors).  A ``<tables_dir>/<name>.json`` drop-in table
(``ALIGNN_TPU_TABLES_DIR``) wins over the built-in one.  Checkpoints
stamp the sha256 of the table they were trained against
(:func:`feature_table_provenance`); each built-in table is byte-equal to
the JAX package's.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os

import numpy as np

from alignn_tpu_torch.chem import periodic_table as pt

FEATURESET_SIZE = {"basic": 11, "atomic_number": 1, "cfid": 438, "cgcnn": 92}


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


def _cfid_row(z: int) -> np.ndarray:
    """Finer binnings of the same element properties plus their scaled
    raw values, zero-padded to 438."""
    period, group, block = pt.period_group_block(z)
    row = pt.BASIC_TABLE[z]
    x, rad, ion_en, elec_aff = row[3], row[4], row[9], row[10]
    ns, npp, nd, nf = row[5], row[6], row[7], row[8]
    feats = np.concatenate([
        _one_hot(z - 1, 103),
        _one_hot(group - 1, 18),
        _one_hot(period - 1, 7),
        _one_hot(block, 4),
        _bin_one_hot(x, 0.5, 4.0, 64),
        _bin_one_hot(rad, 25.0, 260.0, 64),
        _bin_one_hot(ion_en, 3.0, 25.0, 64),
        _bin_one_hot(elec_aff, -0.5, 3.7, 64),
        np.array([z / 100.0, x / 4.0, rad / 250.0, ion_en / 25.0,
                  elec_aff / 4.0, ns / 2.0, npp / 6.0, nd / 10.0, nf / 14.0,
                  group / 18.0]),
    ])
    return np.pad(feats, (0, 438 - feats.shape[0]))


def _builtin_row(z: int, atom_features: str) -> np.ndarray:
    if atom_features == "atomic_number":
        return np.array([float(z)])
    if atom_features == "basic":
        return np.asarray(pt.BASIC_TABLE[z], dtype=np.float64)
    if atom_features == "cgcnn":
        return _cgcnn_row(z)
    return _cfid_row(z)


def tables_dir() -> str:
    """Where drop-in tables are looked for: ``ALIGNN_TPU_TABLES_DIR`` (the
    JAX package's variable), else ``<package>/chem/tables``."""
    return os.environ.get(
        "ALIGNN_TPU_TABLES_DIR",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "tables"))


def _table_path(atom_features: str) -> str:
    return os.path.join(tables_dir(), f"{atom_features}.json")


def _override_table(atom_features: str):
    """The drop-in table (``{"Si": [...], ...}`` or ``{"14": [...]}``), or
    None.  A missing file is not cached; a loaded one is, by mtime."""
    path = _table_path(atom_features)
    if not os.path.exists(path):
        return None
    return _override_table_cached(atom_features, path, os.path.getmtime(path))


@functools.lru_cache(maxsize=None)
def _override_table_cached(atom_features: str, path: str, _mtime: float):
    with open(path) as f:
        data = json.load(f)
    size = FEATURESET_SIZE[atom_features]
    table = np.zeros((pt.MAX_Z + 1, size), dtype=np.float32)
    for key, vec in data.items():
        z = int(key) if key.isdigit() else pt.Z_FROM_SYMBOL.get(key, 0)
        if 1 <= z <= pt.MAX_Z:
            table[z] = np.asarray(vec, dtype=np.float32)[:size]
    table.setflags(write=False)
    return table


@functools.lru_cache(maxsize=None)
def _builtin_table(atom_features: str) -> np.ndarray:
    table = np.zeros((pt.MAX_Z + 1, FEATURESET_SIZE[atom_features]),
                     dtype=np.float32)
    for z in range(1, pt.MAX_Z + 1):
        table[z] = _builtin_row(z, atom_features)
    table.setflags(write=False)
    return table


def attribute_lookup_table(atom_features: str = "cgcnn") -> np.ndarray:
    """[MAX_Z+1, F] read-only lookup table indexed by atomic number."""
    if atom_features not in FEATURESET_SIZE:
        raise ValueError(f"unknown atom_features: {atom_features!r}")
    override = _override_table(atom_features)
    return override if override is not None else _builtin_table(atom_features)


def get_node_attributes(symbol: str, atom_features: str = "cgcnn") -> list:
    """One element's feature vector (jarvis's ``get_node_attributes``), in
    f64 from the built-in rows, or the drop-in table's row."""
    table = attribute_lookup_table(atom_features)   # raises on a bad name
    z = pt.atomic_number(symbol)
    if _override_table(atom_features) is not None:
        return table[z].tolist()
    return _builtin_row(z, atom_features).tolist()


def feature_table_provenance(atom_features: str = "cgcnn") -> dict:
    """{atom_features, source, sha256-of-table-bytes} for checkpoint stamps."""
    override = _override_table(atom_features)
    table = attribute_lookup_table(atom_features)
    return {
        "atom_features": atom_features,
        "source": ("override:" + os.path.basename(_table_path(atom_features))
                   if override is not None else "builtin"),
        "sha256": hashlib.sha256(
            np.ascontiguousarray(table).tobytes()).hexdigest(),
    }
