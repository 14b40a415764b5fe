"""Crystal structure container (counterpart of ``alignn_tpu/chem/atoms.py``).

The subset the force-field path needs: lattice math, fractional and
cartesian coordinates, atomic numbers and supercells.  File I/O comes in a
later slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from alignn_tpu_torch.chem.periodic_table import atomic_number


@dataclass(frozen=True)
class Lattice:
    """3x3 row-vector lattice."""

    matrix: np.ndarray

    def __post_init__(self):
        object.__setattr__(
            self, "matrix",
            np.asarray(self.matrix, dtype=np.float64).reshape(3, 3))

    @property
    def a(self) -> float:
        return float(np.linalg.norm(self.matrix[0]))

    @property
    def b(self) -> float:
        return float(np.linalg.norm(self.matrix[1]))

    @property
    def c(self) -> float:
        return float(np.linalg.norm(self.matrix[2]))

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self.matrix)))

    def cart_coords(self, frac: np.ndarray) -> np.ndarray:
        return np.asarray(frac, dtype=np.float64) @ self.matrix


@dataclass
class Atoms:
    """A periodic atomic structure."""

    lattice_mat: np.ndarray
    frac_coords: np.ndarray
    elements: list

    def __post_init__(self):
        self.lattice_mat = np.asarray(
            self.lattice_mat, dtype=np.float64).reshape(3, 3)
        self.frac_coords = np.asarray(
            self.frac_coords, dtype=np.float64).reshape(-1, 3)
        self.elements = list(self.elements)

    @classmethod
    def from_dict(cls, d: dict) -> "Atoms":
        """From a jarvis-schema dict (``lattice_mat``, ``coords``,
        ``elements``, ``cartesian``): the records of a dataset."""
        lattice = np.asarray(d["lattice_mat"], dtype=np.float64).reshape(3, 3)
        coords = np.asarray(d["coords"], dtype=np.float64).reshape(-1, 3)
        if d.get("cartesian", False):
            coords = coords @ np.linalg.inv(lattice)
        return cls(lattice_mat=lattice, frac_coords=coords,
                   elements=d["elements"])

    @property
    def lattice(self) -> Lattice:
        return Lattice(self.lattice_mat)

    @property
    def cart_coords(self) -> np.ndarray:
        return self.frac_coords @ self.lattice_mat

    @property
    def num_atoms(self) -> int:
        return len(self.elements)

    @property
    def atomic_numbers(self) -> np.ndarray:
        return np.array([atomic_number(e) for e in self.elements],
                        dtype=np.int32)

    @property
    def volume(self) -> float:
        return self.lattice.volume

    def make_supercell(self, dims) -> "Atoms":
        dims = np.asarray(dims, dtype=np.int64).reshape(3)
        images = np.stack(np.meshgrid(
            np.arange(dims[0]), np.arange(dims[1]), np.arange(dims[2]),
            indexing="ij"), axis=-1).reshape(-1, 3)
        frac = np.concatenate([(self.frac_coords + img) / dims
                               for img in images], axis=0)
        return Atoms(lattice_mat=self.lattice_mat * dims[:, None],
                     frac_coords=frac,
                     elements=list(self.elements) * len(images))
